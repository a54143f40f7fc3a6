"""The port's centralized black box A against the JAX package and the
claims of tests/test_kmeans.py. Lloyd is deterministic and is held to the
reference from a shared init; k-means++ draws from torch's generator, so
it is held to its properties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro_torch.core import kmeans as tkm
from repro_torch.core.metrics import centralized_cost
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)



def _blobs(n=600, k=6, d=5, sigma=0.02, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(size=(k, d)).astype(np.float32)
    lbl = rng.integers(0, k, n)
    x = (means[lbl] + sigma * rng.normal(size=(n, d))).astype(np.float32)
    return x, means


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_matches_reference_from_shared_init(weighted):
    x, _ = _blobs(seed=1)
    rng = np.random.default_rng(2)
    w = (rng.random(600).astype(np.float32) * 2 if weighted
         else np.ones(600, np.float32))
    w[:50] = 0.0
    init = x[rng.choice(600, 6, replace=False)]
    c_j, cost_j = jkm.lloyd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(init),
                            iters=10)
    c_t, cost_t = tkm.lloyd(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(init), iters=10)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-4)


def test_lloyd_monotone():
    x, _ = _blobs()
    xt, w = torch.from_numpy(x), torch.ones(600)
    c = tkm.kmeans_plusplus(_gen(0), xt, w, 6)
    costs = []
    for _ in range(6):
        c, cost = tkm.lloyd(xt, w, c, iters=1)
        costs.append(float(cost))
    assert all(costs[i + 1] <= costs[i] + 1e-5 for i in range(len(costs) - 1))


def test_empty_cluster_keeps_its_center():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]])
    init = torch.tensor([[0.0, 0.0], [100.0, 100.0], [5.0, 5.0]])
    c, _ = tkm.lloyd(x, torch.ones(3), init, iters=3)
    assert c[1].tolist() == [100.0, 100.0]
    np.testing.assert_allclose(c[0].numpy(), [0.05, 0.0], atol=1e-6)


def test_weighted_equals_duplicated():
    """lloyd on (x, w=2) == lloyd on x duplicated, from a shared init."""
    x, _ = _blobs(n=200, seed=5)
    xt = torch.from_numpy(x)
    init = tkm.kmeans_plusplus(_gen(2), xt, torch.ones(200), 4)
    c_w, cost_w = tkm.lloyd(xt, torch.full((200,), 2.0), init, iters=10)
    c_d, cost_d = tkm.lloyd(torch.cat([xt, xt]), torch.ones(400), init,
                            iters=10)
    np.testing.assert_allclose(c_w.numpy(), c_d.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(cost_w), float(cost_d), rtol=1e-5)


def test_zero_weight_points_ignored():
    x, _ = _blobs(n=300, seed=7)
    x[150:] = 1e3                              # garbage in the zero region
    w = torch.ones(300)
    w[150:] = 0.0
    c, cost = tkm.kmeans(_gen(0), torch.from_numpy(x), w, 4)
    assert bool((c.abs() < 100.0).all())       # never seeded on garbage
    assert float(cost) < 50.0


def test_kmeans_plusplus_seeds_on_data_rows():
    x, _ = _blobs(n=500, d=6, seed=15)
    xt, w = torch.from_numpy(x), torch.ones(500)
    c1 = tkm.kmeans_plusplus(_gen(0), xt, w, 5)
    d = (c1[:, None, :] - xt[None]).abs().sum(-1).min(1).values
    assert float(d.max()) == 0.0               # each center is a data row
    assert torch.equal(c1, tkm.kmeans_plusplus(_gen(0), xt, w, 5))


def test_kmeans_plusplus_makes_k_minus_1_update_calls(monkeypatch):
    """One D² update per new center after the first: the plain seeding
    makes k steps, the first with no center (a draw on the weights alone)
    and k - 1 that lower d2 against the row drawn last."""
    calls = []
    real = tref.kmeans_pp_step_ref

    def spy(x, w, d2, prev, g):
        calls.append(None if prev is None else tuple(prev.shape))
        return real(x, w, d2, prev, g)

    monkeypatch.setattr(tref, "kmeans_pp_step_ref", spy)
    x, _ = _blobs(n=100, seed=3)
    tkm.kmeans_plusplus(_gen(0), torch.from_numpy(x), torch.ones(100), 7)
    assert calls == [None] + [()] * 6


def test_kmeans_plusplus_uniform_fallback_at_zero_mass():
    """Every point on a center: the D² mass is 0 and the draw falls back
    to the weights instead of producing NaN."""
    x = torch.ones((5, 3))
    c = tkm.kmeans_plusplus(_gen(0), x, torch.ones(5), 3)
    assert torch.equal(c, torch.ones((3, 3)))


# ---- the seeding's random bits and draw ---------------------------------

_M32 = 0xFFFFFFFF


def _philox_py(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11; Random123)."""
    x, (k0, k1) = list(ctr), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        p0, p1 = 0xD2511F53 * x[0], 0xCD9E8D57 * x[2]
        x = [(p1 >> 32) ^ x[1] ^ k0, p1 & _M32, (p0 >> 32) ^ x[3] ^ k1,
             p0 & _M32]
    return x


def test_philox_matches_python_ints_and_known_answer():
    """The torch Philox4x32-10 (int64 words) against the same rounds on
    Python ints at random counters and keys, and both against Random123's
    first known-answer vector (counter 0, key 0)."""
    assert _philox_py([0, 0, 0, 0], (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    got = tref.philox4x32_10(0, 0, 0, 0, 0, 0)
    assert [int(v) for v in got] == _philox_py([0, 0, 0, 0], (0, 0))
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 1 << 32, size=(4, 64), dtype=np.int64)
    key = rng.integers(0, 1 << 32, size=2, dtype=np.int64)
    got = tref.philox4x32_10(*[torch.from_numpy(c) for c in ctr],
                             int(key[0]), int(key[1]))
    want = [_philox_py([int(c) for c in ctr[:, j]], (int(key[0]),
                                                     int(key[1])))
            for j in range(64)]
    for word in range(4):
        assert got[word].tolist() == [w[word] for w in want]


def test_seeding_step_matches_numpy_gumbel():
    """One plain step draws argmax(log p - log(-log u)) over p = w·d2,
    with u from the Philox bits at counter (point, step): the same u and
    the same draw as numpy on Python-int Philox words."""
    rng = np.random.default_rng(1)
    n, step, seed = 300, 3, (1234567, 89101112)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[::7] = 0.0
    d2 = (rng.random(n) * 2).astype(np.float32)
    prev = 11
    r = np.array([_philox_py([i, step, 0, 0], seed)[0] for i in range(n)],
                 np.int64)
    u = ((r >> 9) * 2 + 1).astype(np.float64) * 2.0 ** -24
    g = tref.seed_gumbel(torch.tensor(seed), n, range(step, step + 1))[0]
    # float32 logs against float64: a few float32 ulps of max(1, |g|)
    np.testing.assert_allclose(g.numpy(), -np.log(-np.log(u)), rtol=1e-6,
                               atol=1e-6)
    d2_t, key_d2, key_w = tref.kmeans_pp_step_ref(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(d2),
        torch.tensor(prev), g)
    p = w.astype(np.float64) * d2_t.numpy()
    with np.errstate(divide="ignore"):
        want = np.argmax(np.log(p) - np.log(-np.log(u)))
    assert int(tref.draw_winner(key_d2, key_w)) == want
    assert p[want] > 0


def test_zero_weight_rows_never_drawn():
    """A row of weight 0 is never drawn while any weight is positive, in
    the first draw (on w) or a D² draw, over many seeds."""
    x, _ = _blobs(n=60, seed=21)
    w = torch.ones(60)
    w[::2] = 0.0
    for s in range(40):
        idx = ops.kmeans_plusplus_indices(torch.from_numpy(x), w, 6,
                                          torch.tensor([s, 99]))
        assert bool((w[idx] > 0).all()), (s, idx.tolist())


def test_seeding_draws_follow_p():
    """20,000 draws over 16 points (one seed, 20,000 steps' bits) land in
    proportion to p = w·d2: a chi-square test at p-value >= 1e-3; a point
    with p = 0 is never drawn."""
    from scipy import stats
    rng = np.random.default_rng(2)
    p = rng.random(16).astype(np.float32)
    p[3] = 0.0
    p[7] *= 10.0
    g = tref.seed_gumbel(torch.tensor([31, 4159]), 16, range(20_000))
    keys = tref.gumbel_keys(torch.from_numpy(p)[None, :], g)
    cnt = np.bincount(torch.argmax(keys, dim=1).numpy(), minlength=16)
    assert cnt[3] == 0
    live = p > 0
    exp = p[live].astype(np.float64)
    exp *= cnt[live].sum() / exp.sum()
    assert stats.chisquare(cnt[live], exp).pvalue >= 1e-3


def test_kmeans_plusplus_indices_repeat_by_seed():
    """The same seed draws the same rows; another seed other rows."""
    x, _ = _blobs(n=400, seed=8)
    xt, w = torch.from_numpy(x), torch.ones(400)
    a = ops.kmeans_plusplus_indices(xt, w, 12, torch.tensor([1, 2]))
    assert torch.equal(a, ops.kmeans_plusplus_indices(
        xt, w, 12, torch.tensor([1, 2])))
    assert not torch.equal(a, ops.kmeans_plusplus_indices(
        xt, w, 12, torch.tensor([1, 3])))
    assert a.dtype == torch.int64 and a.shape == (12,)


def test_kmeans_cost_close_to_reference():
    """Different random streams: the same data and k reach a cost within
    a factor of the reference's (both find the blobs)."""
    x, means = _blobs(seed=3)
    w = np.ones(600, np.float32)
    _, cost_j = jkm.kmeans(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(w), 6)
    _, cost_t = tkm.kmeans(_gen(1), torch.from_numpy(x), torch.from_numpy(w),
                           6)
    opt = float(centralized_cost(torch.from_numpy(x), torch.from_numpy(means)))
    assert float(cost_t) <= 1.5 * max(float(cost_j), opt)


def test_more_centers_never_worse():
    x, _ = _blobs(seed=11)
    xt, w = torch.from_numpy(x), torch.ones(600)
    _, c4 = tkm.kmeans(_gen(4), xt, w, 4)
    _, c12 = tkm.kmeans(_gen(4), xt, w, 12)
    assert float(c12) <= float(c4) * 1.05
