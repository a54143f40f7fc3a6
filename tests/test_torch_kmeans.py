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
    """One fused seeding sweep per new center: k - 1 in all."""
    calls = []
    real = ops.update_min_dist

    def spy(*args):
        calls.append(args[2].shape)
        return real(*args)

    monkeypatch.setattr(ops, "update_min_dist", spy)
    x, _ = _blobs(n=100, seed=3)
    tkm.kmeans_plusplus(_gen(0), torch.from_numpy(x), torch.ones(100), 7)
    assert calls == [(1, 5)] * 6


def test_kmeans_plusplus_uniform_fallback_at_zero_mass():
    """Every point on a center: the D² mass is 0 and the draw falls back
    to the weights instead of producing NaN."""
    x = torch.ones((5, 3))
    c = tkm.kmeans_plusplus(_gen(0), x, torch.ones(5), 3)
    assert torch.equal(c, torch.ones((3, 3)))


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
