"""The port's deterministic pieces against the JAX package: sampling
arithmetic, the removal threshold, the paper's constants, the data
generators and the ragged gather. These are held to exact equality or to
float32 summation-order tolerance; only the random draws themselves differ
between the two packages (threefry vs Philox), and those are held to
their properties instead.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import soccer_paper as jcfg
from repro.core import comm as jcomm
from repro.core import sampling as jsamp
from repro.core import soccer as jsoc
from repro.core import truncated_cost as jtc
from repro.data import sharding as jshard
from repro.data import synthetic as jsyn
from repro_torch.configs import soccer_paper as tcfg
from repro_torch.core import comm as tcomm
from repro_torch.core import sampling as tsamp
from repro_torch.core import soccer as tsoc
from repro_torch.core import truncated_cost as ttc
from repro_torch.data import sharding as tshard
from repro_torch.data import synthetic as tsyn

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)


COUNT_CASES = [
    ([5, 5, 5, 5], 7), ([0, 0, 0], 4), ([10, 0, 3], 100), ([1, 2, 3], 6),
    ([1_250_000] * 8, 17353), ([1_250_000] * 8, 80585),
    ([2000, 900, 300, 80], 3280), ([7, 13, 1, 0, 29, 3, 3, 11], 19),
]


@pytest.mark.parametrize("counts,total", COUNT_CASES)
def test_apportion_exact(counts, total):
    c = np.asarray(counts, np.int32)
    want = np.asarray(jsamp.apportion(jnp.asarray(c), total))
    got = tsamp.apportion(torch.from_numpy(c), total)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() <= c).all()


def test_apportion_exact_random():
    rng = np.random.default_rng(0)
    japportion = jax.jit(jsamp.apportion)      # one compile per m
    for _ in range(200):
        m = int(rng.choice([1, 3, 8, 16]))
        c = rng.integers(0, 5000, m).astype(np.int32)
        total = int(rng.integers(0, 2 * c.sum() + 2))
        np.testing.assert_array_equal(
            tsamp.apportion(torch.from_numpy(c), total).numpy(),
            np.asarray(japportion(jnp.asarray(c), total)))


def test_exclusive_cumsum():
    c = np.asarray([3, 0, 5, 2], np.int32)
    np.testing.assert_array_equal(
        tsamp.exclusive_cumsum(torch.from_numpy(c)).numpy(),
        np.asarray(jsamp.exclusive_cumsum(jnp.asarray(c))))


def test_sample_local_draws_live_points_without_replacement():
    g = torch.Generator().manual_seed(0)
    alive = torch.from_numpy(np.random.default_rng(1).random((3, 50)) > 0.4)
    c = torch.tensor([5, 0, 12], dtype=torch.int32)
    idx, take = tsamp.sample_local(g, alive, c, cap=20)
    assert idx.shape == take.shape == (3, 20)
    for j in range(3):
        drawn = idx[j][take[j]].tolist()
        assert len(drawn) == int(c[j]) == len(set(drawn))
        assert all(bool(alive[j, i]) for i in drawn)
    # cap > p: the degenerate tiny-machine case pads the index buffer
    idx, take = tsamp.sample_local(g, alive[:, :4], torch.tensor(
        [1, 1, 1], dtype=torch.int32), cap=6)
    assert idx.shape == (3, 6)


def test_draw_global_sample_ht_weights():
    """Exact-size draw; HT weights n_j/max(c_j, 1) make the sample's mass
    the live population's."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 300, 3)).astype(np.float32))
    w = torch.ones((4, 300))
    alive = torch.from_numpy(rng.random((4, 300)) > 0.3)
    alive[3] = False                                # a dead machine
    comm = tcomm.VirtualCluster(4)
    n_vec = alive.sum(1, dtype=torch.int32)
    pts, wts, real = tsamp.draw_global_sample(
        comm, torch.Generator().manual_seed(3), x, w, alive, n_vec, 200, 200)
    assert pts.shape == (200, 3) and wts.shape == (200,)
    assert int(real) == 200
    np.testing.assert_allclose(float(wts.sum()), float(n_vec.sum()),
                               rtol=1e-5)
    # every drawn row is a live point of its machine
    flat = x[alive]
    d = (pts[:, None, :] - flat[None, :, :]).abs().sum(-1).min(1).values
    assert float(d.max()) == 0.0


def test_gather_ragged_matches_reference():
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(3, 6, 2)).astype(np.float32)
    counts = np.asarray([2, 0, 5], np.int32)
    want = jcomm.VirtualCluster(3).gather_ragged(
        jnp.asarray(vals), jnp.asarray(counts), 9)
    got = tcomm.VirtualCluster(3).gather_ragged(
        torch.from_numpy(vals), torch.from_numpy(counts), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # over budget: truncated, with a warning (CPU counts warn at once)
    with pytest.warns(UserWarning, match="truncated"):
        got = tcomm.VirtualCluster(3).gather_ragged(
            torch.from_numpy(vals), torch.from_numpy(counts), 4)
    with pytest.warns(UserWarning, match="truncated"):
        want = jcomm.VirtualCluster(3).gather_ragged(
            jnp.asarray(vals), jnp.asarray(counts), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["unique", "duplicates"])
def test_scatter_at_matches_reference(case):
    """k-means‖'s rank-positioned upload: the same buffer as the
    reference's, and the dense per-machine buffer recorded as wire."""
    rng = np.random.default_rng(17)
    m, q, d, rows = 3, 6, 4, 12
    if case == "unique":
        vals = rng.normal(size=(m, q, d)).astype(np.float32)
        pos = rng.permutation(np.arange(-2, 16))[: m * q].reshape(m, q)
    else:   # several rows on one slot: small integers add exactly
        vals = rng.integers(-4, 5, size=(m, q, d)).astype(np.float32)
        pos = rng.integers(0, rows + 3, size=(m, q))
    pos = pos.astype(np.int32)
    take = rng.random((m, q)) > 0.3
    with jcomm.wire_tally() as tj:
        want = jsamp.scatter_at(jcomm.VirtualCluster(m), jnp.asarray(vals),
                                jnp.asarray(np.maximum(pos, 0)),
                                jnp.asarray(take & (pos >= 0)), rows)
    with tcomm.wire_tally() as tt:
        got = tsamp.scatter_at(tcomm.VirtualCluster(m), torch.from_numpy(vals),
                               torch.from_numpy(pos), torch.from_numpy(take),
                               rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tt.payload, tt.meta) == (tj.payload, tj.meta) == (
        m * rows * d * 4, 0)


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_weighted_quantile_matches_reference(q):
    """EIM11's threshold: exact against the reference, ties in d2 and
    zero weights included (weights are small integers, so the running
    sums are exact in either framework)."""
    from repro.core.eim11 import _weighted_quantile
    from repro_torch.core.eim11 import weighted_quantile
    rng = np.random.default_rng(18)
    d2 = rng.exponential(size=500).astype(np.float32)
    d2[::9] = d2[3]
    w = rng.integers(0, 4, size=500).astype(np.float32)
    want = _weighted_quantile(jnp.asarray(d2), jnp.asarray(w), q)
    got = weighted_quantile(torch.from_numpy(d2), torch.from_numpy(w), q)
    assert float(got) == float(want)


def test_global_weighted_choice_statistics():
    """Two-stage draw ∝ weight: machine by mass, then point by weight.
    Zero weights are never chosen, the frequencies follow the weights
    within 5 standard errors, and the picked point is replicated."""
    m, p, draws = 3, 8, 3000
    rng = np.random.default_rng(19)
    w = rng.random((m, p)).astype(np.float32)
    w[rng.random((m, p)) < 0.3] = 0.0
    w[2] = 0.0                                       # an empty machine
    ids = np.arange(m * p, dtype=np.float32).reshape(m, p)
    x = torch.from_numpy(np.stack([ids, -ids], axis=-1))   # (m, p, 2)
    comm, gen = tcomm.VirtualCluster(m), torch.Generator().manual_seed(20)
    wt = torch.from_numpy(w)
    with tcomm.wire_tally() as t:
        tsamp.global_weighted_choice(gen, comm, wt, x)
    assert t.meta == 4 * m + 4 * m * 2 and t.payload == 0
    counts = np.zeros(m * p)
    for _ in range(draws):
        pt = tsamp.global_weighted_choice(gen, comm, wt, x)
        assert float(pt[1]) == -float(pt[0])
        counts[int(pt[0])] += 1
    prob = w.reshape(-1) / w.sum()
    assert counts[prob == 0].sum() == 0, "picked a zero-weight point"
    se = np.sqrt(draws * prob * (1 - prob))
    assert np.all(np.abs(counts - draws * prob) <= 5 * se + 1)


def test_quantize_uplink_runs_float32_only():
    x = torch.rand(3, 4)
    assert tsamp.quantize_uplink(x, "float32") is x
    for dt in ("bfloat16", "float16", "int8"):
        with pytest.raises(NotImplementedError, match="item 11"):
            tsamp.quantize_uplink(x, dt)


def test_wire_tally_records_every_executed_call():
    """Eager accounting: each call records, so two calls record twice
    (the JAX package records once per trace)."""
    comm = tcomm.VirtualCluster(4)
    vals = torch.zeros((4, 5, 3))
    counts = torch.tensor([1, 2, 0, 3], dtype=torch.int32)
    with tcomm.wire_tally() as t:
        comm.gather_ragged(vals, counts, 8)
        comm.gather_ragged(vals[..., 0], counts, 8, meta=True)
        comm.psum(torch.zeros(4, dtype=torch.int32))
        comm.all_machines(torch.zeros(4, dtype=torch.int32))
    assert t.row_bytes == 12 and t.row_meta_bytes == 4
    assert t.meta == 2 * 4 * 4 + 2 * 16
    assert int(t.bytes_at(6)) == 72 and int(t.meta_bytes_at(6)) == 64 + 24
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t.warn_overflow()                             # within budget
    with tcomm.wire_tally() as t2:
        comm.gather_ragged(vals, counts, 3)
    with pytest.warns(UserWarning, match="truncated"):
        t2.warn_overflow()


# ---- truncated cost and the removal threshold -----------------------------

def _d2w(n=400, seed=5, ties=False):
    rng = np.random.default_rng(seed)
    d2 = rng.exponential(size=n).astype(np.float32)
    if ties:
        d2[::7] = d2[0]
    w = rng.random(n).astype(np.float32) * 3.0
    w[: n // 10] = 0.0
    return d2, w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mass", [0.0, 17.3, 250.0, 1e6])
def test_truncated_costs_match_reference(ties, mass):
    d2, w = _d2w(ties=ties)
    jd, jw, td, tw = (jnp.asarray(d2), jnp.asarray(w), torch.from_numpy(d2),
                      torch.from_numpy(w))
    np.testing.assert_allclose(
        float(ttc.weighted_truncated_cost(td, tw, mass)),
        float(jtc.weighted_truncated_cost(jd, jw, mass)), rtol=1e-5)
    np.testing.assert_allclose(
        float(ttc.weighted_top_mass(td, tw, mass)),
        float(jtc.weighted_top_mass(jd, jw, mass)), rtol=1e-5)
    # kept = cumsum - mass cancels: a few ulps of the total weight
    np.testing.assert_allclose(ttc.trim_top_mass(td, tw, mass).numpy(),
                               np.asarray(jtc.trim_top_mass(jd, jw, mass)),
                               rtol=1e-5, atol=1e-6 * float(w.sum()))


@pytest.mark.parametrize("k,d_k,alpha", [(8, 44.07, 0.32), (25, 55.98, 1e-3),
                                         (100, 64.99, 8.06e-3)])
def test_removal_threshold_matches_reference(k, d_k, alpha):
    d2, w = _d2w(n=2000, seed=k)
    w = w / np.float32(alpha)
    v_j = jtc.removal_threshold(jnp.asarray(d2), jnp.asarray(w), k, d_k,
                                jnp.float32(alpha))
    v_t = ttc.removal_threshold(torch.from_numpy(d2), torch.from_numpy(w), k,
                                d_k, torch.tensor(alpha, dtype=torch.float32))
    assert v_t.dtype == torch.float32
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-5)


# ---- constants and the host loop's rule -----------------------------------

@pytest.mark.parametrize("n,p,k,eps,eta_o", [
    (16_000, 2000, 8, 0.1, 0), (16_000, 2000, 8, 0.05, 900),
    (10_000_000, 1_250_000, 25, 0.05, 0), (10_000_000, 1_250_000, 100, 0.05, 0),
    (50, 7, 3, 0.5, 0)])
def test_derive_constants_match_reference(n, p, k, eps, eta_o):
    jc = jsoc.derive_constants(n, p, jcfg.SoccerParams(k=k, epsilon=eps),
                               eta_override=eta_o)
    tc = tsoc.derive_constants(n, p, tcfg.SoccerParams(k=k, epsilon=eps),
                               eta_override=eta_o)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name


def test_table2_constants():
    """The slice's sizes: paper Table 2 rows 1-2 at n = 10 M, m = 8."""
    got = [tsoc.derive_constants(10_000_000, 1_250_000, sp)
           for _, sp in tcfg.PAPER_TABLE2]
    assert [(c.k_plus, c.eta) for c in got] == [(103, 17353), (190, 80585)]
    assert got[0].d_k == pytest.approx(55.98, abs=0.01)


@pytest.mark.parametrize("rem,cap,prev", [(10, 5, np.inf), (10, 5, 10),
                                          (5, 5, 9), (6, 5, 7), (0, 0, 1)])
def test_stopping_rule_matches_reference(rem, cap, prev):
    assert tsoc.stopping_rule(rem, cap, prev) == jsoc.stopping_rule(
        rem, cap, prev)


def test_effective_n_matches_reference():
    rng = np.random.default_rng(6)
    w = rng.random((3, 10)).astype(np.float32) * 2
    alive = rng.random((3, 10)) > 0.5
    for ww, aa in ((None, None), (w, None), (None, alive), (w, alive)):
        assert tsoc.effective_n(3, 10, ww, aa) == jsoc.effective_n(
            3, 10, ww, aa)


# ---- configs and data ----------------------------------------------------

def test_soccer_params_mirror_reference():
    assert ([f.name for f in dataclasses.fields(tcfg.SoccerParams)]
            == [f.name for f in dataclasses.fields(jcfg.SoccerParams)])
    assert tcfg.PAPER_TABLE2 == tuple(
        (tcfg.GaussianMixtureSpec(**dataclasses.asdict(s)),
         tcfg.SoccerParams(**dataclasses.asdict(p)))
        for s, p in jcfg.PAPER_TABLE2)
    for bad in (dict(k=0), dict(k=3, epsilon=1.0), dict(k=3, delta=0.0),
                dict(k=3, blackbox="minbatch"), dict(k=3, n_machines=0),
                dict(k=3, outlier_frac=1.0)):
        with pytest.raises(ValueError):
            jcfg.SoccerParams(**bad)
        with pytest.raises(ValueError):
            tcfg.SoccerParams(**bad)


def test_generators_bit_identical():
    spec = dict(n=5000, dim=15, k=7, sigma=0.001, seed=4)
    jx, jl, jm = jsyn.gaussian_mixture(jcfg.GaussianMixtureSpec(**spec))
    tx, tl, tm = tsyn.gaussian_mixture(tcfg.GaussianMixtureSpec(**spec))
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tsyn.shard_points(tx, 8),
                                  jsyn.shard_points(jx, 8))
    with pytest.warns(UserWarning):
        tp, tw = tsyn.shard_points(tx[:4999], 8, return_weights=True)
    with pytest.warns(UserWarning):
        jp, jw = jsyn.shard_points(jx[:4999], 8, return_weights=True)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("policy", ["shuffle", "contiguous", "sorted",
                                    "imbalanced"])
def test_make_shards_bit_identical(policy):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1001, 5)).astype(np.float32)
    w = rng.random(1001).astype(np.float32)
    for ww in (None, w):
        got = tshard.make_shards(x, ww, 8, policy=policy, seed=3)
        want = jshard.make_shards(x, ww, 8, policy=policy, seed=3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
