"""The sharded coordinator in the port (``core.sharded_kmeans``), on the
CPU, against the JAX package: ``derive_constants`` with ``cap_sharded``
(exact), ``distributed_lloyd`` from a shared init and
``distributed_threshold`` in both modes on the same buffers (2e-3
relative in float32), the D² seeding by distribution, the per-round wire
bytes against their closed form, and sharded SOCCER held to the
reference's outcomes and to tests/test_system.py:128's claim.

The port counts every executed collective; the reference records a
scanned or looped one once a trace. ``test_sharded_round_bytes`` holds
the difference to its closed form (ROADMAP Queue 3).
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import soccer_paper as jcfg
from repro.core import sharded_kmeans as jsk
from repro.core import soccer as jsoc
from repro.core.comm import VirtualCluster as JCluster
from repro_torch.configs.soccer_paper import GaussianMixtureSpec, SoccerParams
from repro_torch.core import sharded_kmeans as tsk
from repro_torch.core import soccer as tsoc
from repro_torch.core.comm import VirtualCluster
from repro_torch.core.metrics import centralized_cost
from repro_torch.core.sampling import apportion
from repro_torch.data.synthetic import gaussian_mixture, shard_points

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

K, M = 8, 8
RTOL = 2e-3


def _cost(x, centers) -> float:
    return float(centralized_cost(torch.from_numpy(np.asarray(x)),
                                  torch.from_numpy(np.asarray(centers))))


@pytest.mark.parametrize("n,p,k,eps,m,eta_o,extra", [
    (16_000, 2_000, 8, 0.1, 8, 0, {}),
    (10_000_000, 1_250_000, 25, 0.05, 8, 0, {}),
    (10_000_000, 1_250_000, 1000, 0.05, 8, 0, {}),
    (6_000, 750, 5, 0.2, 8, 400, dict(sharded_threshold="topk",
                                      sharded_seeding="kmeanspar")),
    (512, 8, 3, 0.2, 64, 0, dict(blackbox="minibatch",
                                 minibatch_size=256)),
    (40_000, 10_000, 4, 0.3, 4, 0, dict(straggler_rate=0.3,
                                        outlier_frac=0.02)),
], ids=["system", "table2_row1", "k1000", "topk_kmeanspar", "tiny_machines",
        "stragglers"])
def test_derive_constants_cap_sharded_exact(n, p, k, eps, m, eta_o, extra):
    """Every field, cap_sharded and the knobs' own, equals the
    reference's; the uplink dtype and wire pass through."""
    kw = dict(k=k, epsilon=eps, sharded_coordinator=True, **extra)
    for ud, wire in (("float32", "values"), ("int8", "codes")):
        jc = jsoc.derive_constants(n, p, jcfg.SoccerParams(**kw),
                                   eta_override=eta_o, m=m,
                                   uplink_dtype=ud, uplink_wire=wire)
        tc = tsoc.derive_constants(n, p, SoccerParams(**kw),
                                   eta_override=eta_o, m=m,
                                   uplink_dtype=ud, uplink_wire=wire)
        assert ({f.name for f in dataclasses.fields(tc)}
                == {f.name for f in dataclasses.fields(jc)})
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    if n == 10_000_000 and k == 1000:
        assert tc.cap_sharded == 991_418


def _buffers(m=4, cap=64, d=5, k=6, seed=0):
    """Sharded sample buffers as draw_local_sample leaves them: points of
    a mixture, HT weights, the tail of every machine's slots empty."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(size=(k, d))
    pts = (means[rng.integers(0, k, (m, cap))]
           + 0.05 * rng.normal(size=(m, cap, d))).astype(np.float32)
    ws = rng.uniform(5.0, 15.0, size=(m, cap)).astype(np.float32)
    for j in range(m):
        ws[j, cap - 7 * (j + 1):] = 0.0
    c0 = pts[0, :k].copy()
    return pts, ws, c0


@pytest.mark.parametrize("k,iters", [(3, 4), (6, 10)])
def test_distributed_lloyd_matches_reference(k, iters):
    pts, ws, c0 = _buffers()
    got = tsk.distributed_lloyd(VirtualCluster(4), torch.from_numpy(pts),
                                torch.from_numpy(ws),
                                torch.from_numpy(c0[:k]), iters)
    want = jsk.distributed_lloyd(JCluster(4), jnp.asarray(pts),
                                 jnp.asarray(ws), jnp.asarray(c0[:k]), iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("outlier", [0.0, 40.0], ids=["plain", "kz_mass"])
@pytest.mark.parametrize("mode", ["bisect", "topk"])
def test_distributed_threshold_matches_reference(mode, outlier):
    """v from the same buffers and centers in both packages; the two
    modes also agree with each other."""
    pts, ws, c0 = _buffers(seed=3)
    k, d_k, alpha = 3, 2.5, 0.3
    args = dict(k=k, d_k=d_k, mode=mode, extra_top=4 if outlier else 0)
    got = tsk.distributed_threshold(
        VirtualCluster(4), torch.from_numpy(pts), torch.from_numpy(ws),
        torch.from_numpy(c0), alpha=torch.tensor(alpha),
        outlier_mass=torch.tensor(outlier), **args)
    want = jsk.distributed_threshold(
        JCluster(4), jnp.asarray(pts), jnp.asarray(ws), jnp.asarray(c0),
        alpha=jnp.float32(alpha), outlier_mass=jnp.float32(outlier), **args)
    assert float(want) > 0
    assert float(got) == pytest.approx(float(want), rel=RTOL)
    other = tsk.distributed_threshold(
        VirtualCluster(4), torch.from_numpy(pts), torch.from_numpy(ws),
        torch.from_numpy(c0), alpha=torch.tensor(alpha),
        outlier_mass=torch.tensor(outlier),
        **dict(args, mode="topk" if mode == "bisect" else "bisect"))
    assert float(other) == pytest.approx(float(got), rel=RTOL)


def test_draw_local_sample_truncates_and_reweighs():
    """A machine's quota is cut to cap; its HT weight rescales by
    n_j/min(c_j, cap) over exactly its drawn slots, the rest weigh 0."""
    m, p = 4, 100
    x = torch.rand((m, p, 3), generator=torch.Generator().manual_seed(0))
    w = torch.ones((m, p))
    alive = torch.ones((m, p), dtype=torch.bool)
    alive[3, 40:] = False
    n_vec = alive.sum(dim=1, dtype=torch.int32)
    pts, ws, real = tsk.draw_local_sample(
        VirtualCluster(m), torch.Generator().manual_seed(1), x, w, alive,
        n_vec, 200, 30)
    assert pts.shape == (m, 30, 3) and ws.shape == (m, 30)
    quota = apportion(n_vec, 200).tolist()
    assert quota[0] > 30 and quota[3] < 30
    c = [int((ws[j] > 0).sum()) for j in range(m)]
    assert c == [min(q, 30) for q in quota] and int(real) == sum(c)
    assert torch.allclose(ws[0], torch.full((30,), 100 / 30))
    assert torch.allclose(ws[3, :c[3]], torch.full((c[3],), 40 / c[3]))


def test_seeding_by_distribution():
    """The flattened-buffer seeding draws the first center ∝ ws and the
    second ∝ ws·d2 to the first: the two-stage reference's distribution
    (chi-square bound at 5 sigma); empty slots are never drawn."""
    vals = np.asarray([[0.0, 1.0, 3.0, 9.0], [4.0, 6.0, 7.0, 2.0]],
                      np.float32)
    ws = np.asarray([[1.0, 2.0, 0.0, 1.0], [3.0, 1.0, 2.0, 0.0]],
                    np.float32)
    pts = torch.from_numpy(vals[..., None])
    flat_v, flat_w = vals.reshape(-1), ws.reshape(-1).astype(np.float64)
    p0 = flat_w / flat_w.sum()
    joint = np.zeros((8, 8))
    for i in range(8):
        q = flat_w * (flat_v - flat_v[i]) ** 2
        joint[i] = p0[i] * q / q.sum()
    draws = 1200
    counts = np.zeros((8, 8))
    gen = torch.Generator().manual_seed(0)
    comm = VirtualCluster(2)
    for _ in range(draws):
        c = tsk.distributed_kmeans_pp(gen, comm, pts, torch.from_numpy(ws),
                                      2)[:, 0].numpy()
        i, j = (int(np.flatnonzero(flat_v == v)[0]) for v in c)
        counts[i, j] += 1
    assert counts[flat_w == 0].sum() == 0 and counts[:, flat_w == 0].sum() == 0
    se = np.sqrt(draws * joint * (1 - joint))
    assert np.all(np.abs(counts - draws * joint) <= 5 * se + 2)


def test_kmeanspar_seed_gives_k_centers():
    pts, ws, _ = _buffers(seed=5)
    c = tsk.distributed_kmeans_parallel_seed(
        torch.Generator().manual_seed(0), VirtualCluster(4),
        torch.from_numpy(pts), torch.from_numpy(ws), 6)
    assert c.shape == (6, 5) and c.dtype == torch.float32
    assert torch.isfinite(c).all()
    live = torch.from_numpy(pts[ws > 0])
    # every seed is a sample point of positive weight, bit for bit
    assert bool((c[:, None, :] == live[None]).all(-1).any(-1).all())


@pytest.fixture(scope="module")
def mixture():
    """tests/test_system.py's mixture."""
    spec = GaussianMixtureSpec(n=16_000, dim=15, k=K, sigma=0.001, seed=4)
    x, _, means = gaussian_mixture(spec)
    return x, means, shard_points(x, M)


@pytest.fixture(scope="module")
def gather_fits(mixture):
    x, _, parts = mixture
    port = tsoc.run_soccer(parts, SoccerParams(k=K, epsilon=0.1, seed=7),
                           device="cpu")
    ref = jsoc.run_soccer(jnp.asarray(parts), jcfg.SoccerParams(
        k=K, epsilon=0.1, seed=7))
    return port, ref


@pytest.fixture(scope="module")
def sharded_fits(mixture):
    """Sharded SOCCER on the mixture in both packages, fitted once for
    each (threshold, seeding) a test asks for."""
    _, _, parts = mixture
    fits = {}

    def get(threshold, seeding="d2"):
        if (threshold, seeding) not in fits:
            kw = dict(k=K, epsilon=0.1, sharded_coordinator=True, seed=7,
                      sharded_threshold=threshold, sharded_seeding=seeding)
            fits[threshold, seeding] = (
                tsoc.run_soccer(parts, SoccerParams(**kw), device="cpu"),
                jsoc.run_soccer(jnp.asarray(parts), jcfg.SoccerParams(**kw)))
        return fits[threshold, seeding]

    return get


@pytest.mark.parametrize("threshold,seeding", [
    ("bisect", "d2"), ("topk", "d2"), ("bisect", "kmeanspar"),
    ("topk", "kmeanspar")])
def test_sharded_soccer_matches_reference(mixture, gather_fits, sharded_fits,
                                          threshold, seeding):
    """Sharded SOCCER, every threshold and seeding: the reference's
    rounds and n_hist[0], a strictly falling n_hist, and
    tests/test_system.py:128's claim against the gather fit, for the
    port and the reference alike; the port's cost within 10% of the
    reference's."""
    x, means, parts = mixture
    port, ref = sharded_fits(threshold, seeding)
    assert port.rounds == ref.rounds >= 1
    assert int(port.n_hist[0]) == int(ref.n_hist[0]) == x.shape[0]
    ns = port.n_hist[: port.rounds + 1]
    assert all(ns[i + 1] < ns[i] for i in range(port.rounds))
    means_cost = _cost(x, means)
    for fit, gather in zip((port, ref), gather_fits):
        assert _cost(x, fit.centers) <= (1.5 * _cost(x, gather.centers)
                                         + 0.1 * means_cost)
    assert _cost(x, port.centers) <= 1.1 * _cost(x, ref.centers)


@pytest.mark.parametrize("threshold", ["bisect", "topk"])
def test_sharded_round_bytes(mixture, sharded_fits, threshold):
    """A sharded round moves no payload; its metadata equals the closed
    form in k_plus, lloyd_iters, m and d (``sharded_round_meta_bytes``),
    and exceeds the reference's once-a-trace count by exactly the
    collectives of the seeding steps, Lloyd steps and bisection steps
    after the first."""
    x, _, parts = mixture
    port, ref = sharded_fits(threshold)
    const = port.const
    m, d, s, it = M, x.shape[1], const.k_plus, const.lloyd_iters
    t = (tsk.topk_candidates(const.k, const.d_k, const.cap_sharded)
         if threshold == "topk" else 0)
    assert port.rounds >= 1
    for r in range(port.rounds):
        assert int(port.wire_payload[r]) == 0
        assert int(port.wire_meta[r]) == tsk.sharded_round_meta_bytes(
            m, d, s, it, topk_rows=t)
    extra = (s - 2) * (8 * m + 4 * m * d) + (it - 1) * 4 * m * (s * d + s)
    if threshold == "bisect":
        extra += (tsk.BISECT_STEPS - 1) * 4 * m
    assert int(port.wire_meta[0]) - int(ref.wire_meta[0]) == extra
    assert int(ref.wire_payload[0]) == 0


def test_sharded_round_with_stragglers_and_outliers(mixture):
    """The sharded branch composes with stragglers and the (k, z) mass:
    alpha is P2's own rate, uplink the two realized draws."""
    x, _, parts = mixture
    res = tsoc.run_soccer(parts, SoccerParams(
        k=K, epsilon=0.1, sharded_coordinator=True, straggler_rate=0.3,
        outlier_frac=0.02, seed=2), device="cpu")
    st = res.state
    assert res.rounds >= 1
    up, alpha = int(st.uplink[0]), float(st.alpha_hist[0])
    assert 0 < up <= 2 * res.const.eta
    assert 0 < alpha * x.shape[0] <= res.const.eta + M
    assert math.isfinite(float(st.v_hist[0])) and float(st.v_hist[0]) > 0
