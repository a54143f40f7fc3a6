"""The port's coreset tier on the CPU (the kernels' plain versions) against
the JAX package: the sensitivity bound and the coreset sizes to tight
tolerance on the same inputs, the wire accounting of ``coreset_kmeans``
and of SOCCER's ``uplink_mode="coreset"`` exactly, and the claims of
tests/test_coresets.py (unbiased weights, the sampling bound, a dead shard
is weightless, one-round clustering near a full Lloyd fit, the SOCCER
coreset uplink shrinks). The random streams differ between the packages,
so the sampled steps are held to outcomes.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.configs.soccer_paper import GaussianMixtureSpec as JSpec
from repro.configs.soccer_paper import SoccerParams as JParams
from repro.core import soccer as jsoc
from repro.coresets import default_coreset_size as jdefault
from repro.coresets import sensitivity_sigma as jsigma
from repro.data.synthetic import gaussian_mixture
from repro_torch import api
from repro_torch.configs.soccer_paper import SoccerParams
from repro_torch.core import soccer as tsoc
from repro_torch.core.comm import VirtualCluster, wire_tally
from repro_torch.core.kmeans import kmeans_plusplus
from repro_torch.core.metrics import centralized_cost
from repro_torch.core.sampling import gather_weighted
from repro_torch.coresets import (build_coreset, default_coreset_size,
                                  sensitivity_sigma)

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

K = 8


@pytest.fixture(scope="module")
def zipf():
    """tests/test_coresets.py's mixture."""
    x, _, means = gaussian_mixture(JSpec(n=6144, dim=15, k=K, sigma=0.001,
                                         seed=17))
    return x, means


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cost(x, centers, w=None) -> float:
    return float(centralized_cost(
        torch.as_tensor(np.array(x)), torch.as_tensor(np.array(centers)),
        None if w is None else torch.as_tensor(np.array(w))))


# ---- deterministic pieces --------------------------------------------------

@pytest.mark.parametrize("k,n", [(1, None), (3, 100), (8, None), (25, 10**7),
                                 (100, 2000)])
def test_default_coreset_size(k, n):
    assert default_coreset_size(k, n) == jdefault(k, n)


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "mask"])
def test_sensitivity_sigma_matches_reference(masked):
    """The same (x, w, centers) give the same sensitivity bounds. Spread-out
    data, so the expanded form's cancellation error stays far below the
    tolerance (at σ = 0.001 it is a few percent of d2; ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    n, d, k = 2000, 6, 9
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[:150] = 0.0
    c = rng.normal(size=(k, d)).astype(np.float32)
    valid = np.ones(k, bool)
    if masked:
        valid[[2, 5]] = False
    s_r = jsigma(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c),
                 jnp.asarray(valid))
    s_o = sensitivity_sigma(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(c), torch.from_numpy(valid))
    np.testing.assert_allclose(s_o.numpy(), np.asarray(s_r), rtol=1e-4,
                               atol=1e-9)
    assert (s_o.numpy()[:150] == 0).all()


@pytest.mark.parametrize("kw", [
    dict(k=8, epsilon=0.1, uplink_mode="coreset"),
    dict(k=8, epsilon=0.1, uplink_mode="coreset", coreset_size=800),
    dict(k=25, epsilon=0.05, uplink_mode="coreset", coreset_bicriteria=5),
    dict(k=3, epsilon=0.2, uplink_mode="coreset", coreset_size=10**6),
    dict(k=8, epsilon=0.1, outlier_frac=0.02),
], ids=["auto", "sized", "bicriteria", "capped", "points"])
@pytest.mark.parametrize("eta_override", [0, 1600])
def test_derive_constants_coreset_fields(kw, eta_override):
    jc = jsoc.derive_constants(6144, 768, JParams(**kw),
                               eta_override=eta_override, m=8)
    tc = tsoc.derive_constants(6144, 768, SoccerParams(**kw),
                               eta_override=eta_override, m=8)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name


def test_gather_weighted_accounting():
    """Points on the payload channel, weights on the metadata channel, both
    fixed-width; on the int8 codes wire the points move as 1-byte codes
    plus 8 bytes of qparams a machine and arrive as the values wire's
    int8 reconstruction, bit for bit."""
    comm = VirtualCluster(4)
    pts = torch.rand((4, 5, 3))
    wts = torch.rand((4, 5))
    with wire_tally() as t:
        g_pts, g_w = gather_weighted(comm, pts, wts)
    assert g_pts.shape == (20, 3) and g_w.shape == (20,)
    assert torch.equal(g_pts, pts.reshape(20, 3))
    assert (t.payload, t.meta) == (4 * 5 * 3 * 4, 4 * 5 * 4)
    with wire_tally() as tc:
        c_pts, c_w = gather_weighted(comm, pts, wts, "int8", wire="codes")
    with wire_tally() as tv:
        v_pts, v_w = gather_weighted(comm, pts, wts, "int8")
    assert torch.equal(c_pts, v_pts) and torch.equal(c_w, v_w)
    assert c_pts.dtype == torch.float32
    assert (tc.payload, tc.meta) == (4 * 5 * 3, 4 * 5 * 4 + 8 * 4)
    assert (tv.payload, tv.meta) == (4 * 5 * 3 * 4, 4 * 5 * 4)


# ---- construction claims (tests/test_coresets.py) -------------------------

def test_sigma_properties(zipf):
    x, _ = zipf
    xt = torch.from_numpy(x)
    w = torch.ones(x.shape[0])
    w[:100] = 0.0
    centers = kmeans_plusplus(_gen(0), xt, w, K)
    sigma = sensitivity_sigma(xt, w, centers).numpy()
    assert (sigma >= 0).all()
    assert (sigma[:100] == 0).all()            # zero weight: never drawn
    assert sigma.sum() <= 2.0 + 1e-4


def test_coreset_weights_unbiased(zipf):
    x, _ = zipf
    n = x.shape[0]
    pts, u = build_coreset(_gen(1), torch.from_numpy(x), torch.ones(n),
                           2048, K)
    assert pts.shape == (2048, x.shape[1]) and u.dtype == torch.float32
    assert float(u.sum()) == pytest.approx(n, rel=0.1)


def test_coreset_cost_within_sampling_bound(zipf):
    """For fixed center sets (near-optimal, perturbed, too coarse), the
    coreset-weighted cost is within ~O(sqrt(S/t)) of the full cost."""
    x, means = zipf
    xt = torch.from_numpy(x)
    n = x.shape[0]
    w = torch.ones(n)
    t = 1536
    bound = 6.0 * float(np.sqrt(2.0 / t))
    rng = np.random.default_rng(0)
    center_sets = [means,
                   means + rng.normal(0, 0.05, means.shape).astype(np.float32),
                   kmeans_plusplus(_gen(3), xt, w, 3).numpy()]
    for seed in (0, 1):
        pts, u = build_coreset(_gen(seed), xt, w, t, K)
        for c in center_sets:
            full = _cost(x, c)
            core = _cost(pts.numpy(), c, u.numpy())
            assert abs(core - full) <= bound * full, (seed, full, core)


def test_coreset_dead_shard_is_weightless(zipf):
    x, _ = zipf
    pts, u = build_coreset(_gen(2), torch.from_numpy(x),
                           torch.zeros(x.shape[0]), 64, 4)
    assert pts.shape == (64, x.shape[1])
    assert float(u.abs().max()) == 0.0


# ---- coreset_kmeans ---------------------------------------------------------

@pytest.fixture(scope="module")
def coreset_fits(zipf):
    x, _ = zipf
    kw = dict(algo="coreset_kmeans", m=8, seed=0, coreset_size=2048)
    return (api.fit(x, K, device="cpu", **kw),
            jfit(x, K, backend="virtual", **kw))


def test_coreset_kmeans_one_round_baseline(zipf, coreset_fits):
    """One round, 256 rows a machine, and a cost near a full Lloyd fit on
    all the data (the reference's ``lloyd`` algorithm: not ported) at a
    third of its uplink."""
    x, _ = zipf
    res, _ = coreset_fits
    assert res.rounds == 1
    assert res.uplink_points_total == 2048
    assert np.array_equal(res.uplink_bytes, res.uplink_points * 15 * 4)
    assert res.extra["coreset_rows_per_machine"] == 256
    assert res.centers.shape == (K, 15)
    full = jfit(x, K, algo="lloyd", backend="virtual", m=8, seed=0, iters=25)
    assert res.uplink_points_total * 3 <= full.uplink_points_total
    assert _cost(x, res.centers) <= 1.5 * _cost(x, full.centers)


def test_coreset_kmeans_wire_matches_reference(coreset_fits):
    res, jres = coreset_fits
    for f in ("uplink_points", "uplink_bytes", "wire_bytes",
              "wire_meta_bytes"):
        np.testing.assert_array_equal(getattr(res, f), getattr(jres, f))
    assert res.wire_bytes_total == jres.wire_bytes_total
    for key in ("coreset_rows_per_machine", "bicriteria"):
        assert res.extra[key] == jres.extra[key]


def test_coreset_kmeans_validation():
    x = np.zeros((256, 3), np.float32)
    with pytest.raises(ValueError, match="blackbox"):
        api.fit(x, 2, algo="coreset_kmeans", m=4, blackbox="exact",
                device="cpu")
    with pytest.raises(ValueError, match="contradictory"):
        api.fit(x, 2, algo="coreset_kmeans", m=4, uplink_mode="points",
                device="cpu")
    mb = api.fit(x, 2, algo="coreset_kmeans", m=4, blackbox="minibatch",
                 minibatch_size=64, coreset_size=64, device="cpu")
    assert mb.rounds == 1 and mb.centers.shape == (2, 3)
    res = api.fit(x, 2, algo="coreset_kmeans", m=4, uplink_mode="coreset",
                  coreset_size=64, lloyd_iters=2, device="cpu")
    assert res.rounds == 1 and res.params["uplink_mode"] == "coreset"


# ---- SOCCER's coreset uplink -------------------------------------------------

@pytest.fixture(scope="module")
def soccer_fits(zipf):
    """tests/test_coresets.py:117's configuration, points and coreset
    uplinks, in both packages."""
    x, _ = zipf
    kw = dict(algo="soccer", m=8, seed=3, epsilon=0.1, eta_override=1600)
    return {mode: (api.fit(x, K, uplink_mode=mode, device="cpu", **kw),
                   jfit(x, K, backend="virtual", uplink_mode=mode, **kw))
            for mode in ("points", "coreset")}


def test_soccer_uplink_mode_coreset_shrinks_uplink(zipf, soccer_fits):
    x, _ = zipf
    base, _ = soccer_fits["points"]
    cs, _ = soccer_fits["coreset"]
    assert cs.uplink_bytes_total < base.uplink_bytes_total
    assert cs.params["uplink_mode"] == "coreset"
    assert cs.rounds >= 1
    assert _cost(x, cs.centers) <= 2.0 * _cost(x, base.centers)
    assert cs.rounds <= base.rounds + 1


def test_soccer_coreset_wire_matches_reference(soccer_fits):
    """Rounds, uplink rows and wire bytes equal the reference's: in coreset
    mode each upload is m·t rows whatever the draw, so after the same
    number of rounds every byte count is the same."""
    cs, jcs = soccer_fits["coreset"]
    assert cs.rounds == jcs.rounds
    for f in ("uplink_points", "uplink_bytes", "wire_bytes",
              "wire_meta_bytes"):
        np.testing.assert_array_equal(getattr(cs, f), getattr(jcs, f))
    const = cs.extra["const"]
    assert const.coreset_rows == jcs.extra["const"].coreset_rows
    assert const.coreset_kb == jcs.extra["const"].coreset_kb


def test_uplink_mode_validation():
    x = np.zeros((256, 3), np.float32)
    with pytest.raises(ValueError, match="uplink_mode"):
        api.fit(x, 2, algo="soccer", m=4, uplink_mode="sketch", device="cpu")
    with pytest.raises(TypeError, match="uplink_mode"):
        api.fit(x, 2, algo="kmeans_parallel", m=4, uplink_mode="coreset",
                device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        SoccerParams(k=2, uplink_mode="coreset", sharded_coordinator=True)


def test_coreset_uplink_runs_sync_free_shapes(zipf):
    """One coreset-mode round by hand: the draw gives m·t rows and weights
    whose total estimates the live mass, and the round records the same
    uplink rows as its two draws."""
    x, _ = zipf
    parts = torch.from_numpy(x.reshape(8, 768, 15))
    params = SoccerParams(k=K, epsilon=0.1, uplink_mode="coreset",
                          coreset_size=800)
    const = tsoc.derive_constants(6144, 768, params, eta_override=1600, m=8)
    state = tsoc.init_state(parts, const, _gen(4))
    comm = VirtualCluster(8)
    alive_eff, n_vec, _ = tsoc._live_counts(comm, state)
    pts, wts, up, real = tsoc._draw_sample(comm, const, state, alive_eff,
                                           n_vec)
    assert pts.shape == (8 * const.coreset_rows, 15)
    assert int(up) == 8 * const.coreset_rows and int(real) == 1600
    assert float(wts.sum()) == pytest.approx(6144, rel=0.15)
    state = tsoc.soccer_round(state, comm, const)
    assert int(state.uplink[0]) == 2 * 8 * const.coreset_rows
    assert int(state.n_remaining) < 6144
