"""The port's robust tier on the CPU (the kernels' plain versions) against
the JAX package: ``kzmeans`` (tests/test_kzmeans.py's claims — robust beats
plain on inliers at equal uplink, budget carving, honest objective
accounting, validation — and its wire bytes exactly), its deterministic
pieces from shared inputs (``contaminate`` bit for bit, ``trimmed_lloyd``
from a shared init, the realized threshold and the psum'd triples), and
SOCCER's ``outlier_frac`` knob (tests/test_ft.py:192's robust finalize,
and the truncated removal threshold over several rounds).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import fit as jfit
from repro.configs.soccer_paper import GaussianMixtureSpec as JSpec
from repro.core.truncated_cost import trim_top_mass as jtrim
from repro.data.synthetic import contaminate as jcontaminate
from repro.data.synthetic import gaussian_mixture, shard_points
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.configs.soccer_paper import SoccerParams
from repro_torch.core.comm import VirtualCluster
from repro_torch.core.metrics import centralized_cost
from repro_torch.core.soccer import run_soccer
from repro_torch.data.synthetic import contaminate
from repro_torch.kernels import ops
from repro_torch.robust.kzmeans import realized_threshold, trimmed_lloyd

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)

M, K = 8, 5
FRAC = 0.02
BUDGET = 1600          # total uplink rows, both conditions


def _cost(x, centers) -> float:
    return float(centralized_cost(torch.as_tensor(np.array(x)),
                                  torch.as_tensor(np.array(centers))))


@pytest.fixture(scope="module")
def contaminated():
    """tests/test_kzmeans.py's data."""
    x, _, means = gaussian_mixture(JSpec(n=6_000, dim=8, k=K, sigma=0.001,
                                         seed=11))
    xc, mask = contaminate(x, frac=FRAC, scale=50.0, seed=3)
    return xc, mask, means


@pytest.fixture(scope="module")
def fits(contaminated):
    """The port's and the reference's kzmeans, plain and robust."""
    xc, _, _ = contaminated
    kw = dict(algo="kzmeans", m=M, coreset_size=BUDGET, lloyd_iters=10,
              seed=0)
    return {frac: (api.fit(xc, K, outlier_frac=frac, device="cpu", **kw),
                   jfit(xc, K, backend="virtual", outlier_frac=frac, **kw))
            for frac in (0.0, FRAC)}


# ---- deterministic pieces --------------------------------------------------

@pytest.mark.parametrize("geometry", ["isotropic", "clustered"])
@pytest.mark.parametrize("frac,seed", [(0.02, 7), (0.001, 3), (0.1, 11)])
def test_contaminate_bit_identical(geometry, frac, seed):
    x, _, _ = gaussian_mixture(JSpec(n=3000, dim=15, k=4, seed=2))
    a = contaminate(x, frac=frac, scale=50.0, seed=seed, geometry=geometry)
    b = jcontaminate(x, frac=frac, scale=50.0, seed=seed, geometry=geometry)
    assert a[0].dtype == b[0].dtype == np.float32
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_contaminate_rejects_unknown_geometry():
    with pytest.raises(ValueError, match="geometry"):
        contaminate(np.zeros((10, 2), np.float32), geometry="ring")


def _rows(seed=0, n=1500, d=6, k=4):
    """Gathered rows at σ = 0.05 (well above the expanded form's
    cancellation error), with weights, a far tail and zero-weight rows."""
    x, _, _ = gaussian_mixture(JSpec(n=n, dim=d, k=k, sigma=0.05, seed=seed))
    rng = np.random.default_rng(seed)
    x[:30] += rng.normal(0, 20.0, size=(30, d)).astype(np.float32)
    w = (rng.random(n) * 3).astype(np.float32)
    w[30:60] = 0.0
    return x, w


@pytest.mark.parametrize("z_mass", [0.0, 45.0])
def test_trimmed_lloyd_matches_reference(z_mass):
    """From a shared init on the same rows, the port's trimmed Lloyd and
    the reference's step loop (kzmeans.py:168-175) reach the same centers."""
    x, w = _rows()
    k = 4
    c0 = x[100:100 + k].copy()
    xj, wj = jnp.asarray(x), jnp.asarray(w)

    def jstep(c):
        d2, assign = jops.min_dist(xj, c)
        w_t = jtrim(d2, wj, jnp.float32(z_mass))
        sums, counts = jops.lloyd_reduce(xj, w_t, assign, k)
        return jnp.where(counts[:, None] > 0,
                         sums / jnp.maximum(counts[:, None], 1e-30), c)

    cj = jnp.asarray(c0)
    for _ in range(10):
        cj = jstep(cj)
    ct = trimmed_lloyd(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(c0), torch.tensor(z_mass), 10)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("z_mass", [45.0, 300.5, 1e9])
def test_realized_threshold_and_triples_match_reference(z_mass):
    """On the same rows and centers, the realized trim threshold
    (kzmeans.py:180-188) and the psum'd per-machine truncated-cost triples
    (:190-196) equal the reference's."""
    x, w = _rows(seed=1, n=1600)
    c = x[200:204].copy()
    xj, wj, cj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(c)
    d2j, _ = jops.min_dist(xj, cj)
    order = jnp.argsort(-d2j)
    cum = jnp.cumsum(wj[order])
    j = jnp.minimum(jnp.searchsorted(cum, jnp.float32(z_mass)),
                    d2j.shape[0] - 1)
    v_r = float(d2j[order][j])
    d2t, _ = ops.min_dist(torch.from_numpy(x), torch.from_numpy(c))
    v_o = float(realized_threshold(d2t, torch.from_numpy(w),
                                   torch.tensor(z_mass)))
    assert v_o == pytest.approx(v_r, rel=1e-5)

    # v is a row's own d2, which the frameworks' summation orders may put
    # on either side of it: score at the midpoint to the next d2 above
    d2s = np.sort(np.asarray(d2j))
    above = d2s[d2s > v_r]
    v = 0.5 * (v_r + above[0]) if above.size else v_r + 1.0
    xm, wm = x.reshape(8, 200, 6), w.reshape(8, 200)
    trip_r = [jops.truncated_cost(jnp.asarray(xm[i]), jnp.asarray(wm[i]), cj,
                                  jnp.float32(v)) for i in range(8)]
    want = np.sum(np.asarray(trip_r, np.float64), axis=0)
    comm = VirtualCluster(8)
    got = [float(comm.psum(t)) for t in ops.truncated_cost(
        torch.from_numpy(xm), torch.from_numpy(wm), torch.from_numpy(c),
        torch.tensor(v))]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# ---- kzmeans claims (tests/test_kzmeans.py) ---------------------------------

def test_registered():
    assert "kzmeans" in api.list_algorithms()


def test_robust_beats_plain_on_inliers(contaminated, fits):
    xc, mask, means = contaminated
    ref = _cost(xc[mask], means)
    costs = {f: _cost(xc[mask], r.centers) for f, (r, _) in fits.items()}
    assert not np.array_equal(fits[0.0][0].centers, fits[FRAC][0].centers)
    assert costs[FRAC] <= 3.0 * ref, costs
    assert costs[FRAC] < 0.01 * costs[0.0], costs


def test_budget_carving_keeps_uplink_equal(fits):
    d = fits[0.0][0].centers.shape[1]
    for frac, (res, _) in fits.items():
        assert res.rounds == 1
        assert np.array_equal(res.uplink_points, [BUDGET]), frac
        assert np.array_equal(res.uplink_bytes, [BUDGET * d * 4]), frac
        e = res.extra
        assert (e["coreset_rows_per_machine"]
                + e["candidate_rows_per_machine"]) * M == BUDGET
    assert fits[0.0][0].extra["candidate_rows_per_machine"] == 0
    assert fits[FRAC][0].extra["candidate_rows_per_machine"] > 0


@pytest.mark.parametrize("frac", [0.0, FRAC], ids=["plain", "robust"])
def test_kzmeans_wire_matches_reference(fits, frac):
    res, jres = fits[frac]
    for f in ("uplink_points", "uplink_bytes", "wire_bytes",
              "wire_meta_bytes"):
        np.testing.assert_array_equal(getattr(res, f), getattr(jres, f))
    assert sorted(res.extra) == sorted(jres.extra)
    for key in ("coreset_rows_per_machine", "candidate_rows_per_machine",
                "bicriteria", "outlier_frac"):
        assert res.extra[key] == jres.extra[key]


def test_kz_objective_accounting(contaminated, fits):
    xc, _, _ = contaminated
    res = fits[FRAC][0]
    e = res.extra
    total = _cost(xc, res.centers)
    np.testing.assert_allclose(e["kz_cost"] + e["trimmed_cost"], total,
                               rtol=1e-4)
    z_mass = FRAC * xc.shape[0]
    assert 0.5 * z_mass <= e["trimmed_mass"] <= z_mass + 1.0
    assert e["kz_cost"] < 1e-3 * total
    e0 = fits[0.0][0].extra
    assert e0["trimmed_mass"] == 0.0 and e0["trimmed_cost"] == 0.0


def test_validation():
    x = np.zeros((256, 3), np.float32)
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="outlier_frac"):
            api.fit(x, 2, algo="kzmeans", m=4, outlier_frac=bad,
                    device="cpu")
    with pytest.raises(ValueError, match="uplink_mode"):
        api.fit(x, 2, algo="kzmeans", m=4, uplink_mode="points",
                device="cpu")
    res = api.fit(x, 2, algo="kzmeans", m=4, uplink_mode="coreset",
                  coreset_size=64, lloyd_iters=2, device="cpu")
    assert res.rounds == 1


# ---- SOCCER's outlier_frac --------------------------------------------------

def test_outlier_robust_finalize():
    """tests/test_ft.py:192: with gross outliers injected and eta >= n (a
    zero-round run, so the finalize fit is the k-clustering under test),
    the trimmed finalize keeps the centers on the inliers and beats the
    plain finalize by a wide margin.

    The reference asserts "within 3x of the mixture means" at one seed; in
    both packages the bound depends on the seed (the finalize's k-means++
    seedings can leave an outlier row as a center and merge two
    components). scripts/robust_finalize_rate.py measures the rate: the
    port 32 of seeds 0-63 (324 of 576 seeds), the JAX package 41 of seeds
    0-63 (77 of 144). So the margin over the plain fit is held at each of
    eight seeds, and the bound at no fewer than 28 of 64 seeds, 4 below
    the port's count: a rate fallen to 35% meets it with probability
    below 10%, and a change of the random stream that keeps the rate near
    the reference's misses it with probability near 5% (binomial tails),
    in which case the rate is measured again, not the seeds changed."""
    x, _, means = gaussian_mixture(JSpec(n=12_000, dim=10, k=6, sigma=0.001,
                                         seed=6))
    rng = np.random.default_rng(3)
    outliers = rng.normal(0, 300.0, size=(120, x.shape[1])).astype(
        np.float32)
    x_all = np.concatenate([x, outliers])
    rng.shuffle(x_all)
    parts = shard_points(x_all, M)
    ref = _cost(x, means)
    near = 0
    for seed in range(64):
        runs = {}
        for frac in ((0.0, 0.02) if seed < 8 else (0.02,)):
            runs[frac] = run_soccer(
                parts, SoccerParams(k=6, epsilon=0.1, seed=seed,
                                    outlier_frac=frac),
                eta_override=x_all.shape[0], device="cpu")
            assert runs[frac].rounds == 0, "eta >= n must skip every round"
        costs = {f: _cost(x, r.centers) for f, r in runs.items()}
        if seed < 8:
            assert not np.array_equal(runs[0.0].centers, runs[0.02].centers)
            assert costs[0.02] < 0.1 * costs[0.0], (seed, costs)
        near += costs[0.02] <= 3.0 * ref
    assert near >= 28, near


def test_robust_soccer_rounds(contaminated):
    """With rounds to run, z = outlier_frac·N joins the removal threshold's
    truncation mass (soccer.py:218-221): from the same seed both runs draw
    the same samples and fit the same C_iter in round 1, so the robust
    threshold is lower and removes less. The robust run keeps Theorem 4.1's
    structure."""
    xc, _, _ = contaminated
    kw = dict(algo="soccer", m=M, seed=2, epsilon=0.1, eta_override=900,
              device="cpu")
    res = {f: api.fit(xc, K, outlier_frac=f, **kw) for f in (0.0, FRAC)}
    r, plain = res[FRAC], res[0.0]
    const = r.extra["const"]
    assert const.outlier_frac == FRAC and r.rounds >= 1
    assert r.v_hist[0] < plain.v_hist[0]
    assert r.n_hist[1] >= plain.n_hist[1]
    ns = r.n_hist
    assert all(ns[i + 1] < ns[i] for i in range(r.rounds))
    assert r.centers.shape[0] <= r.rounds * const.k_plus + K
    assert all(r.uplink_points[i] <= 2 * const.eta + M
               for i in range(r.rounds))
    assert r.wire_bytes_total == int(np.sum(r.wire_bytes)
                                     + np.sum(r.wire_meta_bytes))


def test_kzmeans_claims_at_the_smoke_proportions(capsys):
    """``chip_smoke.py``'s kzmeans configuration scaled down 62.5x: the
    paper's §8 mixture at k = 25 with 2% outliers (163,200 points), a
    budget leaving t = 16 coreset rows beside the 3,264 candidate rows of
    each machine (10.2 M points with t = 1,000 beside 204,000 on the card).
    There, each shard's candidate rows, which never seed, hold the small
    Zipf components whole, and the robust fit misses several of them in
    the reference as in the port: its inlier cost is thousands of times
    the means', far from tests/test_kzmeans.py's bound of 3 at n = 6,000,
    k = 5. The port is held to the reference's outcome here (within 3x)
    and to robust < plain; ``-s`` prints the ratios."""
    x, _, means = gaussian_mixture(JSpec(n=160_000, dim=15, k=25,
                                         sigma=0.001, seed=17))
    xc, _ = contaminate(x, frac=FRAC, scale=50.0, seed=7)
    kw = dict(algo="kzmeans", m=M, seed=0, coreset_size=8 * (3264 + 16))
    ref = _cost(x, means)
    robust = api.fit(xc, 25, outlier_frac=FRAC, device="cpu", **kw)
    plain = api.fit(xc, 25, outlier_frac=0.0, device="cpu", **kw)
    jrobust = jfit(xc, 25, backend="virtual", outlier_frac=FRAC, **kw)
    assert robust.extra["coreset_rows_per_machine"] == 16
    assert robust.extra["candidate_rows_per_machine"] == 3264
    r, p, j = (_cost(x, f.centers) / ref for f in (robust, plain, jrobust))
    with capsys.disabled():
        print(f"\nkzmeans at 163,200 points, t = 16: inlier cost / means' "
              f"port robust {r:.1f}, plain {p:.1f}; reference robust "
              f"{j:.1f}")
    assert r < p
    assert j / 3.0 <= r <= 3.0 * j, (r, j)


def test_kzmeans_past_the_register_rows(monkeypatch):
    """kzmeans at d = 37 (on the card: ``sensitivity_scores`` and
    ``truncated_cost`` on the tiled walk; here their plain versions), 2%
    outliers, 2,000 points, k = 4, m = 4, on the same numpy inputs as the
    reference's fit: both kernels reached at the points' width, the
    reference's uplink rows, bytes and wire bytes exactly, tests/
    test_kzmeans.py's accounting (kz cost + trimmed cost = the full cost,
    z/2 <= trimmed mass <= z + 1) in both packages, robust beats plain on
    the inliers, and the port's inlier cost within 3x the reference's."""
    m, k = 4, 4
    x, _, means = gaussian_mixture(JSpec(n=2_000, dim=37, k=k, sigma=0.001,
                                         seed=5))
    xc, mask = contaminate(x, frac=FRAC, scale=50.0, seed=3)
    widths = {}
    for name in ("sensitivity_scores", "truncated_cost"):
        real = getattr(ops, name)

        def record(xx, *a, _name=name, _real=real, **kw):
            widths.setdefault(_name, set()).add(xx.shape[-1])
            return _real(xx, *a, **kw)
        monkeypatch.setattr(ops, name, record)
    kw = dict(algo="kzmeans", m=m, coreset_size=400, lloyd_iters=10, seed=0)
    ours = {f: api.fit(xc, k, outlier_frac=f, device="cpu", **kw)
            for f in (0.0, FRAC)}
    theirs = jfit(xc, k, backend="virtual", outlier_frac=FRAC, **kw)
    assert widths == {"sensitivity_scores": {37}, "truncated_cost": {37}}
    res = ours[FRAC]
    for f in ("uplink_points", "uplink_bytes", "wire_bytes",
              "wire_meta_bytes"):
        np.testing.assert_array_equal(getattr(res, f), getattr(theirs, f))
    assert np.array_equal(res.uplink_bytes, [400 * 37 * 4])
    z_mass = FRAC * xc.shape[0]
    for r in (res, theirs):
        e = r.extra
        np.testing.assert_allclose(e["kz_cost"] + e["trimmed_cost"],
                                   _cost(xc, r.centers), rtol=1e-4)
        assert 0.5 * z_mass <= e["trimmed_mass"] <= z_mass + 1.0
    inl = {f: _cost(xc[mask], r.centers) for f, r in ours.items()}
    assert inl[FRAC] < inl[0.0]
    j = _cost(xc[mask], theirs.centers)
    assert j / 3.0 <= inl[FRAC] <= 3.0 * j, (inl[FRAC], j)


def test_kzmeans_trimmed_mass_without_outliers():
    """tests/test_kzmeans.py bounds the trimmed mass by z/2 and z + 1 on
    data whose outliers lie far out. On a table without outliers (the
    smoke's kimi-k2 embedding fit: Gaussian rows) the upper bound is not
    an identity: the candidates are each machine's farthest rows from its
    own bicriteria, and rows beyond the realized threshold that no machine
    shipped add to the mass. Here, at 16,384 × 64 Gaussian rows, k = 16,
    m = 8, 100 coreset + 328 candidate rows a machine, the reference
    itself trims more than z + 1; both packages trim at least z/2 and
    within 15% of z, the port's trimmed mass is the count of rows beyond
    v, and kz cost + trimmed cost is the full cost in both."""
    n, d, m, k = 16_384, 64, 8, 16
    x = (np.random.default_rng(0).standard_normal((n, d))
         * 0.02).astype(np.float32)
    kw = dict(algo="kzmeans", m=m, outlier_frac=FRAC,
              coreset_size=m * (100 + 328), seed=0)
    ours = api.fit(x, k, device="cpu", **kw)
    theirs = jfit(x, k, backend="virtual", **kw)
    z = FRAC * n
    assert theirs.extra["trimmed_mass"] > z + 1.0
    for r in (ours, theirs):
        e = r.extra
        assert (e["coreset_rows_per_machine"],
                e["candidate_rows_per_machine"]) == (100, 328)
        assert 0.5 * z <= e["trimmed_mass"] <= 1.15 * z, e["trimmed_mass"]
        np.testing.assert_allclose(e["kz_cost"] + e["trimmed_cost"],
                                   _cost(x, r.centers), rtol=1e-4)
    d2, _ = ops.min_dist(torch.as_tensor(x), torch.as_tensor(ours.centers))
    assert ours.extra["trimmed_mass"] == int(
        (d2 > ours.extra["trim_threshold"]).sum())
