"""The PyTorch port's kernel entry points against the JAX package's oracles.

Every entry point of ``repro_torch.kernels.ops`` runs here on CPU tensors,
i.e. through its plain PyTorch version, and is held against
``repro.kernels.ref`` on the same numpy inputs over the rows of the
conformance grid in ``tests/test_kernel_conformance.py`` (the resident
ones, k <= 1024, and the chunked ones, k = 1025 and 2100), in float32,
bfloat16 and float16, with that file's tolerances. The chunked shapes are
also held against the reference's chunked Pallas kernel in interpret mode,
in both its single-walk and its two-walk regime; ``lloyd_reduce`` and
``remove_below`` beyond 1024 centers against the reference's
``lloyd_reduce_pallas`` and ``remove_below_chunked_pallas`` likewise. The
CUDA kernels
themselves run only on the card: ``tests/test_torch_cuda.py`` holds them
against their plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import build, exact, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import fused_lloyd as tfused
from repro_torch.kernels import lloyd as tlloyd
from repro_torch.kernels import min_dist as tmin
from repro_torch.kernels import sensitivity as tsens
from repro_torch.kernels import truncated as ttrunc
from repro_torch.kernels import walk as twalk

# xdist runs one worker per core: with torch's default of one intra-op
# thread per core in every worker, the pools contend and small ops run
# several times slower
torch.set_num_threads(1)


# (name, n, d, k): the reference conformance grid, resident and chunked
CHUNKED_SHAPES = [
    ("k_over_max", 72, 9, 1025),
    ("k_chunked_multi", 64, 33, 2100),
]
POINT_SHAPES = [
    ("tiny_subblock", 7, 3, 1),
    ("small_unaligned", 100, 8, 5),
    ("n_at_block", 128, 16, 32),
    ("n_over_block", 129, 16, 32),
    ("k_over_panel", 200, 37, 130),
    ("d_at_max", 48, 512, 6),
    ("d_over_max", 48, 513, 6),
    ("k_at_max", 72, 9, 1024),
] + CHUNKED_SHAPES
IDS = [s[0] for s in POINT_SHAPES]
# kimi-k2's embedding width, which the tiled walk takes on the card (d > 16)
WIDE_SHAPES = [("d_embedding", 40, 7168, 5)]
WIDE_IDS = IDS + [s[0] for s in WIDE_SHAPES]
MP_SHAPES = [("tiny", 2, 40, 7, 5), ("n_over_block", 3, 129, 16, 33),
             ("d_wide", 1, 40, 513, 5), ("d_embedding", 1, 40, 7168, 5)]
MP_IDS = [s[0] for s in MP_SHAPES]

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.float16, torch.float16)]
DT_IDS = ["f32", "bf16", "f16"]


def _tols(jdt):
    """(loose, tight), as tests/test_kernel_conformance.py::_tols: the
    rounded inputs amplify the expanded-form distance differently under
    the two frameworks' matmul orders."""
    return (2e-3, 1e-4) if jdt == jnp.float32 else (5e-2, 1e-4)


def _both(a: np.ndarray, jdt, tdt):
    """The same values in both frameworks: rounded once by JAX, then
    carried over exactly."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _data(n, d, k, jdt, tdt, seed):
    rng = np.random.default_rng(seed)
    xj, xt = _both(rng.normal(size=(n, d)).astype(np.float32), jdt, tdt)
    w = rng.random(n).astype(np.float32)
    w[: n // 5] = 0.0                                  # some padding rows
    cj, ct = _both(rng.normal(size=(k, d)).astype(np.float32), jdt, tdt)
    valid = rng.random(k) > 0.3
    valid[0] = True
    return (xj, jnp.asarray(w), cj, jnp.asarray(valid),
            xt, torch.from_numpy(w), ct, torch.from_numpy(valid))


@pytest.mark.parametrize("name,n,d,k", POINT_SHAPES + WIDE_SHAPES,
                         ids=WIDE_IDS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_min_dist_matches_reference(name, n, d, k, jdt, tdt):
    xj, _, cj, vj, xt, _, ct, vt = _data(n, d, k, jdt, tdt, seed=n + d + k)
    tol, _ = _tols(jdt)
    for cvj, cvt in ((None, None), (vj, vt)):
        d2_r, _ = jref.min_dist_ref(xj, cj, cvj)
        d2_o, idx_o = ops.min_dist(xt, ct, cvt)
        assert d2_o.dtype == torch.float32 and idx_o.dtype == torch.int32
        np.testing.assert_allclose(d2_o.numpy(), d2_r, rtol=tol, atol=tol)
        # argmin ties may break differently; the chosen center must be
        # valid and realize the reported distance
        if cvt is not None:
            assert bool(cvt[idx_o.long()].all())
        ci = ct.float()[idx_o.long()]
        d2_at = ((xt.float() - ci) ** 2).sum(-1)
        np.testing.assert_allclose(d2_at.numpy(), d2_r, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,n,d,k", POINT_SHAPES + WIDE_SHAPES,
                         ids=WIDE_IDS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_fused_assign_reduce_matches_reference(name, n, d, k, jdt, tdt):
    xj, wj, cj, vj, xt, wt, ct, vt = _data(n, d, k, jdt, tdt,
                                           seed=3 * n + d + k)
    tol, tight = _tols(jdt)
    for cvj, cvt in ((None, None), (vj, vt)):
        s_r, c_r, cost_r = jref.fused_assign_reduce_ref(xj, wj, cj, cvj)
        s_o, c_o, cost_o = ops.fused_assign_reduce(xt, wt, ct, cvt)
        np.testing.assert_allclose(s_o.numpy(), s_r, rtol=tol, atol=tol)
        np.testing.assert_allclose(c_o.numpy(), c_r, rtol=tight, atol=tight)
        np.testing.assert_allclose(float(cost_o), float(cost_r), rtol=tol,
                                   atol=tol)
        if cvt is not None:               # invalid centers receive no mass
            assert float(c_o[~cvt].abs().sum()) == 0.0


@pytest.mark.parametrize("budget", [None, 1], ids=["single_walk", "two_walk"])
@pytest.mark.parametrize("name,n,d,k", CHUNKED_SHAPES,
                         ids=[s[0] for s in CHUNKED_SHAPES])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_chunked_plain_matches_chunked_pallas(name, n, d, k, jdt, tdt,
                                              budget):
    """The chunked CUDA kernel's plain version against the reference's
    chunked Pallas kernel in interpret mode: its single walk with
    walk-resident accumulators, and its two-walk fallback, forced by an
    accumulator budget of one byte (test_kernel_conformance.py:357-373)."""
    from repro.kernels.fused_lloyd import fused_assign_reduce_chunked_pallas
    xj, wj, cj, vj, xt, wt, ct, vt = _data(n, d, k, jdt, tdt,
                                           seed=5 * n + d + k)
    tol, tight = _tols(jdt)
    kw = {} if budget is None else {"acc_budget": budget}
    for cvj, cvt in ((None, None), (vj, vt)):
        s_r, c_r, cost_r = fused_assign_reduce_chunked_pallas(
            xj, wj, cj, cvj, interpret=True, **kw)
        s_o, c_o, cost_o = ops.fused_assign_reduce(xt, wt, ct, cvt)
        np.testing.assert_allclose(s_o.numpy(), s_r, rtol=tol, atol=tol)
        np.testing.assert_allclose(c_o.numpy(), c_r, rtol=tight, atol=tight)
        np.testing.assert_allclose(float(cost_o), float(cost_r), rtol=tol,
                                   atol=tol)
        if cvt is not None:
            assert float(c_o[~cvt].abs().sum()) == 0.0


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "mask"])
def test_min_dist_walks_center_panels(masked):
    """Beyond 4096 centers the plain min_dist walks center panels with a
    running (min, argmin), as the reference's oracle does: the same d2, and
    on exact ties across panels the first index."""
    rng = np.random.default_rng(16)
    n, d, k = 60, 6, 9000
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    c[[5000, 8500]] = c[10]                  # one center, in three panels
    c[4096] = c[4095]                        # a tie across a panel edge
    x[:5] = c[10]
    x[5:8] = c[4095]
    valid = rng.random(k) > 0.2
    valid[[10, 4095, 4096, 5000, 8500]] = True
    cv = valid if masked else None
    d2_r, idx_r = jref.min_dist_ref(jnp.asarray(x), jnp.asarray(c),
                                    None if cv is None else jnp.asarray(cv))
    d2_o, idx_o = ops.min_dist(torch.from_numpy(x), torch.from_numpy(c),
                               None if cv is None else torch.from_numpy(cv))
    np.testing.assert_allclose(d2_o.numpy(), d2_r, rtol=2e-3, atol=2e-3)
    assert idx_o[:5].tolist() == np.asarray(idx_r)[:5].tolist() == [10] * 5
    assert idx_o[5:8].tolist() == np.asarray(idx_r)[5:8].tolist() == [4095] * 3
    d2_at = ((torch.from_numpy(x) - torch.from_numpy(c)[idx_o.long()]) ** 2
             ).sum(-1)
    np.testing.assert_allclose(d2_at.numpy(), d2_r, rtol=2e-3, atol=2e-3)
    if masked:
        assert bool(torch.from_numpy(cv)[idx_o.long()].all())


@pytest.mark.parametrize("name,n,d,k", POINT_SHAPES + WIDE_SHAPES,
                         ids=WIDE_IDS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_update_min_dist_matches_reference(name, n, d, k, jdt, tdt):
    kc = min(k, 37)                       # the new-center block is small
    xj, wj, cj, vj, xt, wt, ct, vt = _data(n, d, kc, jdt, tdt,
                                           seed=4 * n + d + k)
    d2 = (np.random.default_rng(5 * n + d).random(n) * d).astype(np.float32)
    tol, _ = _tols(jdt)
    for cvj, cvt in ((None, None), (vj, vt)):
        d2_r, m_r = jref.update_min_dist_ref(xj, wj, cj, jnp.asarray(d2), cvj)
        d2_o, m_o = ops.update_min_dist(xt, wt, ct, torch.from_numpy(d2), cvt)
        np.testing.assert_allclose(d2_o.numpy(), d2_r, rtol=tol, atol=tol)
        np.testing.assert_allclose(float(m_o), float(m_r), rtol=tol)
        assert bool((d2_o <= torch.from_numpy(d2) + 1e-6).all())


@pytest.mark.parametrize("name,n,d,k", POINT_SHAPES + WIDE_SHAPES,
                         ids=WIDE_IDS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_seeding_step_d2_matches_reference(name, n, d, k, jdt, tdt):
    """The plain seeding step's d2 (the D² update against the row drawn
    last) against the JAX oracle ``update_min_dist_ref`` with that row as
    the one-center block, on the same inputs, with ``_tols``; the step's
    w keys do not depend on d2, its D² keys are the Gumbel keys of w·d2."""
    xj, wj, _, _, xt, wt, _, _ = _data(n, d, 1, jdt, tdt, seed=7 * n + d + k)
    rng = np.random.default_rng(3 * n + d)
    d2 = (rng.random(n) * d).astype(np.float32)
    prev = int(rng.integers(n))
    tol, _ = _tols(jdt)
    g = tref.seed_gumbel(torch.tensor([5, 7]), n, range(1, 2))[0]
    d2_o, key_d2, key_w = tref.kmeans_pp_step_ref(
        xt, wt, torch.from_numpy(d2), torch.tensor(prev), g)
    d2_r, _ = jref.update_min_dist_ref(xj, wj, xj[prev:prev + 1].astype(
        jnp.float32), jnp.asarray(d2))
    np.testing.assert_allclose(d2_o.numpy(), d2_r, rtol=tol, atol=tol)
    assert float(d2_o[prev]) <= tol              # the center's own row
    assert torch.equal(key_d2, tref.gumbel_keys(wt.float() * d2_o, g))
    assert torch.equal(key_w, tref.gumbel_keys(wt.float(), g))


def _assign(n, k, seed):
    """An (n,) int32 assignment over [0, k) with a few entries outside it
    (-1 and k), which add nothing."""
    a = np.random.default_rng(seed).integers(0, k, size=n).astype(np.int32)
    a[1::17] = -1
    a[2::19] = k
    return a


@pytest.mark.parametrize("name,n,d,k", POINT_SHAPES, ids=IDS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_lloyd_reduce_matches_reference(name, n, d, k, jdt, tdt):
    xj, wj, _, _, xt, wt, _, _ = _data(n, d, k, jdt, tdt, seed=6 * n + d + k)
    a = _assign(n, k, seed=n + k)
    tol, tight = _tols(jdt)
    s_r, c_r = jref.lloyd_reduce_ref(xj, wj, jnp.asarray(a), k)
    s_o, c_o = ops.lloyd_reduce(xt, wt, torch.from_numpy(a), k)
    assert s_o.shape == (k, d) and c_o.shape == (k,)
    assert s_o.dtype == c_o.dtype == torch.float32
    np.testing.assert_allclose(s_o.numpy(), s_r, rtol=tol, atol=tol)
    np.testing.assert_allclose(c_o.numpy(), c_r, rtol=tight, atol=tight)


def test_lloyd_reduce_segment_sum_beyond_panel():
    """Beyond 4096 centers the plain version scatter-adds, as the
    reference's oracle switches to a segment sum (ref.py:219-225)."""
    xj, wj, _, _, xt, wt, _, _ = _data(300, 6, 1, jnp.float32, torch.float32,
                                       seed=12)
    k = 5000
    a = _assign(300, k, seed=13)
    s_r, c_r = jref.lloyd_reduce_ref(xj, wj, jnp.asarray(a), k)
    s_o, c_o = ops.lloyd_reduce(xt, wt, torch.from_numpy(a), k)
    np.testing.assert_allclose(s_o.numpy(), s_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c_o.numpy(), c_r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_lloyd_plain_matches_lloyd_pallas(jdt, tdt):
    """The lloyd_reduce kernel's plain version against the reference's
    Pallas kernel in interpret mode (a ragged last block of points)."""
    from repro.kernels.lloyd import lloyd_reduce_pallas
    n, d, k = 300, 8, 5
    xj, wj, _, _, xt, wt, _, _ = _data(n, d, k, jdt, tdt, seed=14)
    a = _assign(n, k, seed=15)
    tol, tight = _tols(jdt)
    s_r, c_r = lloyd_reduce_pallas(xj, wj, jnp.asarray(a), k, interpret=True)
    s_o, c_o = ops.lloyd_reduce(xt, wt, torch.from_numpy(a), k)
    np.testing.assert_allclose(s_o.numpy(), s_r, rtol=tol, atol=tol)
    np.testing.assert_allclose(c_o.numpy(), c_r, rtol=tight, atol=tight)


@pytest.mark.parametrize("name,n,d,k", POINT_SHAPES, ids=IDS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_sensitivity_scores_matches_reference(name, n, d, k, jdt, tdt):
    xj, wj, cj, vj, xt, wt, ct, vt = _data(n, d, k, jdt, tdt,
                                           seed=7 * n + d + k)
    tol, tight = _tols(jdt)
    for cvj, cvt in ((None, None), (vj, vt)):
        sc_r, _, m_r, cost_r = jref.sensitivity_scores_ref(xj, wj, cj, cvj)
        sc_o, a_o, m_o, cost_o = ops.sensitivity_scores(xt, wt, ct, cvt)
        assert a_o.dtype == torch.int32 and sc_o.dtype == torch.float32
        np.testing.assert_allclose(sc_o.numpy(), sc_r, rtol=tol, atol=tol)
        np.testing.assert_allclose(float(cost_o), float(cost_r), rtol=tol,
                                   atol=tol)
        # argmin ties may break differently: the mass follows the port's
        # own assignment, and its total is the reference's
        np.testing.assert_allclose(
            m_o.numpy(), np.bincount(a_o.numpy(), weights=wt.numpy(),
                                     minlength=k), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(m_o.sum()), float(m_r.sum()),
                                   rtol=tight, atol=tight)
        if cvt is not None:               # invalid centers receive no mass
            assert float(m_o[~cvt].abs().sum()) == 0.0


def _threshold(d2: np.ndarray) -> float:
    """A v strictly between two data d2 values near the median: the
    frameworks sum the distance terms in different orders, so a v equal to
    a point's d2 could move it across by one ulp."""
    s = np.sort(d2)
    return float(0.5 * (s[len(s) // 2] + s[len(s) // 2 + 1]))


@pytest.mark.parametrize("name,n,d,k", POINT_SHAPES, ids=IDS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_truncated_cost_matches_reference(name, n, d, k, jdt, tdt):
    xj, wj, cj, vj, xt, wt, ct, vt = _data(n, d, k, jdt, tdt,
                                           seed=8 * n + d + k)
    tol, _ = _tols(jdt)
    for cvj, cvt in ((None, None), (vj, vt)):
        d2, _ = jref.min_dist_ref(xj, cj, cvj)
        v = _threshold(np.asarray(d2))
        for vv in (v, 0.0, float(np.max(d2)) + 1.0):
            r = jref.truncated_cost_ref(xj, wj, cj, jnp.float32(vv), cvj)
            o = ops.truncated_cost(xt, wt, ct, torch.tensor(vv), cvt)
            assert all(t.shape == () for t in o)
            np.testing.assert_allclose([float(t) for t in o],
                                       [float(t) for t in r], rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("name,m,p,d,k", MP_SHAPES, ids=MP_IDS)
def test_truncated_cost_per_machine(name, m, p, d, k):
    """(m, p, d) shards give one triple a machine, each the reference's
    (n, d) triple of that machine's rows (kzmeans psums them)."""
    xj, wj, cj, _, xt, wt, ct, _ = _data(m * p, d, k, jnp.float32,
                                         torch.float32, seed=m + p + k)
    d2, _ = jref.min_dist_ref(xj, cj)
    v = _threshold(np.asarray(d2))
    o = ops.truncated_cost(xt.reshape(m, p, d), wt.reshape(m, p), ct,
                           torch.tensor(v))
    assert all(t.shape == (m,) for t in o)
    for j in range(m):
        r = jref.truncated_cost_ref(xj[j * p:(j + 1) * p],
                                    wj[j * p:(j + 1) * p], cj,
                                    jnp.float32(v))
        np.testing.assert_allclose([float(t[j]) for t in o],
                                   [float(t) for t in r], rtol=2e-3,
                                   atol=2e-3)


def test_truncated_cost_sides():
    """``<= v`` is kept (inclusive), ``> v`` is the tail, and a row of
    weight 0 falls on neither side, wherever its distance lands."""
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [9.0, 0.0]])
    w = torch.tensor([1.0, 2.0, 3.0, 0.0])
    kept, tmass, tcost = ops.truncated_cost(x, w, torch.zeros((1, 2)),
                                            torch.tensor(1.0))
    assert (float(kept), float(tmass), float(tcost)) == (2.0, 3.0, 12.0)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_remove_below_beyond_resident(jdt, tdt):
    """remove_below at 1,100 centers (beyond the resident limit, as SOCCER's
    k_plus at k = 1000) against the reference's chunked Pallas kernel in
    interpret mode: the same removal set but for points whose d2 lies
    within the tolerance of v, where the frameworks' summation orders may
    decide differently."""
    from repro.kernels.fused_lloyd import remove_below_chunked_pallas
    m, p, d, k = 2, 60, 9, 1100
    rng = np.random.default_rng(17)
    xj, xt = _both(rng.normal(size=(m, p, d)).astype(np.float32), jdt, tdt)
    cj, ct = _both(rng.normal(size=(k, d)).astype(np.float32), jdt, tdt)
    valid = rng.random(k) > 0.3
    valid[0] = True
    alive = rng.random((m, p)) > 0.25
    tol, _ = _tols(jdt)
    for cvj, cvt in ((None, None), (jnp.asarray(valid),
                                     torch.from_numpy(valid))):
        d2, _ = jref.min_dist_ref(xj.reshape(m * p, d), cj, cvj)
        d2 = np.asarray(d2).reshape(m, p)
        v = float(np.median(d2))
        a_r, l_r = remove_below_chunked_pallas(
            xj, cj, jnp.asarray(alive), jnp.float32(v), cvj, interpret=True)
        a_o, l_o = ops.remove_below(xt, ct, torch.from_numpy(alive),
                                    torch.tensor(v), cvt)
        flips = a_o.numpy() != np.asarray(a_r)
        assert np.all(np.abs(d2[flips] - v) <= tol * max(1.0, abs(v)))
        np.testing.assert_array_equal(l_o.numpy(),
                                      a_o.numpy().sum(1).astype(np.int32))
        assert abs(int(l_o.sum()) - int(np.asarray(l_r).sum())) \
            <= int(flips.sum())


@pytest.mark.parametrize("name,m,p,d,k", MP_SHAPES, ids=MP_IDS)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_remove_below_matches_reference(name, m, p, d, k, jdt, tdt):
    rng = np.random.default_rng(m + p + d + k)
    xj, xt = _both(rng.normal(size=(m, p, d)).astype(np.float32), jdt, tdt)
    cj, ct = _both(rng.normal(size=(k, d)).astype(np.float32), jdt, tdt)
    alive = rng.random((m, p)) > 0.25
    d2, _ = jref.min_dist_ref(xj.reshape(m * p, d), cj)
    # thresholds strictly between data d2 values: the backends sum the
    # distance terms in different orders, so a v equal to a point's d2
    # could flip its keep bit by one ulp
    d2s = np.sort(np.asarray(d2))
    mid = 0.5 * (d2s[m * p // 2] + d2s[m * p // 2 + 1])
    for v in (0.0, float(mid), float(d2s[-1]) + 1.0):
        a_r, l_r = jref.remove_below_ref(xj, cj, jnp.asarray(alive),
                                         jnp.float32(v))
        a_o, l_o = ops.remove_below(xt, ct, torch.from_numpy(alive),
                                    torch.tensor(v, dtype=torch.float32))
        assert a_o.dtype == torch.bool and l_o.dtype == torch.int32
        np.testing.assert_array_equal(a_o.numpy(), np.asarray(a_r))
        np.testing.assert_array_equal(l_o.numpy(), np.asarray(l_r))


def test_remove_below_is_strict():
    """A point exactly at v is removed (keep iff d2 > v), as ref.py."""
    x = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]]])
    c = torch.zeros((1, 2))
    alive = torch.ones((1, 3), dtype=torch.bool)
    a, live = ops.remove_below(x, c, alive, torch.tensor(1.0))
    assert a.tolist() == [[False, False, True]] and live.tolist() == [1]


# ---- the Lloyd kernel's fixed-point sums --------------------------------
#
# On the card fused_assign_reduce adds each term w·x_q as an int64 at scale
# 2^s; ref.fixed_point_reduce_ref is that arithmetic in PyTorch, the exact
# oracle chip_smoke.py and tests/test_torch_cuda.py hold the kernel to.

def _ht_rows(n, d, k, seed, jdt, tdt):
    """SOCCER-like coordinator rows: a sample drawn from m machines of
    skewed sizes, each row weighted by n_local / c_j (Horvitz-Thompson:
    the machine's points over its sample count), so the weights span
    orders of magnitude; sigma = 0.001 clusters in the unit cube."""
    rng = np.random.default_rng(seed)
    m = 8
    local = np.round(1.25e6 * np.logspace(0, -3, m)).astype(np.int64)
    share = rng.multinomial(n, np.full(m, 1 / m))     # rows a machine
    w = np.concatenate([np.full(c, local[j] / max(c, 1), np.float32)
                        for j, c in enumerate(share)])
    means = rng.random((k, d)).astype(np.float32)
    x = (means[rng.integers(0, k, n)]
         + 1e-3 * rng.normal(size=(n, d))).astype(np.float32)
    xj, xt = _both(x, jdt, tdt)
    cj, ct = _both(means + 2e-3 * rng.normal(size=(k, d)).astype(np.float32),
                   jdt, tdt)
    return xj, jnp.asarray(w), cj, xt, torch.from_numpy(w), ct


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_fixed_point_sums_ignore_row_order(jdt, tdt):
    """Integer sums are exact: any order of the rows gives the same bits."""
    _, _, _, xt, wt, _ = _ht_rows(4000, 15, 30, 20, jdt, tdt)
    a = torch.from_numpy(_assign(4000, 30, seed=21))
    s, c = tref.fixed_point_reduce_ref(xt, wt, a, 30)
    for seed in (22, 23):
        p = torch.from_numpy(np.random.default_rng(seed).permutation(4000))
        s2, c2 = tref.fixed_point_reduce_ref(xt[p], wt[p], a[p], 30)
        assert torch.equal(s, s2) and torch.equal(c, c2)


@pytest.mark.parametrize("k", [25, 1111], ids=["bicriteria", "k1111"])
def test_exact_masses_match_sensitivity_pallas(k):
    """The card's sensitivity masses are exact_index_add(w, argmin, k) bit
    for bit; over the reference Pallas kernel's own argmin (interpret
    mode) they hold its masses to the f32 tolerance, at the coreset path's
    25 centers and at SOCCER k = 1000's 1,111, past the TPU's resident
    limit of 1,024."""
    from repro.kernels.sensitivity import sensitivity_scores_pallas
    n, d = 600, 15
    xj, wj, cj, vj, _, wt, _, _ = _data(n, d, k, jnp.float32, torch.float32,
                                        seed=40 + k)
    _, tight = _tols(jnp.float32)
    for cvj in (None, vj):
        _, a_r, m_r, _ = sensitivity_scores_pallas(xj, wj, cj, cvj,
                                                   interpret=True)
        a = torch.from_numpy(np.asarray(a_r).astype(np.int64))
        m = exact.exact_index_add(wt, a, k)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_r), rtol=tight,
                                   atol=tight)
        if cvj is not None:               # invalid centers receive no mass
            assert float(m[~torch.from_numpy(np.array(cvj))].abs().sum()
                         ) == 0.0


# ---- the exact float sums (kernels/exact.py) ----------------------------

def _signed_heavy(n, seed):
    """(n,) float32 values over several orders of magnitude, both signs."""
    rng = np.random.default_rng(seed)
    v = rng.pareto(1.5, n) * rng.choice([-1.0, 1.0], n)
    return torch.from_numpy(v.astype(np.float32))


def test_exact_index_add_ignores_row_order():
    """Integer sums are exact: any order of the terms gives the same bits,
    which a float index_add_ on the card does not."""
    v = _signed_heavy(5000, 26)
    a = torch.from_numpy(np.random.default_rng(27).integers(0, 40, 5000))
    s = exact.exact_index_add(v, a, 40)
    for seed in (28, 29):
        p = torch.from_numpy(np.random.default_rng(seed).permutation(5000))
        assert torch.equal(s, exact.exact_index_add(v[p], a[p], 40))


@pytest.mark.parametrize("fn", ["cumsum", "index_add"])
def test_exact_sums_within_their_rounding(fn):
    """Against float64 sums of the same terms: within n·2^-(s+1) (one
    rounding of each term), the float64 sum's own error and float32's
    half ulp of the result; the shift is the largest with
    n·max|v|·2^s < 2^62. Empty and all-zero inputs give zeros."""
    n = 4000
    v = _signed_heavy(n, 30)
    vd = v.double()
    s = 62 - np.frexp(float(vd.abs().max()) * n)[1]
    if fn == "cumsum":
        got, want = exact.exact_cumsum(v), torch.cumsum(vd, 0)
        empty = exact.exact_cumsum(torch.zeros(0))
        zero = exact.exact_cumsum(torch.zeros(7))
    else:
        a = torch.from_numpy(np.random.default_rng(31).integers(0, 25, n))
        got = exact.exact_index_add(v, a, 25)
        want = torch.zeros(25, dtype=torch.float64).index_add_(0, a, vd)
        empty = exact.exact_index_add(torch.zeros(0), a[:0], 3)
        zero = exact.exact_index_add(torch.zeros(7), a[:7], 25)
    assert got.dtype == torch.float32
    bound = (n * 2.0 ** -(s + 1) + n * 2.0 ** -53 * float(vd.abs().sum())
             + 2.0 ** -24 * want.abs())
    assert bool(((got.double() - want).abs() <= bound).all())
    assert not bool(empty.any()) and not bool(zero.any())


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_fixed_point_sums_within_their_rounding(jdt, tdt):
    """Each center's sum lies within n_j·2^-(s+1) (one rounding of each
    of its n_j terms) plus float32's half ulp of a float64 index_add; the
    shift is the largest with n·max|w|·max|x|·2^s < 2^62."""
    n, d, k = 3000, 9, 12
    _, _, _, xt, wt, _ = _ht_rows(n, d, k, 24, jdt, tdt)
    wt[::7] = 0.0
    a = torch.from_numpy(_assign(n, k, seed=25))
    s, c = tref.fixed_point_reduce_ref(xt, wt, a, k)
    mw = float(wt.abs().max())
    mx = float(xt.float()[wt != 0].abs().max())
    sx = tref.fixed_shift(n * mw * mx)
    sw = tref.fixed_shift(n * mw)
    assert 2.0 ** 61 <= n * mw * mx * 2.0 ** sx < 2.0 ** 62
    assert 2.0 ** 61 <= n * mw * 2.0 ** sw < 2.0 ** 62
    ok = (a >= 0) & (a < k)
    al, wd = a[ok].long(), wt[ok].double()
    s64 = torch.zeros((k, d), dtype=torch.float64).index_add_(
        0, al, wd[:, None] * xt[ok].double()).numpy()
    c64 = torch.zeros(k, dtype=torch.float64).index_add_(0, al, wd).numpy()
    nj = np.bincount(al.numpy(), minlength=k).astype(np.float64)
    half_ulp = lambda v: 0.5 * np.spacing(np.abs(v).astype(np.float32))
    assert np.all(np.abs(s.double().numpy() - s64)
                  <= nj[:, None] * 2.0 ** -(sx + 1) + half_ulp(s64) + 1e-30)
    assert np.all(np.abs(c.double().numpy() - c64)
                  <= nj * 2.0 ** -(sw + 1) + half_ulp(c64) + 1e-30)


@pytest.mark.parametrize("k", [25, 103, 1024], ids=["k25", "k103", "k1024"])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DT_IDS)
def test_fixed_point_sums_match_reference_under_ht_weights(k, jdt, tdt):
    """Under SOCCER's skewed Horvitz-Thompson weights the fixed-point sums
    over the reference's own assignment agree with the reference's
    fused_assign_reduce oracle to _tols: the scale taken from max|w| keeps
    the light rows' terms (weights ~1e3 times smaller) far above its
    resolution."""
    xj, wj, cj, xt, wt, ct = _ht_rows(2500, 15, k, 26 + k, jdt, tdt)
    tol, tight = _tols(jdt)
    s_r, c_r, _ = jref.fused_assign_reduce_ref(xj, wj, cj)
    _, idx_r = jref.min_dist_ref(xj, cj)
    s_o, c_o = tref.fixed_point_reduce_ref(
        xt, wt, torch.from_numpy(np.asarray(idx_r).astype(np.int32)), k)
    scale = float(np.max(np.asarray(c_r)))
    np.testing.assert_allclose(s_o.numpy(), s_r, rtol=tol,
                               atol=tol * scale)
    np.testing.assert_allclose(c_o.numpy(), c_r, rtol=tight,
                               atol=tight * scale)


def test_lloyd_launch_shape_rules():
    """The CUDA wrapper's launch shape, decided on the host: 4 points a
    thread where the walk dominates, 2 with few centers, the tiled walk's
    at d > 16; warp accumulators up to 1,024 entries; the center axis
    split only when the point tiles cannot fill the card, into slices of
    >= 512 centers that fill the last wave; one scratch buffer laid out as
    the kernel's."""
    assert tfused.points_per_thread(831, 15) == 4
    assert tfused.points_per_thread(25, 15) == 2
    assert tfused.points_per_thread(831, 37) == twalk.TILED_PPT
    assert tfused.acc_mode(63, 15) == "warp"
    assert tfused.acc_mode(65, 15) == "global"
    # lloyd_reduce takes the same rule (kzmeans' k = 25: 400 entries) and
    # a scratch of its accumulators and the bound; sensitivity_scores'
    # masses are one column (d = 0), warp rows up to 1,024 centers
    assert tlloyd.acc_mode is tfused.acc_mode
    assert tfused.acc_mode(25, 15) == "warp"
    assert tfused.acc_mode(1025, 15) == "global"
    assert tlloyd.scratch_bytes(25, 15) == (25 * 16 + 1) * 8
    assert tfused.acc_mode(1024, 0) == "warp"
    assert tfused.acc_mode(1025, 0) == "global"
    # EIM11's clustering on 132 SMs: 64 tiles of 1,024 points, 10 slices
    assert twalk.point_tiles(65_536, 4) == 64
    s = twalk.center_slices(65_536, 173_256, 132, 4)
    assert s == 10 and 173_256 // s >= twalk.MIN_SLICE
    # the weighing shapes and SOCCER's coordinator fill the card unsplit
    assert twalk.center_slices(1_250_000, 831, 132, 4) == 1
    assert twalk.center_slices(991_418, 1_111, 132, 4) == 1
    # too few centers to split
    assert twalk.center_slices(3_000, 1_000, 132, 4) == 1
    assert twalk.center_slices(3_000, 2_100, 132, 4) == 4
    # truncated_cost over 8 machines: kzmeans' 1.275 M points a machine
    # and 8 × 125,000 at 1,111 centers fill the card unsplit (984 tiles;
    # one machine's 123 alone would split); 8 × 12,501 splits in two
    assert ttrunc.launch_shape(8, 1_275_000, 15, 25, 132) == (4, 1246, 1)
    assert ttrunc.launch_shape(8, 125_000, 15, 1_111, 132) == (4, 123, 1)
    assert twalk.center_slices(125_000, 1_111, 132, 4) == 2
    assert ttrunc.launch_shape(8, 12_501, 15, 1_111, 132) == (4, 13, 2)
    for n, d, k, p, sl in ((65_536, 15, 173_256, 4, 10), (0, 15, 3, 2, 1),
                           (3_000, 16, 2_100, 2, 4)):
        tiles = twalk.point_tiles(n, p)
        ws = 2 * (-(-sl * n * 4 // 8) * 8) if sl > 1 else 0
        assert tfused.scratch_bytes(n, d, k, p, sl) == (
            k * (d + 1) * 8 + 8 + 2 * (-(-tiles * 4 // 8) * 8) + ws)


@pytest.mark.parametrize("n,d,k,ppt,slices", [
    (17_353, 15, 103, 4, 1),        # SOCCER's coordinator: launch-bound
    (1_250_000, 15, 3_081, 4, 1),   # k-means‖'s weighing fills the card
    (1_000_000, 15, 86_628, 4, 1),  # EIM11's largest sweep of x
    (14_438, 15, 86_628, 4, 44),    # EIM11's largest s2 sweep: 15 tiles
    (20_000, 15, 4_096, 4, 8),      # n <= 20,000, k >= 4,096
    (20_000, 37, 4_096, 2, 8),      # any width: 2 points a thread
    (3_000, 513, 1_023, 2, 1),      # too few centers for two slices
], ids=["coordinator", "weighing", "eim11_x", "eim11_s2", "split",
        "split_any_width", "one_slice_small_k"])
def test_walk_launch_shape_rules(n, d, k, ppt, slices):
    """The register-blocked walk's launch shape (kernels/walk.py:
    min_dist's and the Lloyd step's at d <= 16, remove_below's,
    sensitivity_scores' and truncated_cost's at every d): 4 points a
    thread at d <= 16, else 2; the center axis split into slices of
    >= 512 centers only when the point tiles cannot reach 4 blocks an SM
    of 132, filling the last wave (or into as many slices as k allows);
    the split scratch holds the tile counters and the (slices, n) best
    and arg, and nothing with one slice."""
    assert twalk.points_per_thread(d) == ppt
    got = twalk.center_slices(n, k, 132, ppt)
    assert got == slices
    tiles = twalk.point_tiles(n, ppt)
    assert tiles == max(-(-n // (256 * ppt)), 1)
    if slices == 1:
        assert tiles >= twalk.FILL_PER_SM * 132 or k < 2 * twalk.MIN_SLICE
        assert twalk.split_scratch_bytes(n, ppt, slices) == 0
    else:
        assert -(-k // slices) >= twalk.MIN_SLICE
        # enough blocks to fill the card, or as many slices as k allows
        assert (tiles * slices >= twalk.FILL_PER_SM * 132
                or slices == k // twalk.MIN_SLICE)
        assert twalk.split_scratch_bytes(n, ppt, slices) == (
            -(-tiles * 4 // 8) * 8 + 2 * (-(-slices * n * 4 // 8) * 8))
    # the Lloyd step beyond its warp accumulators takes the same shape at
    # d <= 16, and the tiled walk's past it
    if k * (d + 1) > tfused.WARP_ACC_ENTRIES:
        assert tfused.points_per_thread(k, d) == (
            twalk.TILED_PPT if twalk.tiled(d) else ppt)
    # truncated_cost: one machine of n points takes min_dist's shape; its
    # scratch is the (3, tiles) partials, then min_dist's split scratch
    # less the argmin (truncated_cost keeps none)
    assert ttrunc.launch_shape(1, n, d, k, 132) == (ppt, tiles, slices)
    assert ttrunc.scratch_bytes(1, n, ppt, slices) == (
        -(-3 * tiles * 4 // 8) * 8
        + twalk.split_scratch_bytes(n, ppt, slices)
        - (-(-slices * n * 4 // 8) * 8 if slices > 1 else 0))
    # over 8 machines of n/8 points the slices come from the tiles of
    # every machine (a tile never straddles two), the scratch holds each
    # machine's partials, counters and (slices, p) best
    pm = -(-n // 8)
    ppt8, tm, got8 = ttrunc.launch_shape(8, pm, d, k, 132)
    assert (ppt8, tm) == (ppt, twalk.point_tiles(pm, ppt))
    assert got8 == twalk.slices_for_tiles(8 * tm, k, 132)
    assert (got8 == 1) == (8 * tm >= twalk.FILL_PER_SM * 132
                           or k < 2 * twalk.MIN_SLICE)
    ws = -(-got8 * 8 * pm * 4 // 8) * 8 if got8 > 1 else 0
    assert ttrunc.scratch_bytes(8, pm, ppt, got8) == (
        -(-8 * 3 * tm * 4 // 8) * 8
        + ((-(-8 * tm * 4 // 8) * 8) if got8 > 1 else 0) + ws)


# ---- degenerate cases --------------------------------------------------

def test_all_invalid_centers():
    """Zero valid centers: +inf distances and index 0 (the reference's
    oracle, not the Pallas sentinel), removal keeps the mask, the seeding
    update is an exact no-op."""
    xj, wj, cj, _, xt, wt, ct, _ = _data(90, 11, 40, jnp.float32,
                                         torch.float32, seed=7)
    none_j, none_t = jnp.zeros((40,), bool), torch.zeros(40, dtype=torch.bool)
    d2_o, idx_o = ops.min_dist(xt, ct, none_t)
    d2_r, idx_r = jref.min_dist_ref(xj, cj, none_j)
    assert bool(torch.isinf(d2_o).all()) and np.isinf(np.asarray(d2_r)).all()
    assert idx_o.tolist() == np.asarray(idx_r).tolist() == [0] * 90

    _, counts, _ = ops.fused_assign_reduce(xt, wt, ct, none_t)
    np.testing.assert_allclose(float(counts.sum()), float(wt.sum()),
                               rtol=1e-5)

    alive = torch.from_numpy(np.random.default_rng(8).random((2, 45)) > 0.4)
    a_o, l_o = ops.remove_below(xt.reshape(2, 45, 11), ct, alive,
                                torch.tensor(1e6), none_t)
    assert torch.equal(a_o, alive)
    assert torch.equal(l_o, alive.sum(1, dtype=torch.int32))

    d2 = torch.from_numpy(np.random.default_rng(9).random(90).astype(
        np.float32))
    d2_o, mass_o = ops.update_min_dist(xt, wt, ct[:5], d2,
                                       torch.zeros(5, dtype=torch.bool))
    assert torch.equal(d2_o, d2)
    np.testing.assert_allclose(float(mass_o), float((wt * d2).sum()),
                               rtol=1e-6)

    # outside the reference's contract for these two (ops.py:213-215,
    # 243-245); the port follows ref.py: +inf distances, all mass on
    # center 0, every weighted row in the tail
    sc, a, mass, cost = ops.sensitivity_scores(xt, wt, ct, none_t)
    sc_r, a_r, mass_r, _ = jref.sensitivity_scores_ref(xj, wj, cj, none_j)
    assert a.tolist() == np.asarray(a_r).tolist() == [0] * 90
    np.testing.assert_array_equal(mass.numpy(), np.asarray(mass_r))
    pos = wt > 0
    assert bool(torch.isinf(sc[pos]).all()) and bool(
        torch.isnan(sc[~pos]).all()) and bool(torch.isnan(cost))
    assert np.array_equal(np.isnan(sc.numpy()), np.isnan(np.asarray(sc_r)))
    kept, tmass, tcost = ops.truncated_cost(xt, wt, ct, torch.tensor(1e6),
                                            none_t)
    assert float(kept) == 0.0 and bool(torch.isinf(tcost))
    np.testing.assert_allclose(float(tmass), float(wt.sum()), rtol=1e-6)


def test_all_zero_weights():
    """All-zero weights: reductions and masses are exactly zero."""
    _, _, _, _, xt, _, ct, _ = _data(90, 11, 40, jnp.float32, torch.float32,
                                     seed=10)
    w0 = torch.zeros(90)
    sums, counts, cost = ops.fused_assign_reduce(xt, w0, ct)
    assert float(sums.abs().max()) == 0.0
    assert float(counts.abs().max()) == 0.0 and float(cost) == 0.0
    d2 = torch.rand(90, generator=torch.Generator().manual_seed(11))
    _, mass = ops.update_min_dist(xt, w0, ct[:3], d2)
    assert float(mass) == 0.0
    a = torch.from_numpy(_assign(90, 40, seed=11))
    assert all(float(t.abs().max()) == 0.0
               for t in ops.lloyd_reduce(xt, w0, a, 40))
    sc, _, m, cost = ops.sensitivity_scores(xt, w0, ct)
    assert float(sc.abs().max()) == float(m.abs().max()) == float(cost) == 0
    assert all(float(t) == 0.0 for t in ops.truncated_cost(
        xt, w0, ct, torch.tensor(0.5)))


# ---- dispatch ------------------------------------------------------------

def test_dispatch_rejects_other_devices():
    x, c = torch.zeros((4, 3), device="meta"), torch.zeros((2, 3))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.min_dist(x, c)


@pytest.mark.parametrize("wrapper,args", [
    (tmin.min_dist_cuda, lambda x, c: (x, c)),
    (tfused.update_min_dist_cuda, lambda x, c: (x, torch.ones(6), c,
                                                torch.ones(6))),
    (tfused.fused_assign_reduce_cuda, lambda x, c: (x, torch.ones(6), c)),
    (tfused.remove_below_cuda, lambda x, c: (
        x.reshape(2, 3, 4), c, torch.ones((2, 3), dtype=torch.bool), 0.5)),
    (tlloyd.lloyd_reduce_cuda, lambda x, c: (
        x, torch.ones(6), torch.zeros(6, dtype=torch.int32), 3)),
    (tsens.sensitivity_scores_cuda, lambda x, c: (x, torch.ones(6), c)),
    (ttrunc.truncated_cost_cuda, lambda x, c: (
        x.reshape(2, 3, 4), torch.ones((2, 3)), c, 0.5)),
    (tfused.kmeans_plusplus_indices_cuda, lambda x, c: (
        x, torch.ones(6), 3, torch.zeros(2, dtype=torch.int64))),
    (tfused.kmeans_pp_step_cuda, lambda x, c: (
        x, torch.ones(6), torch.zeros(6), None, 0,
        torch.zeros(2, dtype=torch.int64))),
], ids=["min_dist", "update_min_dist", "fused_assign_reduce",
        "remove_below", "lloyd_reduce", "sensitivity_scores",
        "truncated_cost", "kmeans_plusplus_indices", "kmeans_pp_step"])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, args):
    """A wrapper launches its kernel or raises: CPU tensors never reach a
    plain version through it, and no launch is counted."""
    before = {n: k.launches for n, k in ops.KERNELS.items()}
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args(torch.zeros((6, 4)), torch.zeros((3, 4))))
    assert before == {n: k.launches for n, k in ops.KERNELS.items()}


def test_wrappers_check_shapes():
    with pytest.raises(ValueError, match="centers"):
        tmin.min_dist_cuda(torch.zeros((6, 4)), torch.zeros((3, 5)))
    with pytest.raises(ValueError, match="alive"):
        tfused.remove_below_cuda(torch.zeros((2, 3, 4)), torch.zeros((3, 4)),
                                 torch.ones((2, 4), dtype=torch.bool), 0.5)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        build.dtype_code(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="assign"):
        tlloyd.lloyd_reduce_cuda(torch.zeros((6, 4)), torch.ones(6),
                                 torch.zeros(5, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="w must be"):
        ttrunc.truncated_cost_cuda(torch.zeros((2, 3, 4)), torch.ones(6),
                                   torch.zeros((3, 4)), 0.5)
    with pytest.raises(ValueError, match="seed must be"):
        tfused.kmeans_plusplus_indices_cuda(torch.zeros((6, 4)),
                                            torch.ones(6), 3,
                                            torch.zeros(2))
    with pytest.raises(ValueError, match="n < 2"):
        tfused.kmeans_plusplus_indices_cuda(
            torch.zeros((0, 4)), torch.ones(0), 3,
            torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("n,d,tiles", [
    (991_418, 15, 3_873), (17_353, 15, 68), (3_000, 37, 24),
    (3_000, 513, 24), (0, 15, 1), (43_106, 7_168, 337)])
def test_seed_tile_rule(n, d, tiles):
    """The seeding kernel's tiles (csrc/fused_lloyd.cu::seed_tile_rows):
    256 rows a tile on the register rows (d <= 16), the tiled walk's 128
    past them, whatever the point type; the draw-off wrapper sizes its
    per-tile partials by this count."""
    assert tfused.seed_tiles(n, d) == tiles


def test_build_is_keyed_on_sources():
    """Libraries are named by a hash of the sources and flags and land in
    the git-ignored build/ directory of the checkout."""
    for src in build.SOURCES:
        path = build.library_path(src)
        assert path.parent == build.BUILD_DIR
        assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
        assert build.source_hash(src) in path.name
        assert (build.CSRC / src).exists()
    assert build.source_hash("min_dist.cu") != build.source_hash(
        "fused_lloyd.cu")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_part_entry_points_equal_one_call(dt):
    """The part-by-part entry points over 3 parts of one point set (bases
    0, 300, 600) give the one-call entry points' results: the seeding's
    rows (the largest words over the parts are the one call's draw), and
    the Lloyd step's accumulators at the whole set's bound and row count
    (summed, they round to fixed_point_reduce_ref's sums over the
    set)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(900, 7)).astype(np.float32)).to(dt)
    w = torch.from_numpy(rng.random(900).astype(np.float32))
    w[100:180] = 0.0
    seed = torch.tensor([77, 91], dtype=torch.int64)
    parts = [(x[j:j + 300], w[j:j + 300], j) for j in (0, 300, 600)]
    d2s = [torch.full((300,), torch.inf) for _ in parts]
    center, drawn = None, []
    for step in range(12):
        words = []
        for i, (xp, wp, base) in enumerate(parts):
            d2s[i], wd = ops.kmeans_pp_step_at(xp, wp, d2s[i], center, step,
                                               seed, base)
            words.append(wd)
        win = tref.winner_from_words(tref.max_word(torch.stack(words), 0))
        drawn.append(win)
        center = x[win].float()
    np.testing.assert_array_equal(
        torch.stack(drawn).numpy(),
        ops.kmeans_plusplus_indices(x, w, 12, seed).numpy())
    c = x[torch.tensor([3, 350, 700, 820])].float()
    bound = torch.stack([ops.fixed_bound(xp, wp)
                         for xp, wp, _ in parts]).amax(0)
    acc = sum(ops.fused_assign_reduce_fixed(xp, wp, c, bound, 900)
              for xp, wp, _ in parts)
    sums, counts = exact.fixed_finalize(acc, bound, 900)
    _, assign = tref.min_dist_ref(x, c)
    want_s, want_c = tref.fixed_point_reduce_ref(x, w, assign, 4)
    assert torch.equal(sums, want_s) and torch.equal(counts, want_c)


def test_every_entry_point_covered():
    """Adding a port entry point without coverage here fails."""
    public = {name for name, fn in vars(ops).items()
              if callable(fn) and not name.startswith("_")
              and getattr(fn, "__module__", "") == ops.__name__}
    kernels = {"min_dist", "lloyd_reduce", "fused_assign_reduce",
               "remove_below", "update_min_dist", "sensitivity_scores",
               "truncated_cost"}
    covered = kernels | {"kmeans_plusplus_indices"}
    # a mesh rank's part-by-part steps: test_part_entry_points_equal_one_call
    parts = {"kmeans_pp_step_at", "fixed_bound", "fused_assign_reduce_fixed"}
    assert set(ops.ENTRY_POINTS) == covered
    assert set(ops.PART_ENTRY_POINTS) == parts
    assert public == covered | parts
    # the reference's seven, in its order, then the seeding loop (the
    # reference's lax.scan over update_min_dist; tests/test_torch_kmeans.py
    # holds it to its plain steps, and those to the JAX oracle below)
    from repro.kernels import ops as jops
    assert ops.ENTRY_POINTS[:7] == jops.ENTRY_POINTS
    assert ops.ENTRY_POINTS[7:] == ("kmeans_plusplus_indices",)
    # every kernel behind them has a launch counter, one kernel an entry
    # point (fused_assign_reduce's serves every number of centers; the
    # seeding runs update_min_dist's kernel and counts as its launches)
    assert set(ops.KERNELS) == kernels
    assert tfused.KMEANS_PP._counter is ops.KERNELS["update_min_dist"]

