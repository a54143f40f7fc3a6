"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only ``torch`` and ``repro_torch``, so it runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA card every kernel test skips; the last test, of one of
``chip_smoke.py``'s tolerances, runs anywhere. The full check at the main
path's shapes is ``chip_smoke.py``.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d,k", [(15, 103), (37, 300), (513, 190),
                                 (15, 1024)],
                         ids=["main_path", "any_width", "wide_d",
                              "two_tiles"])
def test_cuda_kernels_match_plain(d, k, dt):
    """Every kernel against its plain version, at the main path's d = 15
    (register rows, one center tile), at d = 37 and 513 (any width,
    several tiles) and at k = 1024 (two tiles). The tolerance is
    chip_smoke.py's: 32 float32 ulps of max ||x||^2 + max ||c||^2, the
    error of the expanded form in another summation order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    g = torch.Generator("cuda").manual_seed(0)
    n = 3000
    x = torch.rand((n, d), device="cuda", generator=g).to(dt)
    xf = x.float()
    c = torch.rand((k, d), device="cuda", generator=g)
    cv = torch.rand(k, device="cuda", generator=g) > 0.3
    cv[0] = True
    w = torch.rand(n, device="cuda", generator=g)
    tol = 32 * torch.finfo(torch.float32).eps * float(
        (xf * xf).sum(-1).max() + (c * c).sum(-1).max())

    d2, idx = ops.min_dist(x, c, cv)
    d2_p, _ = ref.min_dist_ref(x, c, cv)
    torch.testing.assert_close(d2, d2_p, rtol=0, atol=tol)
    ci = c[idx.long()]                   # argmin through the realized d2
    real = torch.clamp((xf * xf).sum(-1) - 2 * (xf * ci).sum(-1)
                       + (ci * ci).sum(-1), min=0)
    torch.testing.assert_close(real, d2_p, rtol=0, atol=2 * tol)
    assert bool(cv[idx.long()].all())

    # The other kernels share min_dist's distance code, so they assign
    # every point to the same center bit for bit: hold their reductions
    # to min_dist's own assignment.
    s, cnt, cost = ops.fused_assign_reduce(x, w, c, cv)
    cnt_p = torch.zeros(k, device="cuda").index_add_(0, idx.long(), w)
    s_p = torch.zeros((k, d), device="cuda").index_add_(0, idx.long(),
                                                        w[:, None] * xf)
    torch.testing.assert_close(cnt, cnt_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(cost, (w * d2).sum(), rtol=1e-5, atol=1e-5)

    u, mass = ops.update_min_dist(x, w, c, d2_p + 0.5, cv)
    u_p, mass_p = ref.update_min_dist_ref(x, w, c, d2_p + 0.5, cv)
    torch.testing.assert_close(u, u_p, rtol=0, atol=tol)
    torch.testing.assert_close(mass, mass_p, rtol=1e-5,
                               atol=tol * float(w.sum()))

    alive = torch.rand((3, n // 3), device="cuda", generator=g) > 0.1
    v = torch.median(d2)
    a, live = ops.remove_below(x.reshape(3, n // 3, d), c, alive, v, cv)
    assert torch.equal(a, alive & (d2.reshape(3, n // 3) > v))
    assert torch.equal(live, a.sum(1, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d,k", [(15, 4), (15, 25), (15, 103), (15, 1024),
                                 (9, 1025), (33, 2100), (15, 110_000)],
                         ids=["k4", "k25", "k103", "k1024", "k_over_max",
                              "k_chunked_multi", "two_walk_regime"])
def test_cuda_chunked_fused_matches_plain(d, k, dt):
    """The one Lloyd kernel at every k, few centers (warp accumulators)
    to far more than the 3,000 points' tiles can fill the card with (the
    center axis split, 110,000 centers is the TPU's two-walk regime): its
    argmin equals min_dist's, its sums and counts equal the fixed-point
    emulation over that argmin bit for bit, its cost is within 1e-5 of a
    float64 sum, and its cost and total count agree with the plain version
    (whose d2 may differ within the expanded form's tolerance, see
    test_cuda_kernels_match_plain); invalid centers get no mass, zero
    weights add nothing, and a second call gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch.kernels.fused_lloyd import fused_assign_reduce_cuda
    g = torch.Generator("cuda").manual_seed(1)
    n = 3000
    x = torch.rand((n, d), device="cuda", generator=g).to(dt)
    c = torch.rand((k, d), device="cuda", generator=g)
    cv = torch.rand(k, device="cuda", generator=g) > 0.3
    cv[0] = True
    w = torch.rand(n, device="cuda", generator=g)
    w[: n // 5] = 0.0
    xf = x.float()
    tol = 32 * torch.finfo(torch.float32).eps * float(
        (xf * xf).sum(-1).max() + (c * c).sum(-1).max())
    for mask in (None, cv):
        before = ops.KERNELS["fused_assign_reduce"].launches
        s, cnt, cost = ops.fused_assign_reduce(x, w, c, mask)
        assert ops.KERNELS["fused_assign_reduce"].launches == before + 1
        d2, idx = ops.min_dist(x, c, mask)
        own = torch.empty_like(idx)
        fused_assign_reduce_cuda(x, w, c, mask, assign_out=own)
        assert torch.equal(own, idx)
        s_e, cnt_e = ref.fixed_point_reduce_ref(x, w, idx, k)
        assert torch.equal(s, s_e) and torch.equal(cnt, cnt_e)
        torch.testing.assert_close(cost.double(), (w.double() * d2).sum(),
                                   rtol=1e-5, atol=0.0)
        _, cnt_r, cost_r = ref.fused_assign_reduce_ref(x, w, c, mask)
        torch.testing.assert_close(cost, cost_r, rtol=1e-5,
                                   atol=tol * float(w.sum()))
        torch.testing.assert_close(cnt.sum(), cnt_r.sum(), rtol=1e-5,
                                   atol=1e-3)
        if mask is not None:
            assert float(cnt[~mask].abs().sum()) == 0.0
        again = ops.fused_assign_reduce(x, w, c, mask)
        assert all(torch.equal(a, b) for a, b in zip((s, cnt, cost), again))
        zero = ops.fused_assign_reduce(x, torch.zeros_like(w), c, mask)
        assert all(float(t.abs().max()) == 0.0 for t in zero)


def _inputs(seed, n, d, k, dt):
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.rand((n, d), device="cuda", generator=g).to(dt)
    c = torch.rand((k, d), device="cuda", generator=g)
    cv = torch.rand(k, device="cuda", generator=g) > 0.3
    cv[0] = True
    w = torch.rand(n, device="cuda", generator=g)
    w[: n // 5] = 0.0
    return g, x, c, cv, w


def _d2_tol(x, c):
    xf = x.float()
    return 32 * torch.finfo(torch.float32).eps * float(
        (xf * xf).sum(-1).max() + (c * c).sum(-1).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d,k", [(15, 25), (37, 300), (15, 1025)],
                         ids=["kzmeans", "any_width", "fixed_point"])
def test_cuda_lloyd_reduce_matches_plain(d, k, dt):
    """lloyd_reduce (one kernel at every k: warp rows at kzmeans' k = 25,
    global accumulators at 37 × 300 and 15 × 1025) equals the fixed-point
    emulation bit for bit, and the Lloyd kernel's sums and counts given
    that kernel's own argmin; within 1e-5 of a float64 index_add over the
    same assignment and of its plain version. Assignments outside [0, k)
    add nothing, zero weights add nothing, a repeat call gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch.kernels.fused_lloyd import fused_assign_reduce_cuda
    n = 3000
    g, x, c, cv, w = _inputs(2, n, d, k, dt)
    assign = torch.randint(-1, k + 1, (n,), device="cuda", generator=g,
                           dtype=torch.int32)
    before = ops.KERNELS["lloyd_reduce"].launches
    s, cnt = ops.lloyd_reduce(x, w, assign, k)
    assert ops.KERNELS["lloyd_reduce"].launches == before + 1
    s_e, n_e = ref.fixed_point_reduce_ref(x, w, assign, k)
    assert torch.equal(s, s_e) and torch.equal(cnt, n_e)
    own = torch.empty(n, dtype=torch.int32, device="cuda")
    s_f, n_f, _ = fused_assign_reduce_cuda(x, w, c, cv, assign_out=own)
    s_o, n_o = ops.lloyd_reduce(x, w, own, k)
    assert torch.equal(s_o, s_f) and torch.equal(n_o, n_f)
    ok = (assign >= 0) & (assign < k)
    a = assign[ok].long()
    wd, xd = w[ok].double(), x[ok].double()
    s64 = torch.zeros((k, d), dtype=torch.float64, device="cuda"
                      ).index_add_(0, a, wd[:, None] * xd)
    n64 = torch.zeros(k, dtype=torch.float64, device="cuda"
                      ).index_add_(0, a, wd)
    torch.testing.assert_close(s.double(), s64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cnt.double(), n64, rtol=1e-5, atol=1e-5)
    s_p, n_p = ref.lloyd_reduce_ref(x, w, assign, k)
    torch.testing.assert_close(s, s_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(cnt, n_p, rtol=1e-5, atol=1e-4)
    again = ops.lloyd_reduce(x, w, assign, k)
    assert torch.equal(s, again[0]) and torch.equal(cnt, again[1])
    zero = ops.lloyd_reduce(x, torch.zeros_like(w), assign, k)
    assert all(float(t.abs().max()) == 0.0 for t in zero)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d,k", [(15, 25), (37, 300), (15, 1024),
                                 (15, 1111)],
                         ids=["bicriteria", "any_width", "two_tiles",
                              "soccer_k1000"])
def test_cuda_sensitivity_scores_matches_plain(d, k, dt):
    """sensitivity_scores (one kernel at every k) against min_dist's own d2
    and argmin (the kernels share the walk), its masses against
    exact_index_add over that argmin bit for bit, and against its plain
    version; invalid centers get no mass; a repeat call gives the same
    bits. At k = 1024 and 1111 the 3,000 points (3 tiles of 1,024) split
    the center axis over 2 slices; k = 1111 takes the global
    accumulators."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch.kernels.exact import exact_index_add
    _, x, c, cv, w = _inputs(3, 3000, d, k, dt)
    tol = _d2_tol(x, c)
    for mask in (None, cv):
        before = ops.KERNELS["sensitivity_scores"].launches
        sc, asg, mass, cost = ops.sensitivity_scores(x, w, c, mask)
        assert ops.KERNELS["sensitivity_scores"].launches == before + 1
        d2, idx = ops.min_dist(x, c, mask)
        assert torch.equal(asg, idx)
        assert torch.equal(sc, w * d2)
        assert torch.equal(mass, exact_index_add(w, idx, k))
        m64 = torch.zeros(k, dtype=torch.float64, device="cuda"
                          ).index_add_(0, idx.long(), w.double())
        torch.testing.assert_close(mass.double(), m64, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cost.double(), (w.double() * d2).sum(),
                                   rtol=1e-5, atol=1e-6)
        sc_p, _, mass_p, cost_p = ref.sensitivity_scores_ref(x, w, c, mask)
        torch.testing.assert_close(sc, sc_p, rtol=0, atol=tol)
        torch.testing.assert_close(cost, cost_p, rtol=1e-5,
                                   atol=tol * float(w.sum()))
        torch.testing.assert_close(mass.sum(), mass_p.sum(), rtol=1e-5,
                                   atol=1e-3)
        if mask is not None:
            assert float(mass[~mask].abs().sum()) == 0.0
        again = ops.sensitivity_scores(x, w, c, mask)
        assert all(torch.equal(a, b) for a, b in
                   zip((sc, asg, mass, cost), again))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d,k", [(15, 25), (37, 300), (15, 1111),
                                 (60, 100)],
                         ids=["kzmeans", "any_width", "beyond_resident",
                              "rows_in_place"])
@pytest.mark.parametrize("p", [1000, 1001, 5000],
                         ids=["p1000", "unaligned_p1001", "tiles_p5000"])
def test_cuda_truncated_cost_matches_plain(p, d, k, dt):
    """truncated_cost over (m, p, d) shards, one triple a machine, against
    sums over min_dist's own d2 (the kernel shares its distance code) with
    v at the median, so both sides are populated; the (n, d) entry point
    gives the one-machine triple; a repeat call gives the same bits. At
    p = 1001 a machine's base is not 16-byte aligned for the bulk copy of
    its tiles; at p = 5000 a machine spans several point tiles, and at
    1,111 centers the center axis is split; at d = 60 a float32 tile is
    too wide to stage and is read in place. Zero weights fall on no side,
    and with no valid center every point falls in the tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    m = 3
    _, x, c, cv, w = _inputs(4, m * p, d, k, dt)
    tol = _d2_tol(x, c)
    for mask in (None, cv):
        d2, _ = ops.min_dist(x, c, mask)
        v = torch.median(d2)
        xs, ws = x.reshape(m, p, d), w.reshape(m, p)
        kept, tmass, tcost = ops.truncated_cost(xs, ws, c, v, mask)
        assert kept.shape == tmass.shape == tcost.shape == (m,)
        dd, wd = d2.double().reshape(m, p), ws.double()
        below = dd <= float(v)
        s = torch.where(wd > 0, wd * dd, 0.0)
        for got, want in ((kept, torch.where(below, s, 0.0).sum(1)),
                          (tmass, torch.where(below, 0.0, wd).sum(1)),
                          (tcost, torch.where(below, 0.0, s).sum(1))):
            torch.testing.assert_close(got.double(), want, rtol=1e-5,
                                       atol=1e-6)
        # the plain version may put points within tol of v on the other
        # side; the total does not depend on the side
        kp, mp, cp = ref.truncated_cost_ref(xs, ws, c, v, mask)
        torch.testing.assert_close(kept + tcost, kp + cp, rtol=1e-5,
                                   atol=tol * float(w.sum()))
        one = ops.truncated_cost(x[:p], w[:p], c, v, mask)
        assert all(t.shape == () for t in one)
        torch.testing.assert_close(torch.stack(one),
                                   torch.stack((kept[0], tmass[0],
                                                tcost[0])),
                                   rtol=1e-6, atol=1e-6)
        again = ops.truncated_cost(xs, ws, c, v, mask)
        assert all(torch.equal(a, b) for a, b in
                   zip((kept, tmass, tcost), again))
        zero = ops.truncated_cost(xs, torch.zeros_like(ws), c, v, mask)
        assert all(float(t.abs().max()) == 0.0 for t in zero)
    none = torch.zeros(k, dtype=torch.bool, device="cuda")
    kept, tmass, tcost = ops.truncated_cost(xs, ws, c, 1e30, none)
    assert float(kept.abs().max()) == 0.0
    torch.testing.assert_close(tmass.double(), ws.double().sum(1),
                               rtol=1e-5, atol=1e-6)
    assert bool(torch.isinf(tcost).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
def test_cuda_remove_below_beyond_resident(dt):
    """remove_below at 1,111 centers (SOCCER's k_plus at k = 1000), with
    invalid centers: exactly ``alive & (d2 > v)`` on min_dist's own d2,
    and against its plain version with flips only within tol of v."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    m, p, d, k = 2, 2000, 15, 1111
    g, x, c, cv, _ = _inputs(5, m * p, d, k, dt)
    tol = _d2_tol(x, c)
    alive = torch.rand((m, p), device="cuda", generator=g) > 0.1
    for mask in (None, cv):
        d2, _ = ops.min_dist(x, c, mask)
        v = torch.median(d2)
        a, live = ops.remove_below(x.reshape(m, p, d), c, alive, v, mask)
        assert torch.equal(a, alive & (d2.reshape(m, p) > v))
        assert torch.equal(live, a.sum(1, dtype=torch.int32))
        a_p, _ = ref.remove_below_ref(x.reshape(m, p, d), c, alive, v, mask)
        d2_p, _ = ref.min_dist_ref(x, c, mask)
        flips = (a != a_p).reshape(-1)
        if bool(flips.any()):
            assert float((d2_p[flips] - v).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,d,k,split", [
    (3_001, 15, 300, False), (5_000, 15, 4_096, True),
    (1_999, 37, 1_500, True), (1_501, 513, 1_100, True),
    (2_049, 15, 1_023, False)],
    ids=["one_slice", "split", "split_any_width", "split_wide_d",
         "one_slice_ragged"])
def test_cuda_min_dist_blocked_walk(n, d, k, split, dt):
    """min_dist on the register-blocked walk at its boundaries: one center
    slice and several (the center axis split when the point tiles cannot
    fill the card), ragged tails (n not a multiple of 256·P), d = 15
    (rows in registers), 37 and 513 (rows re-read), with and without a
    mask, and with no valid center (+inf and index 0, as ref.py). Held
    against the plain version at test_cuda_kernels_match_plain's
    tolerance, and its argmin against the Lloyd kernel's assign_out bit
    for bit (the same walk and arithmetic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch.kernels import walk
    from repro_torch.kernels.fused_lloyd import fused_assign_reduce_cuda
    _, x, c, cv, w = _inputs(6, n, d, k, dt)
    ppt = walk.points_per_thread(d)
    assert n % (256 * ppt) != 0
    slices = walk.center_slices(n, k, walk.sm_count(x.device), ppt)
    assert (slices > 1) == split
    tol = _d2_tol(x, c)
    xf = x.float()
    none = torch.zeros(k, dtype=torch.bool, device="cuda")
    for mask in (None, cv, none):
        before = ops.KERNELS["min_dist"].launches
        d2, idx = ops.min_dist(x, c, mask)
        assert ops.KERNELS["min_dist"].launches == before + 1
        if mask is none:
            assert bool(torch.isinf(d2).all()) and int(idx.abs().max()) == 0
            continue
        d2_p, _ = ref.min_dist_ref(x, c, mask)
        torch.testing.assert_close(d2, d2_p, rtol=0, atol=tol)
        ci = c[idx.long()]               # argmin through the realized d2
        real = torch.clamp((xf * xf).sum(-1) - 2 * (xf * ci).sum(-1)
                           + (ci * ci).sum(-1), min=0)
        torch.testing.assert_close(real, d2_p, rtol=0, atol=2 * tol)
        if mask is not None:
            assert bool(mask[idx.long()].all())
        own = torch.empty_like(idx)
        fused_assign_reduce_cuda(x, w, c, mask, assign_out=own)
        assert torch.equal(own, idx)
        again = ops.min_dist(x, c, mask)
        assert torch.equal(again[0], d2) and torch.equal(again[1], idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("m,p,d,k", [(3, 1_000, 15, 103),
                                     (2, 2_049, 15, 1_111),
                                     (3, 777, 37, 300),
                                     (2, 1_001, 513, 190)],
                         ids=["main_path", "beyond_resident_ragged",
                              "any_width", "wide_d"])
def test_cuda_remove_below_blocked_walk(m, p, d, k, dt):
    """remove_below on the register-blocked walk, P points a thread over a
    grid of (point tile, machine), at ragged tails (p not a multiple of
    the tile), d = 15, 37 and 513, with and without a mask and with no
    valid center (nothing removed): the mask is exactly alive & (min_dist's
    d2 > v), the strict > with v one of the d2 values, the counts are the
    mask's row sums, and against the plain version only points within
    tol of v flip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch.kernels import walk
    g, x, c, cv, _ = _inputs(7, m * p, d, k, dt)
    assert p % (256 * walk.points_per_thread(d)) != 0
    tol = _d2_tol(x, c)
    alive = torch.rand((m, p), device="cuda", generator=g) > 0.1
    xs = x.reshape(m, p, d)
    none = torch.zeros(k, dtype=torch.bool, device="cuda")
    for mask in (None, cv, none):
        d2, _ = ops.min_dist(x, c, mask)
        v = (torch.median(d2) if mask is not none
             else torch.tensor(0.5, device="cuda"))
        before = ops.KERNELS["remove_below"].launches
        a, live = ops.remove_below(xs, c, alive, v, mask)
        assert ops.KERNELS["remove_below"].launches == before + 1
        assert torch.equal(a, alive & (d2.reshape(m, p) > v))
        assert torch.equal(live, a.sum(1, dtype=torch.int32))
        if mask is none:
            assert torch.equal(a, alive)
            continue
        assert bool((d2 == v).any())     # a point exactly at v is removed
        a_p, _ = ref.remove_below_ref(xs, c, alive, v, mask)
        d2_p, _ = ref.min_dist_ref(x, c, mask)
        flips = (a != a_p).reshape(-1)
        if bool(flips.any()):
            assert float((d2_p[flips] - v).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,d,k,offset", [
    (20_001, 15, 40, 0), (3_001, 15, 25, 1), (2_999, 37, 20, 1),
    (1_001, 513, 12, 0)],
    ids=["main_path", "unaligned_base", "any_width", "wide_d"])
def test_cuda_seeding_matches_plain(n, d, k, offset, dt):
    """The seeding kernel (update_min_dist's, its draw on) step by step
    from a shared state: its d2 equals ops.update_min_dist's for the same
    center bit for bit and the plain step's within tol; its draw is the
    argmax of torch's keys from its own d2, the key in its word within 4
    float32 ulps of torch's; the C loop's k draws equal the chained steps
    and repeat bit for bit; zero-weight rows are never drawn. ``offset``
    starts the points one row into their buffer (a base not 16-byte
    aligned), as a machine's slice of an (m, p, d) tensor can."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch.kernels import fused_lloyd as fl
    g, xb, _, _, w = _inputs(8, n + offset, d, 1, dt)
    x, w = xb[offset:], w[offset:].contiguous()
    assert (x.data_ptr() % 16 != 0) == (offset == 1 and d * x.element_size()
                                         % 16 != 0)
    seed = torch.randint(0, 1 << 32, (2,), generator=g, device="cuda")
    tol = _d2_tol(x, x.float())
    wf = w.float()
    d2 = torch.full((n,), torch.inf, device="cuda")
    prev, chain = None, []
    for step in range(k):
        d2_k = d2.clone()
        words = fl.kmeans_pp_step_cuda(x, w, d2_k, prev, step, seed)
        gs = ref.seed_gumbel(seed, n, range(step, step + 1))[0]
        kd = None
        if prev is not None:
            c = torch.index_select(x, 0, prev.reshape(1)).float()
            d2_u, _ = ops.update_min_dist(x, w, c, d2)
            assert torch.equal(d2_k, d2_u)
            d2_p, _, _ = ref.kmeans_pp_step_ref(x, w, d2, prev, gs)
            torch.testing.assert_close(d2_k, d2_p, rtol=0, atol=tol)
            kd = ref.gumbel_keys(wf * d2_k, gs)
        keys = (kd if kd is not None and bool(kd.max() > -torch.inf)
                else ref.gumbel_keys(wf, gs))
        a = ref.winner_from_words(words)
        b = torch.argmax(keys)
        key_k = ref.key_of_word(words[0] if keys is kd else words[1])
        ulp = 4 * float(torch.finfo(torch.float32).eps) * float(
            keys[b].abs().clamp(min=1.0))
        assert abs(float(key_k) - float(keys[a])) <= ulp
        assert float(keys[b] - keys[a]) <= ulp
        assert float(w[a]) > 0
        d2, prev = d2_k, a
        chain.append(a)
    before = ops.KERNELS["update_min_dist"].launches
    idx = ops.kmeans_plusplus_indices(x, w, k, seed)
    assert ops.KERNELS["update_min_dist"].launches == before + k
    assert torch.equal(idx, torch.stack(chain))
    assert torch.equal(idx, ops.kmeans_plusplus_indices(x, w, k, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,d,k,offset", [
    (991_418, 15, 1, 0), (400_001, 37, 300, 1), (300_000, 15, 1025, 0)],
    ids=["coordinator", "any_width_unaligned", "two_center_tiles"])
def test_cuda_update_min_dist_many_tiles(n, d, k, offset, dt):
    """The draw-off kernel where each block of its one wave walks many
    tiles: d2 against the plain version within tol, the mass (a fixed-order
    sum of one partial a tile) against a float64 sum of the plain terms
    within float32's rounding plus the d2 slack, and the same bits on a
    repeat; ``offset`` starts the points one row into their buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    g, xb, c, cv, w = _inputs(10, n + offset, d, k, dt)
    x, w = xb[offset:], w[offset:].contiguous()
    d2 = torch.rand(n, device="cuda", generator=g) * d
    tol = _d2_tol(x, c)
    u, mass = ops.update_min_dist(x, w, c, d2, cv)
    u_p, _ = ref.update_min_dist_ref(x, w, c, d2, cv)
    torch.testing.assert_close(u, u_p, rtol=0, atol=tol)
    want = float((w.double() * u_p.double()).sum())
    assert abs(float(mass) - want) <= (1e-5 * abs(want)
                                       + tol * float(w.sum()))
    u2, mass2 = ops.update_min_dist(x, w, c, d2, cv)
    assert torch.equal(u, u2) and torch.equal(mass, mass2)


@pytest.mark.cuda
def test_cuda_seeding_fallback_at_zero_mass():
    """Every point on one center: from step 1 the D² keys are all -inf and
    the draw falls back to the weights, as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    x = torch.ones((5_000, 15), device="cuda")
    w = torch.rand(5_000, device="cuda")
    w[::3] = 0.0
    seed = torch.tensor([3, 4], device="cuda")
    idx = ops.kmeans_plusplus_indices(x, w, 6, seed)
    assert torch.equal(idx, ref.kmeans_plusplus_indices_ref(x, w, 6, seed))
    assert bool((w[idx] > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("algo,kw", [
    ("soccer", dict(epsilon=0.05, delta=0.1)),
    ("kmeans_parallel", dict(rounds=5)),
    ("eim11", dict(epsilon=0.1, delta=0.1)),
    ("coreset_kmeans", dict(coreset_size=4_096)),
    ("kzmeans", dict(outlier_frac=0.02, coreset_size=32_000)),
    ("lloyd", {}), ("minibatch", {}),
    ("soccer", dict(epsilon=0.05, delta=0.1, sharded_coordinator=True)),
    ("soccer", dict(epsilon=0.05, delta=0.1, sharded_coordinator=True,
                    sharded_threshold="topk", sharded_seeding="kmeanspar")),
    ("soccer", dict(epsilon=0.05, delta=0.1, blackbox="minibatch")),
    ("soccer", dict(epsilon=0.05, delta=0.1, uplink_dtype="int8")),
    ("soccer", dict(epsilon=0.05, delta=0.1, uplink_dtype="bfloat16",
                    straggler_rate=0.3))],
    ids=["soccer", "kmeans_parallel", "eim11", "coreset_kmeans", "kzmeans",
         "lloyd", "minibatch", "soccer_sharded", "soccer_sharded_topk",
         "soccer_minibatch", "soccer_int8", "soccer_bf16_stragglers"])
def test_cuda_fits_repeat_bit_for_bit(algo, kw):
    """Each registered algorithm fitted twice in one process at one seed
    on one input of 200,000 points (the paper's mixture, 2% gross outliers
    for kzmeans) gives the same centers and cost bit for bit (ROADMAP
    Queue 3's run-to-run fault)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch import api
    from repro_torch.configs.soccer_paper import GaussianMixtureSpec
    from repro_torch.data.synthetic import contaminate, gaussian_mixture
    x, _, _ = gaussian_mixture(GaussianMixtureSpec(
        n=200_000, dim=15, k=25, sigma=0.001, zipf_gamma=1.5, seed=17))
    if algo == "kzmeans":
        x, _ = contaminate(x, frac=0.02, scale=50.0, seed=7)
    fits = [api.fit(x, 25, algo=algo, m=8, seed=0, **kw) for _ in range(2)]
    assert fits[0].centers.shape == fits[1].centers.shape
    assert (fits[0].centers == fits[1].centers).all()
    assert fits[0].cost(x) == fits[1].cost(x)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,kw", [
    ("soccer", dict(epsilon=0.05, delta=0.1)),
    ("soccer", dict(epsilon=0.05, delta=0.1, eta_override=20_000)),
    ("kmeans_parallel", dict(rounds=5)),
    ("eim11", dict(epsilon=0.1, delta=0.1)),
    ("coreset_kmeans", dict(coreset_size=4_096)),
    ("kzmeans", dict(outlier_frac=0.02, coreset_size=32_000)),
    ("lloyd", {}), ("minibatch", {})],
    ids=["soccer", "soccer_multiround", "kmeans_parallel", "eim11",
         "coreset_kmeans", "kzmeans", "lloyd", "minibatch"])
def test_cuda_traced_fit_equals_untraced(algo, kw):
    """A trace="rounds" fit on the card computes what the untraced one
    does, bit for bit, and its records sum exactly to wire_bytes_total."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    import numpy as np
    from repro_torch import api
    from repro_torch.configs.soccer_paper import GaussianMixtureSpec
    from repro_torch.data.synthetic import gaussian_mixture
    x, _, _ = gaussian_mixture(GaussianMixtureSpec(
        n=200_000, dim=15, k=25, sigma=0.001, zipf_gamma=1.5, seed=17))
    plain = api.fit(x, 25, algo=algo, m=8, seed=0, **kw)
    res = api.fit(x, 25, algo=algo, m=8, seed=0, trace="rounds", **kw)
    assert (res.centers == plain.centers).all()
    assert res.rounds == plain.rounds
    assert (res.wire_bytes == plain.wire_bytes).all()
    t = res.extra["trace"]
    wire = sum(r["wire_payload_bytes"] + r["wire_meta_bytes"]
               for r in t["records"])
    assert wire == res.wire_bytes_total
    assert all(r["wall_s"] is not None for r in t["records"])
    if plain.n_hist is not None:
        assert np.array_equal(res.n_hist, plain.n_hist)


@pytest.mark.cuda
def test_cuda_fit_update_runs_and_repeats():
    """One fit_update on the card (fold, refine, a forced re-cluster),
    twice from one bootstrap: the same centers bit for bit, m·k·iters
    uplink rows plus the re-cluster's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    import numpy as np
    from repro_torch import api
    from repro_torch.data.synthetic import drifting_mixture
    batches, _ = drifting_mixture(steps=2, n_per_step=100_000, k=25,
                                  dim=15, drift=0.04, sigma=0.02, seed=53)
    boot = api.fit(batches[0], 25, m=8, seed=0, epsilon=0.05)
    outs = [api.fit_update(boot, batches[1], m=8, refine_iters=4,
                           recluster="always") for _ in range(2)]
    assert (outs[0].centers == outs[1].centers).all()
    assert outs[0].centers.shape == (25, 15)
    assert np.isfinite(outs[0].centers).all()
    assert outs[0].uplink_points[0] > 8 * 25 * 4
    assert outs[0].extra["stream"].device.type == "cuda"


@pytest.mark.cuda
def test_cuda_mesh_fit_two_ranks():
    """``python -m repro_torch.launch --devices 2``: two ranks share the
    card over gloo (one machine each) and their SOCCER fit gives the
    virtual fit's rounds, uplink, wire bytes and cost on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    import json
    import os
    import subprocess
    import sys

    import numpy as np

    from repro_torch.api import fit
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "--devices", "2",
         "--algo", "soccer", "--k", "8", "--n", "20000", "--d", "8",
         "--param", "eta_override=2000"], env=env, capture_output=True,
        text=True, timeout=600)
    assert cli.returncode == 0, cli.stderr[-3000:]
    rep = json.loads(cli.stdout)
    rng = np.random.default_rng(0)          # the CLI's data at --seed 0
    centers = rng.normal(scale=4.0, size=(8, 8))
    x = (centers[rng.integers(8, size=20000)]
         + rng.normal(size=(20000, 8))).astype(np.float32)
    virt = fit(x, 8, algo="soccer", m=2, seed=0, eta_override=2000)
    assert rep["backend"] == "mesh" and rep["process_group"] == "gloo"
    assert rep["rounds"] == virt.rounds >= 1
    assert rep["uplink_points"] == [int(v) for v in virt.uplink_points]
    assert rep["wire_bytes"] == [int(v) for v in virt.wire_bytes]
    assert rep["wire_meta_bytes"] == [int(v) for v in virt.wire_meta_bytes]
    assert rep["cost"] == virt.cost(x)

@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,d,k,offset", [
    (2_001, 17, 161, 0), (3_001, 37, 300, 0), (1_501, 513, 190, 0),
    (1_001, 7_168, 81, 0), (1_001, 7_168, 78, 1), (130, 20, 3, 1)],
    ids=["d17", "d37", "d513", "d7168", "d7168_unaligned", "d20_unaligned"])
def test_cuda_tiled_walk_is_the_blocked_walk(n, d, k, offset, dt):
    """min_dist and the Lloyd kernel at d > 16 run the tiled walk
    (csrc/common.cuh: tiled_nearest); sensitivity_scores still runs the
    register-blocked walk, and at w = 1 its scores are 1·d2, exact. So
    min_dist's d2 and argmin and the Lloyd kernel's argmin (assign_out)
    equal sensitivity_scores' bit for bit, and the Lloyd kernel's sums and
    counts equal ref.fixed_point_reduce_ref over that argmin: at n not a
    multiple of the 128-point tile, k past the 80-center tile (but 78),
    with and without a center mask and with no valid center (+inf and
    index 0), and with the points' base 4 bytes off 16-byte alignment
    (``offset``: the 4-byte copies where d % 4 == 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch.kernels.fused_lloyd import fused_assign_reduce_cuda
    g, x, c, cv, w = _inputs(8, n, d, k, dt)
    if offset:
        flat = torch.empty(n * d + offset, dtype=dt, device="cuda")
        flat[offset:] = x.reshape(-1)
        x = flat[offset:].view(n, d)
    ones = torch.ones(n, device="cuda")
    none = torch.zeros(k, dtype=torch.bool, device="cuda")
    for mask in (None, cv, none):
        d2, idx = ops.min_dist(x, c, mask)
        sc, asg, _, _ = ops.sensitivity_scores(x, ones, c, mask)
        assert torch.equal(d2, sc) and torch.equal(idx, asg)
        own = torch.empty_like(idx)
        s, cnt, cost = fused_assign_reduce_cuda(x, w, c, mask,
                                                assign_out=own)
        assert torch.equal(own, asg)
        s_e, cnt_e = ref.fixed_point_reduce_ref(x, w, asg, k)
        assert torch.equal(s, s_e) and torch.equal(cnt, cnt_e)
        if mask is none:
            assert bool(torch.isinf(d2).all()) and int(idx.abs().max()) == 0
        else:
            c64 = float((w.double() * d2.double()).sum())
            assert abs(float(cost) - c64) <= 1e-5 * abs(c64)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("n,d,k,offset", [
    (2_001, 17, 161, 0), (3_001, 37, 300, 0), (1_501, 513, 190, 0),
    (1_001, 7_168, 81, 0), (1_001, 7_168, 78, 1), (130, 20, 3, 1)],
    ids=["d17", "d37", "d513", "d7168", "d7168_unaligned", "d20_unaligned"])
def test_cuda_tiled_removal_and_seeding_are_the_blocked_walk(n, d, k, offset,
                                                             dt):
    """remove_below and the seeding step at d > 16 (the tiled walk, and
    the seeding's point stages against one center) against
    sensitivity_scores at w = 1 (the register-blocked walk, exact): the
    mask and counts are ``alive & (scores > v)`` and the draw-off d2 is
    ``min(d2, scores)``, at k centers and at one, bit for bit, with and
    without a center mask and with no valid center; a draw-on step's d2 is
    the draw-off call's at the same center, the step over two parts
    (``kmeans_pp_step_at``) gives the one-call step's d2 and words, and a
    seeding repeats and equals its chained steps. ``offset``: the points'
    base 4 bytes (one float32, two 2-byte values) off 16-byte
    alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build only there")
    from repro_torch.kernels import fused_lloyd as fl
    g, x, c, cv, w = _inputs(9, n, d, k, dt)
    if offset:
        flat = torch.empty(n * d + offset, dtype=dt, device="cuda")
        flat[offset:] = x.reshape(-1)
        x = flat[offset:].view(n, d)
    ones = torch.ones(n, device="cuda")
    d2 = torch.rand(n, device="cuda", generator=g) * d
    p = n // 2
    alive = torch.rand((2, p), device="cuda", generator=g) > 0.2
    none = torch.zeros(k, dtype=torch.bool, device="cuda")
    for mask in (None, cv, none):
        sc, _, _, _ = ops.sensitivity_scores(x, ones, c, mask)
        v = torch.nan_to_num(torch.median(sc), posinf=1.0)
        keep, live = ops.remove_below(x[:2 * p].view(2, p, d), c, alive, v,
                                      mask)
        want = alive & (sc[:2 * p].view(2, p) > v)
        assert torch.equal(keep, want)
        assert torch.equal(live, want.sum(1, dtype=torch.int32))
        for cc, mm, s in ((c, mask, sc), (c[:1], None if mask is None
                                          else mask[:1], None)):
            if s is None:
                s, _, _, _ = ops.sensitivity_scores(x, ones, cc, mm)
            u, mass = ops.update_min_dist(x, w, cc, d2, mm)
            assert torch.equal(u, torch.where(s < d2, s, d2))
            again = ops.update_min_dist(x, w, cc, d2, mm)
            assert torch.equal(u, again[0]) and torch.equal(mass, again[1])
    seed = torch.randint(0, 1 << 32, (2,), generator=g, device="cuda")
    run = torch.full((n,), torch.inf, device="cuda")
    prev, chain, cut = None, [], n // 3
    for step in range(5):
        center = None if prev is None else x[prev].float()
        off = None if center is None else ops.update_min_dist(
            x, w, center.reshape(1, -1), run)[0]
        parts = [fl.kmeans_pp_step_at_cuda(x[lo:hi], w[lo:hi],
                                           run[lo:hi].clone(), center, step,
                                           seed, lo)
                 for lo, hi in ((0, cut), (cut, n))]
        words = fl.kmeans_pp_step_cuda(x, w, run, prev, step, seed)
        if off is not None:
            assert torch.equal(run, off)
        assert torch.equal(torch.cat([q for q, _ in parts]), run)
        assert torch.equal(ref.max_word(torch.stack([wd for _, wd in parts]),
                                        0), words)
        prev = ref.winner_from_words(words)
        chain.append(prev)
    idx = ops.kmeans_plusplus_indices(x, w, 5, seed)
    assert torch.equal(idx, torch.stack(chain))
    assert torch.equal(idx, ops.kmeans_plusplus_indices(x, w, 5, seed))

def test_smoke_fused_tolerance_all_moved_center():
    """``chip_smoke.py``'s Lloyd-step check against the plain version
    where a whole duplicated location sits under two tied centers and the
    kernel and the plain version put it on different ones (the scenario
    lab's Theorem 7.2 instance). The kernel's sums are exact fixed-point
    sums rounded once to float32 (``ref.fixed_point_reduce_ref``); the
    plain version's float64 sum for the kernel's center is 0. A relative
    term on the plain side alone flags that correct center (its float32
    rounding exceeds the absolute floor); the larger of the two sides
    does not."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n, k = 400, 2
    x = torch.tensor([[100.0, 37.3, 0.1, 5.0]]).repeat(n, 1)
    w = torch.ones(n)                  # two centers sit on the copies
    s_k, n_k = ref.fixed_point_reduce_ref(x, w, torch.zeros(n,
                                                            dtype=torch.long),
                                          k)   # the kernel: center 0
    wx = w.double()[:, None] * x.double()
    plain = torch.ones(n, dtype=torch.long)    # the plain version: center 1
    exact_s = torch.zeros((k, 4), dtype=torch.float64).index_add_(0, plain,
                                                                  wx)
    exact_n = torch.zeros(k, dtype=torch.float64).index_add_(
        0, plain, w.double())
    slack_s = torch.zeros((k, 4), dtype=torch.float64)
    slack_n = torch.zeros(k, dtype=torch.float64)
    for a in (torch.zeros(n, dtype=torch.long), plain):
        slack_s.index_add_(0, a, wx.abs())
        slack_n.index_add_(0, a, w.double())
    for got, exact, slack in ((s_k, exact_s, slack_s),
                              (n_k, exact_n, slack_n)):
        assert not bool(smoke.fused_outside_tol(got, exact, slack).any())
    old = ((s_k.double() - exact_s).abs()
           > smoke.FUSED_RTOL * exact_s.abs() + slack_s + 1e-6)
    assert bool(old[0].any()) and not bool(old[1].any())

