"""CUDA kernels: one-sweep fused clustering passes.

Python wrappers over ``csrc/fused_lloyd.cu`` and ``csrc/fused_assign.cu``,
which replace the kernels of ``repro/kernels/fused_lloyd.py``:

* ``remove_below_cuda`` — SOCCER's removal over (m, p, d) shards: min-d2,
  the strict ``> v`` compare, the alive-mask update and per-machine live
  counts in one sweep, on ``min_dist``'s walks (the register-blocked one
  at d <= 16, the tiled one past it; replaces ``remove_below_pallas`` and
  ``remove_below_chunked_pallas``);
* ``update_min_dist_cuda`` — one D²-seeding step: ``min(d2, d2(x, c))``
  and the weighted mass ``sum w·d2_new`` (replaces
  ``update_min_dist_pallas`` and its pipelined big-n twin); past d = 16 a
  block streams the tiled walk's tile of points through shared memory
  against one center, or takes the tiled walk against several;
* ``kmeans_plusplus_indices_cuda`` — a whole weighted k-means++ seeding
  on the same kernel with its Gumbel-max draw on: one C call launches the
  k steps back to back and returns the (k,) chosen rows, with nothing
  read back (``kmeans_pp_step_cuda`` runs one step, for checks;
  ``kmeans_pp_step_at_cuda`` one step over a mesh rank's part of the
  seeded set);
* ``fused_assign_reduce_cuda`` — one Lloyd step at any number of centers:
  assignment, weighted (k, d) sums, (k,) counts and the cost in one sweep
  at d <= 16, and at d > 16 in the tiled walk and a reduce by column
  (``csrc/fused_assign.cu``; replaces ``fused_assign_reduce_pallas``, its
  pipelined big-n twin, ``fused_assign_reduce_chunked_pallas`` and its
  two-walk fallback ``_fused_assign_reduce_chunked_twopass``);
  ``fixed_bound_cuda`` and ``fused_assign_reduce_fixed_cuda`` run it
  over a mesh rank's part of a point set, at the whole set's shifts, and
  hand back the exact integer accumulators that the ranks add up.

Float sums across blocks go through per-block partials reduced in a
fixed order, and the Lloyd step's sums through fixed-point integer
accumulators, so each call gives the same bits on every run. The plain
versions are in ``kernels/ref.py``; ``kernels/ops.py`` picks by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import walk
from repro_torch.kernels.build import (BLOCK_POINTS, CudaKernel,
                                       check_on_card, dtype_code, ptr,
                                       stream_of, vector_f32)
from repro_torch.kernels.min_dist import center_mask, centers_f32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

REMOVE_BELOW = CudaKernel(
    "fused_lloyd.cu", "rt_remove_below",
    [_P, _I, _I, _L, _I, _P, _P, _I, _P, _P, _P, _P, _P])
UPDATE_MIN_DIST = CudaKernel(
    "fused_lloyd.cu", "rt_update_min_dist",
    [_P, _I, _L, _I, _P, _P, _P, _P, _I, _P, _P, _L, _P, _I, _P])
# the same kernel with its draw on: a whole seeding, or one step; both
# count their launches as update_min_dist's
KMEANS_PP = CudaKernel(
    "fused_lloyd.cu", "rt_kmeanspp",
    [_P, _I, _L, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P],
    counts=UPDATE_MIN_DIST)
KMEANS_PP_STEP = CudaKernel(
    "fused_lloyd.cu", "rt_kmeanspp_step",
    [_P, _I, _L, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P],
    counts=UPDATE_MIN_DIST)
# one step over a part of a larger seeded set (a mesh rank's rows)
KMEANS_PP_STEP_AT = CudaKernel(
    "fused_lloyd.cu", "rt_kmeanspp_step_at",
    [_P, _I, _L, _I, _P, _P, _I, _L, _P, _P, _P, _P, _I, _P],
    counts=UPDATE_MIN_DIST)
FUSED_ASSIGN_REDUCE = CudaKernel(
    "fused_assign.cu", "rt_fused_assign_reduce",
    [_P, _I, _L, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _L, _P, _L, _P, _P,
     _P])
# the Lloyd step's bound pass alone, for a step over several parts; it
# counts its own launches, so that a step over parts (this pass, then
# fused_assign_reduce_fixed_cuda) adds one to the Lloyd step's count, as
# the one-call step, whose C call runs its bound pass, does
FIXED_BOUND = CudaKernel("fused_assign.cu", "rt_fixed_bound",
                         [_P, _I, _L, _I, _P, _P, _P])

# The fixed-point accumulator entries (k·(d + 1)) up to which each warp
# keeps its sums in shared memory (csrc/common.cuh: AccMode, GroupAcc);
# the walk's launch shape is kernels/walk.py's.
WARP_ACC_ENTRIES = 1024
ACC_MODES = {"global": 0, "warp": 1}


def acc_mode(k: int, d: int) -> str:
    """Where the group totals of k rows of d + 1 fixed-point sums go: each
    warp's shared rows up to WARP_ACC_ENTRIES entries, else the global
    accumulators. The Lloyd step's rule, and ``lloyd_reduce``'s; with
    d = 0, the one column of ``sensitivity_scores``' masses."""
    return "warp" if k * (d + 1) <= WARP_ACC_ENTRIES else "global"


def points_per_thread(k: int, d: int) -> int:
    """The Lloyd step's points a thread: the tiled walk's at d > 16;
    else the register-blocked walk's (``walk.points_per_thread``) beyond
    the warp accumulators, and 2 within them (with few centers the reduce
    dominates)."""
    if walk.tiled(d):
        return walk.TILED_PPT
    return walk.points_per_thread(d) if acc_mode(k, d) == "global" else 2


def launch_slices(n: int, k: int, d: int, sms: int, device, dtype) -> int:
    """The Lloyd step's center slices: one on the tiled walk (d > 16),
    else ``walk.center_slices`` at its points a thread."""
    if walk.tiled(d):
        return 1
    return walk.center_slices(n, k, sms, points_per_thread(k, d),
                              device=device, d=d, dtype=dtype)


def layout_bytes(n: int, d: int, k: int, tiles: int, slices: int,
                 assign_rows: int = 0) -> int:
    """Bytes of ``csrc/common.cuh::scratch_layout(n, d, k, tiles, slices,
    assign_rows)``: (k, d + 1) int64 accumulators, the bound, the tile
    counters, the tile cost partials, with more than one slice the
    (slices, n) per-slice (best, arg), then ``assign_rows`` int32, each
    rounded up to 8 bytes."""
    def r8(b):
        return -(-b // 8) * 8
    ws = r8(slices * n * 4) if slices > 1 else 0
    return k * (d + 1) * 8 + 8 + 2 * r8(tiles * 4) + 2 * ws + r8(
        assign_rows * 4)


def scratch_bytes(n: int, d: int, k: int, ppt: int, slices: int) -> int:
    """Bytes of the Lloyd step's one scratch buffer (``layout_bytes``) at
    its walk's tiles: on the tiled walk (d > 16: ``walk.tiled_tiles``)
    with the (n,) int32 argmin its column reduce reads back."""
    if walk.tiled(d):
        return layout_bytes(n, d, k, walk.tiled_tiles(n), slices, n)
    return layout_bytes(n, d, k, walk.point_tiles(n, ppt), slices)


# The tiled Lloyd step's column reduce (csrc/fused_assign.cu: kColSlab,
# kRangeCenters, kSplitMin): columns a block, centers a block's range at
# most, points a split at least.
REDUCE_SLAB = 1024
REDUCE_RANGE = 8
REDUCE_SPLIT_MIN = 1024


def reduce_grid(n: int, d: int, k: int, sms: int) -> Tuple[int, int, int,
                                                            int, int]:
    """(slabs, ranges, centers a range, splits, points a split) of the
    column reduce, as ``csrc/fused_assign.cu::column_grid``: slabs of
    REDUCE_SLAB over the d + 1 columns, even ranges of at most
    REDUCE_RANGE centers, and the fewest splits of at least
    REDUCE_SPLIT_MIN points that bring the blocks to 4 an SM."""
    slabs = -(-(d + 1) // REDUCE_SLAB)
    ranges = -(-k // REDUCE_RANGE)
    kr = -(-k // ranges)
    cells = slabs * ranges
    splits = max(min(-(-4 * sms // cells), -(-n // REDUCE_SPLIT_MIN)), 1)
    return slabs, ranges, kr, splits, -(-n // splits)


def seed_tiles(n: int, d: int) -> int:
    """Tiles of the seeding step over ``n`` rows (csrc/fused_lloyd.cu::
    seed_tile_rows): BLOCK_POINTS rows a tile at d <= 16, the tiled walk's
    ``walk.TILED_POINTS`` past it; at least 1, so scratch sized by it is
    never empty."""
    rows = walk.TILED_POINTS if walk.tiled(d) else BLOCK_POINTS
    return max(-(-n // rows), 1)


def remove_below_cuda(x: torch.Tensor, c: torch.Tensor, alive: torch.Tensor,
                      v, c_valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((m, p) bool ``alive & (min-d2 > v)``, (m,) int32 survivor counts).

    ``v`` is read by the kernel through a device pointer, so a threshold
    computed on the card never waits for the host.
    """
    if x.dim() != 3:
        raise ValueError(f"remove_below: points must be (m, p, d), got "
                         f"{tuple(x.shape)}")
    m, p, d = x.shape
    if alive.shape != (m, p) or alive.dtype != torch.bool:
        raise ValueError(f"remove_below: alive must be ({m}, {p}) bool, got "
                         f"{tuple(alive.shape)} {alive.dtype}")
    cf = centers_f32("remove_below", c, d)
    cv = center_mask("remove_below", c_valid, cf.shape[0])
    vt = torch.as_tensor(v, dtype=torch.float32, device=x.device).reshape(())
    check_on_card("remove_below", x, centers=cf, c_valid=cv, alive=alive,
                  v=vt)
    alive_new = torch.empty((m, p), dtype=torch.bool, device=x.device)
    live = torch.empty((m,), dtype=torch.int32, device=x.device)
    REMOVE_BELOW(ptr(x), dtype_code(x), m, p, d, ptr(cf), ptr(cv),
                 cf.shape[0], ptr(vt), ptr(alive), ptr(alive_new), ptr(live),
                 stream_of(x))
    return alive_new, live


def update_min_dist_cuda(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                         d2: torch.Tensor,
                         c_valid: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((n,) ``min(d2, min-d2 to c)``, () ``sum w * d2_new``); with no valid
    center ``d2`` passes through unchanged."""
    if x.dim() != 2:
        raise ValueError(f"update_min_dist: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    wf = vector_f32("update_min_dist", "w", w, n)
    d2f = vector_f32("update_min_dist", "d2", d2, n)
    cf = centers_f32("update_min_dist", c, d)
    cv = center_mask("update_min_dist", c_valid, cf.shape[0])
    check_on_card("update_min_dist", x, w=wf, d2=d2f, centers=cf, c_valid=cv)
    d2_new = torch.empty((n,), dtype=torch.float32, device=x.device)
    nb = seed_tiles(n, d)
    part = torch.empty((nb,), dtype=torch.float32, device=x.device)
    mass = torch.empty((), dtype=torch.float32, device=x.device)
    UPDATE_MIN_DIST(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(d2f), ptr(cf),
                    ptr(cv), cf.shape[0], ptr(d2_new), ptr(part), nb,
                    ptr(mass), walk.sm_count(x.device), stream_of(x))
    return d2_new, mass


def _seeding_args(name: str, x: torch.Tensor, w: torch.Tensor,
                  seed: torch.Tensor) -> torch.Tensor:
    """Checks of a draw-on call; returns the float32 weights."""
    if x.dim() != 2:
        raise ValueError(f"{name}: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    if not 0 < n < 2 ** 31:
        raise ValueError(f"{name}: needs 1 <= n < 2^31 points, got {n}")
    if seed.shape != (2,) or seed.dtype != torch.int64:
        raise ValueError(f"{name}: seed must be (2,) int64, got "
                         f"{tuple(seed.shape)} {seed.dtype}")
    wf = vector_f32(name, "w", w, n)
    check_on_card(name, x, w=wf, seed=seed)
    return wf


def kmeans_plusplus_indices_cuda(x: torch.Tensor, w: torch.Tensor, k: int,
                                 seed: torch.Tensor) -> torch.Tensor:
    """(k,) int64 rows of ``x`` drawn by weighted k-means++ (D²) seeding,
    keyed by the (2,) int64 ``seed`` on the card: one C call launches the
    k steps and the index write, and nothing is read back to the host.

    Checks and allocates once a seeding: d2 at +inf, and the (k,) D² and
    w words of the steps' draws at 0 (int64 storage of the kernel's
    unsigned 64-bit words)."""
    wf = _seeding_args("kmeans_plusplus_indices", x, w, seed)
    n, d = x.shape
    idx = torch.empty((k,), dtype=torch.int64, device=x.device)
    if k == 0:
        return idx
    d2 = torch.full((n,), torch.inf, dtype=torch.float32, device=x.device)
    words = torch.zeros((2, k), dtype=torch.int64, device=x.device)
    KMEANS_PP(ptr(x), dtype_code(x), n, d, ptr(wf), k, ptr(seed), ptr(d2),
              ptr(words[0]), ptr(words[1]), ptr(idx), walk.sm_count(x.device),
              stream_of(x), launches=k)
    return idx


def kmeans_pp_step_cuda(x: torch.Tensor, w: torch.Tensor, d2: torch.Tensor,
                        prev: Optional[torch.Tensor], step: int,
                        seed: torch.Tensor) -> torch.Tensor:
    """One draw-on step, as step ``step`` of a seeding keyed by ``seed``:
    ``d2`` ((n,) float32, updated in place) is lowered against row
    ``prev`` (a () int64 index on the card; None: no center, as step 0),
    and the step's (D² word, w word) come back as a (2,) int64 tensor
    (``ref.winner_from_words`` and ``ref.key_of_word`` read them)."""
    wf = _seeding_args("kmeans_pp_step", x, w, seed)
    n, d = x.shape
    if d2.shape != (n,) or d2.dtype != torch.float32:
        raise ValueError(f"kmeans_pp_step: d2 must be ({n},) float32")
    check_on_card("kmeans_pp_step", x, d2=d2)
    out = torch.zeros((2,), dtype=torch.int64, device=x.device)
    pw = None
    if prev is not None:
        # a D² word above -inf at index prev: the center is row prev
        pw = torch.zeros((2,), dtype=torch.int64, device=x.device)
        pw[0] = (1 << 62) + (0xFFFFFFFF - prev.reshape(()).to(torch.int64))
    KMEANS_PP_STEP(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(seed), step,
                   ptr(d2), ptr(pw), None if pw is None else ptr(pw[1:]),
                   ptr(out), ptr(out[1:]), walk.sm_count(x.device),
                   stream_of(x))
    return out


def kmeans_pp_step_at_cuda(x: torch.Tensor, w: torch.Tensor,
                           d2: torch.Tensor, center: Optional[torch.Tensor],
                           step: int, seed: torch.Tensor, base: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One draw-on step over rows ``base .. base + n - 1`` of a larger
    seeded set (a mesh rank's rows): ``d2`` ((n,) float32) lowered in
    place against ``center`` ((d,) float32; None: no center, as step 0),
    and the step's (D² word, w word) over the part as a (2,) int64 tensor,
    keyed and indexed by the rows' global indices. Returns (d2, words)."""
    wf = _seeding_args("kmeans_pp_step_at", x, w, seed)
    n, d = x.shape
    if d2.shape != (n,) or d2.dtype != torch.float32:
        raise ValueError(f"kmeans_pp_step_at: d2 must be ({n},) float32")
    if not (0 <= base and base + n <= 2 ** 31):
        raise ValueError(f"kmeans_pp_step_at: rows {base}..{base + n} "
                         f"outside [0, 2^31)")
    cf = None
    if center is not None:
        cf = centers_f32("kmeans_pp_step_at", center.reshape(1, -1), d)
    check_on_card("kmeans_pp_step_at", x, d2=d2, center=cf)
    out = torch.zeros((2,), dtype=torch.int64, device=x.device)
    KMEANS_PP_STEP_AT(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(seed), step,
                      base, ptr(cf), ptr(d2), ptr(out), ptr(out[1:]),
                      walk.sm_count(x.device), stream_of(x))
    return d2, out


def fused_assign_reduce_cuda(x: torch.Tensor, w: torch.Tensor,
                             c: torch.Tensor,
                             c_valid: Optional[torch.Tensor] = None, *,
                             assign_out: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """((k, d) weighted sums, (k,) weight counts, () weighted cost), at any
    number of centers.

    The sums and counts are exact fixed-point integer sums rounded once to
    float32 (``ref.fixed_point_reduce_ref`` reproduces them bit for bit
    from the argmin), so a call gives the same bits on every run. Finite
    inputs only. ``assign_out``, an (n,) int32 CUDA tensor, receives the
    argmin, for checks.
    """
    if x.dim() != 2:
        raise ValueError(f"fused_assign_reduce: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    wf = vector_f32("fused_assign_reduce", "w", w, n)
    cf = centers_f32("fused_assign_reduce", c, d)
    k = cf.shape[0]
    cv = center_mask("fused_assign_reduce", c_valid, k)
    check_on_card("fused_assign_reduce", x, w=wf, centers=cf, c_valid=cv,
                  assign_out=assign_out)
    if k == 0:
        raise ValueError("fused_assign_reduce: no centers")
    if assign_out is not None and (assign_out.shape != (n,)
                                   or assign_out.dtype != torch.int32):
        raise ValueError(f"fused_assign_reduce: assign_out must be ({n},) "
                         f"int32")
    ppt = points_per_thread(k, d)
    sms = walk.sm_count(x.device)
    slices = launch_slices(n, k, d, sms, x.device, x.dtype)
    nbytes = scratch_bytes(n, d, k, ppt, slices)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    out = torch.empty((k * d + k + 1,), dtype=torch.float32, device=x.device)
    FUSED_ASSIGN_REDUCE(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(cf),
                        ptr(cv), k, ppt, slices, ACC_MODES[acc_mode(k, d)],
                        sms, ptr(scratch), nbytes, None, 0, ptr(assign_out),
                        ptr(out), stream_of(x))
    return out[:k * d].view(k, d), out[k * d:k * d + k], out[k * d + k]


def fixed_bound_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(2,) int32 bound words of the Lloyd step's fixed point over (x, w):
    the float32 bits of max |w| and of max |x| over rows with w != 0 (as
    ``ref.fixed_bound_ref``); the words of several parts combine by
    max."""
    if x.dim() != 2:
        raise ValueError(f"fixed_bound: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    wf = vector_f32("fixed_bound", "w", w, n)
    check_on_card("fixed_bound", x, w=wf)
    bound = torch.empty((2,), dtype=torch.int32, device=x.device)
    FIXED_BOUND(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(bound),
                stream_of(x))
    return bound


def fused_assign_reduce_fixed_cuda(x: torch.Tensor, w: torch.Tensor,
                                   c: torch.Tensor, bound: torch.Tensor,
                                   n_total: int, *,
                                   assign_out: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """The Lloyd step over one part of a larger point set: the part's
    (k, d + 1) int64 fixed-point accumulators (sums of w·x, then of w) at
    the shifts of the whole set's ``bound`` words (``fixed_bound_cuda``
    over every part, combined by max) and row count ``n_total``. Summed
    over the parts they are the accumulators one call over the whole set
    takes, bit for bit (``exact.fixed_finalize`` rounds them).
    ``assign_out``, an (n,) int32 CUDA tensor, receives the argmin, for
    checks."""
    if x.dim() != 2:
        raise ValueError(f"fused_assign_reduce_fixed: points must be "
                         f"(n, d), got {tuple(x.shape)}")
    n, d = x.shape
    if not n <= n_total:
        raise ValueError(f"fused_assign_reduce_fixed: n_total={n_total} "
                         f"below the part's {n} rows")
    wf = vector_f32("fused_assign_reduce_fixed", "w", w, n)
    cf = centers_f32("fused_assign_reduce_fixed", c, d)
    k = cf.shape[0]
    if bound.shape != (2,) or bound.dtype != torch.int32:
        raise ValueError("fused_assign_reduce_fixed: bound must be (2,) "
                         "int32")
    check_on_card("fused_assign_reduce_fixed", x, w=wf, centers=cf,
                  bound=bound, assign_out=assign_out)
    ppt = points_per_thread(k, d)
    sms = walk.sm_count(x.device)
    slices = launch_slices(n, k, d, sms, x.device, x.dtype)
    nbytes = scratch_bytes(n, d, k, ppt, slices)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    out = torch.empty((k * d + k + 1,), dtype=torch.float32, device=x.device)
    FUSED_ASSIGN_REDUCE(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(cf), None,
                        k, ppt, slices, ACC_MODES[acc_mode(k, d)], sms,
                        ptr(scratch), nbytes, ptr(bound), n_total,
                        ptr(assign_out), ptr(out), stream_of(x))
    # the accumulators are the scratch's first bytes
    # (csrc/common.cuh::scratch_layout)
    return scratch[:k * (d + 1) * 8].view(torch.int64).view(k, d + 1)
