"""Launch shapes of the two center walks.

Two walks answer "which valid center is nearest" on the card, to the same
bits (``csrc/common.cuh``):

* the tiled walk, for every d > 16 in ``min_dist`` (``csrc/min_dist.cu``),
  the Lloyd step (``csrc/fused_assign.cu``) and ``remove_below``
  (``csrc/fused_lloyd.cu``, over a grid of ``tiled_tiles`` by the
  machines): a block owns a tile of ``TILED_POINTS`` points against
  ``TILED_CENTERS`` centers at a time, each thread ``TILED_PPT`` × 5
  (point, center) pairs, both operands staged through shared memory; its
  grid is ``tiled_tiles`` blocks, and the center axis is never split (no
  workload of the repo at d > 16 has too few point tiles to fill the
  card);
* the register-blocked walk ``csrc/common.cuh::nearest_split``: the three
  kernels above at d <= 16, and ``sensitivity_scores``
  (``csrc/sensitivity.cu``) and ``truncated_cost`` (``csrc/truncated.cu``,
  its tiles over every machine of one launch) at every d: each thread
  owns P points, and when the point tiles cannot fill the card the center
  axis is split over blocks.

Only the seeding step walks one point a thread against one center (past
d = 16 over the tiled walk's tiles: ``fused_lloyd.seed_tiles``). The
wrappers decide the launch shape here, on the host, by these rules;
nothing here touches the
card but the cached SM count. The center split's two constants are the
rule's; on a card whose measured table (``kernels/tuning.py``) has an
entry for the call's width, k and dtype, the split reads that entry's
instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.build import BLOCK_POINTS

# The rule: the fewest centers a slice of the center axis takes; the point
# tiles (blocks an SM, times the SMs) below which the center axis is split.
MIN_SLICE = 512
FILL_PER_SM = 4

# The tiled walk (csrc/common.cuh: kTilePoints, kTileCenters, kTiledPPT):
# points a block tile, centers a center tile, points of a thread's tile.
TILED_POINTS = 128
TILED_CENTERS = 80
TILED_PPT = 8

_SMS: dict = {}


def tiled(d: int) -> bool:
    """Whether d-wide points take the tiled walk in ``min_dist``, the
    Lloyd step and ``remove_below``, and the seeding step its tiles (d > 16:
    past the register rows)."""
    return d > 16


def tiled_tiles(n: int) -> int:
    """Blocks of the tiled walk over ``n`` points: tiles of TILED_POINTS
    (at least 1)."""
    return max(-(-n // TILED_POINTS), 1)


def points_per_thread(d: int) -> int:
    """Points a thread of the register-blocked walk where the walk
    dominates: 4 at d <= 16 (the rows in registers), else 2 (each row
    re-read from L1 for every center; ``sensitivity_scores`` and
    ``truncated_cost``)."""
    return 4 if d <= 16 else 2


def point_tiles(n: int, ppt: int) -> int:
    """Point tiles of BLOCK_POINTS·ppt points over ``n`` (at least 1)."""
    return max(-(-n // (BLOCK_POINTS * ppt)), 1)


def center_slices(n: int, k: int, sms: int, ppt: int, *, device=None,
                  d: int = 0, dtype=torch.float32) -> int:
    """Slices of the center axis over the point tiles of ``n`` points
    (``slices_for_tiles``; EIM11's 65,536 × 173,256 at 4 points a thread:
    64 tiles, 10 slices)."""
    return slices_for_tiles(point_tiles(n, ppt), k, sms, device=device, d=d,
                            dtype=dtype)


def slices_for_tiles(tiles: int, k: int, sms: int, *, device=None,
                     d: int = 0, dtype=torch.float32) -> int:
    """Slices of the center axis for a launch of ``tiles`` point tiles: 1
    when they reach ``fill_per_sm`` blocks an SM; else, from the fewest
    slices that do up to twice as many, the count whose blocks fill their
    last wave of ``sms`` best, each slice of at least ``min_slice``
    centers. The pair is the rule's (MIN_SLICE, FILL_PER_SM), or on a CUDA
    ``device`` ``tuning.split_params``' for d-wide ``dtype`` points."""
    min_slice, fill = (MIN_SLICE, FILL_PER_SM) if device is None else \
        tuning.split_params(device, d, k, dtype)
    tiles = max(tiles, 1)
    want = fill * sms
    top = k // min_slice
    if tiles >= want or top < 2:
        return 1
    lo = -(-want // tiles)
    best, waste = 1, None
    for s in range(min(lo, top), min(2 * lo, top) + 1):
        blocks = tiles * s
        w = -(-blocks // sms) * sms / blocks
        if waste is None or w < waste - 1e-9:
            best, waste = s, w
    return best


def split_scratch_bytes(n: int, ppt: int, slices: int) -> int:
    """Bytes of a split walk's scratch (``csrc/min_dist.cu``): the tile
    counters, then the (slices, n) per-slice best and arg, each rounded up
    to 8 bytes; 0 with one slice."""
    if slices == 1:
        return 0

    def r8(b):
        return -(-b // 8) * 8
    return r8(point_tiles(n, ppt) * 4) + 2 * r8(slices * n * 4)


def sm_count(device: torch.device) -> int:
    """The card's SM count, queried once a device."""
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]
