"""Launch shape of the register-blocked center walk.

``csrc/common.cuh::nearest_split`` is the one walk of the Lloyd step
(``csrc/fused_assign.cu``), ``min_dist`` (``csrc/min_dist.cu``),
``remove_below`` (``csrc/fused_lloyd.cu``), ``sensitivity_scores``
(``csrc/sensitivity.cu``) and ``truncated_cost`` (``csrc/truncated.cu``,
its tiles over every machine of one launch): each thread owns P points,
and when the point tiles cannot fill the card the center axis is split
over blocks. Only the seeding step walks one point a thread. The
wrappers decide the launch shape here, on the host, by these rules;
nothing here touches the card but the cached SM count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import BLOCK_POINTS

# The fewest centers a slice of the center axis takes; the point tiles
# (blocks an SM, times the SMs) below which the center axis is split.
MIN_SLICE = 512
FILL_PER_SM = 4

_SMS: dict = {}


def points_per_thread(d: int) -> int:
    """Points a thread where the walk dominates: 4 at d <= 16 (the rows in
    registers), else 2 (each row re-read from L1 for every center)."""
    return 4 if d <= 16 else 2


def point_tiles(n: int, ppt: int) -> int:
    """Point tiles of BLOCK_POINTS·ppt points over ``n`` (at least 1)."""
    return max(-(-n // (BLOCK_POINTS * ppt)), 1)


def center_slices(n: int, k: int, sms: int, ppt: int) -> int:
    """Slices of the center axis over the point tiles of ``n`` points
    (``slices_for_tiles``; EIM11's 65,536 × 173,256 at 4 points a thread:
    64 tiles, 10 slices)."""
    return slices_for_tiles(point_tiles(n, ppt), k, sms)


def slices_for_tiles(tiles: int, k: int, sms: int) -> int:
    """Slices of the center axis for a launch of ``tiles`` point tiles: 1
    when they reach FILL_PER_SM blocks an SM; else, from the fewest slices
    that do up to twice as many, the count whose blocks fill their last
    wave of ``sms`` best, each slice of at least MIN_SLICE centers."""
    tiles = max(tiles, 1)
    want = FILL_PER_SM * sms
    top = k // MIN_SLICE
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
