"""CUDA kernel: the weighted cost split at a distance threshold.

Python wrapper over ``csrc/truncated.cu``, which replaces
``repro/kernels/truncated.py::truncated_cost_pallas``: one sweep of each
machine's points gives its kept cost (min-d2 ``<= v``), tail weight mass
and tail cost (``> v``); rows of weight 0 fall on neither side. The grid
covers every machine, so one launch returns the (m,) triples that kzmeans
psums; ``kernels.ops.truncated_cost`` also serves the reference's (n, d)
contract through it. The kernel walks ``min_dist``'s walks: at d <= 16
the register-blocked walk (``csrc/common.cuh::nearest_split``) on point
tiles staged in shared memory by TMA bulk copies, past 16 the tiled walk
(``csrc/common.cuh::tiled_nearest``) over a grid of tiles by machines,
with the launch shape of ``launch_shape`` (``kernels/walk.py``'s rules
over the tiles of every machine), so each point's d2 and side of v are
``min_dist``'s bit for bit. The sums go through one partial a point tile
added in a fixed order: the same bits on every run. The plain version is
``kernels.ref.truncated_cost_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import walk
from repro_torch.kernels.build import (CudaKernel, check_on_card,
                                       dtype_code, ptr, stream_of)
from repro_torch.kernels.min_dist import center_mask, centers_f32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

TRUNCATED_COST = CudaKernel(
    "truncated.cu", "rt_truncated_cost",
    [_P, _I, _I, _L, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _L, _P, _P])


def launch_shape(m: int, p: int, d: int, k: int, sms: int, *, device=None,
                 dtype=torch.float32) -> Tuple[int, int, int]:
    """(points a thread, point tiles a machine, center slices) of a call
    over (m, p, d) shards against k centers: the tiled walk's (TILED_PPT,
    ``tiled_tiles(p)``, one slice) at d > 16; else ``walk.py``'s rules
    (on a CUDA ``device``, its tuned split for ``dtype`` points), the
    slices from the m·tiles point tiles of the whole launch (a tile never
    straddles two machines)."""
    if walk.tiled(d):
        return walk.TILED_PPT, walk.tiled_tiles(p), 1
    ppt = walk.points_per_thread(d)
    tiles = walk.point_tiles(p, ppt)
    return ppt, tiles, walk.slices_for_tiles(m * tiles, k, sms,
                                             device=device, d=d, dtype=dtype)


def scratch_bytes(m: int, p: int, tiles: int, slices: int) -> int:
    """Bytes of a call's scratch (``csrc/truncated.cu::trunc_scratch``) at
    ``tiles`` point tiles a machine: the (m, 3, tiles) tile partials,
    then, with more than one slice, the m·tiles tile counters and the
    (m, slices, p) per-slice best (no argmin), each rounded up to 8
    bytes."""
    def r8(b):
        return -(-b // 8) * 8
    part = r8(m * 3 * tiles * 4)
    if slices == 1:
        return part
    return part + r8(m * tiles * 4) + r8(slices * m * p * 4)


def truncated_cost_cuda(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                        v, c_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per machine of (m, p, d) points and (m, p) weights: ((m,) kept cost
    of the rows with min-d2 <= v, (m,) tail weight mass, (m,) tail cost),
    float32, at any number of centers. ``v`` is read by the kernel through
    a device pointer."""
    if x.dim() != 3:
        raise ValueError(f"truncated_cost: points must be (m, p, d), got "
                         f"{tuple(x.shape)}")
    m, p, d = x.shape
    if w.shape != (m, p):
        raise ValueError(f"truncated_cost: w must be ({m}, {p}), got "
                         f"{tuple(w.shape)}")
    wf = w.to(torch.float32).contiguous()
    cf = centers_f32("truncated_cost", c, d)
    k = cf.shape[0]
    cv = center_mask("truncated_cost", c_valid, k)
    vt = torch.as_tensor(v, dtype=torch.float32, device=x.device).reshape(())
    check_on_card("truncated_cost", x, w=wf, centers=cf, c_valid=cv, v=vt)
    dev = x.device
    sms = walk.sm_count(dev)
    ppt, tiles, slices = launch_shape(m, p, d, k, sms, device=dev,
                                      dtype=x.dtype)
    nbytes = scratch_bytes(m, p, tiles, slices)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    out = torch.empty((m, 3), dtype=torch.float32, device=dev)
    TRUNCATED_COST(ptr(x), dtype_code(x), m, p, d, ptr(wf), ptr(cf), ptr(cv),
                   k, ptr(vt), ppt, slices, sms, ptr(scratch), nbytes,
                   ptr(out), stream_of(x))
    return out[:, 0], out[:, 1], out[:, 2]
