"""CUDA kernel: the coreset builder's sensitivity sweep.

Python wrapper over ``csrc/sensitivity.cu``, which replaces
``repro/kernels/sensitivity.py::sensitivity_scores_pallas``: in one sweep
of the points, each point's score ``w·min-d2`` and nearest valid center,
each center's weight mass, and the weighted cost of the center set. One
kernel at every k, on ``min_dist``'s walks with their launch shapes
(``kernels/walk.py``: the register-blocked walk at d <= 16, the tiled
walk past it), so the argmin and the scores' d2 are ``min_dist``'s bit
for bit. The masses are exact fixed-point sums
(``kernels.exact.exact_index_add``'s bits) and the cost a fixed-order sum
of one partial a point tile, so a call gives the same bits on every run.
The plain version is ``kernels.ref.sensitivity_scores_ref``;
``kernels.ops.sensitivity_scores`` picks by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import walk
from repro_torch.kernels.build import (CudaKernel, check_on_card,
                                       dtype_code, ptr, stream_of, vector_f32)
from repro_torch.kernels.fused_lloyd import (ACC_MODES, acc_mode,
                                             layout_bytes)
from repro_torch.kernels.min_dist import center_mask, centers_f32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

SENSITIVITY_SCORES = CudaKernel(
    "sensitivity.cu", "rt_sensitivity_scores",
    [_P, _I, _L, _I, _P, _P, _P, _I, _I, _I, _I, _P, _L, _P, _P, _P, _P])


def launch_shape(n: int, d: int, k: int, sms: int, *, device=None,
                 dtype=torch.float32) -> Tuple[int, int, int]:
    """(points a thread, point tiles, center slices) of a call over n
    d-wide points against k centers: the tiled walk's (TILED_PPT,
    ``tiled_tiles(n)``, one slice) at d > 16, else the register-blocked
    walk's by ``walk.py``'s rules (on a CUDA ``device``, its tuned split
    for ``dtype`` points)."""
    if walk.tiled(d):
        return walk.TILED_PPT, walk.tiled_tiles(n), 1
    ppt = walk.points_per_thread(d)
    return ppt, walk.point_tiles(n, ppt), walk.center_slices(
        n, k, sms, ppt, device=device, d=d, dtype=dtype)


def sensitivity_scores_cuda(x: torch.Tensor, w: torch.Tensor,
                            c: torch.Tensor,
                            c_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """((n,) float32 scores w·min-d2, (n,) int32 argmin, (k,) float32
    weight mass per center, () float32 cost), at any number of centers.
    The masses are one fixed-point column (``acc_mode(k, 0)``: k entries);
    finite weights only."""
    if x.dim() != 2:
        raise ValueError(f"sensitivity_scores: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    wf = vector_f32("sensitivity_scores", "w", w, n)
    cf = centers_f32("sensitivity_scores", c, d)
    k = cf.shape[0]
    cv = center_mask("sensitivity_scores", c_valid, k)
    check_on_card("sensitivity_scores", x, w=wf, centers=cf, c_valid=cv)
    if k == 0:
        raise ValueError("sensitivity_scores: no centers")
    dev = x.device
    ppt, tiles, slices = launch_shape(n, d, k, walk.sm_count(dev),
                                      device=dev, dtype=x.dtype)
    nbytes = layout_bytes(n, 0, k, tiles, slices)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    scores = torch.empty((n,), dtype=torch.float32, device=dev)
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    out = torch.empty((k + 1,), dtype=torch.float32, device=dev)
    SENSITIVITY_SCORES(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(cf),
                       ptr(cv), k, ppt, slices, ACC_MODES[acc_mode(k, 0)],
                       ptr(scratch), nbytes, ptr(scores), ptr(assign),
                       ptr(out), stream_of(x))
    return scores, assign, out[:k], out[k]
