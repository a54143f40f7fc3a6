"""CUDA kernel: fused pairwise min squared distance (+ argmin).

Replaces ``repro/kernels/min_dist.py::min_dist_pallas``. The kernel
(``csrc/min_dist.cu``) walks the center set through shared memory with
P points a thread, the register-blocked walk it shares with the Lloyd
step, ``remove_below`` and ``sensitivity_scores``
(``csrc/common.cuh::nearest_split``), and
splits the center axis over blocks when the point tiles cannot fill the
card (``kernels/walk.py`` decides both), so the (n, k) distance matrix
never exists; its note says what bounds it on the card. The plain
version is ``kernels.ref.min_dist_ref``; ``kernels.ops.min_dist`` picks
between the two by the device of the points.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import walk
from repro_torch.kernels.build import (CudaKernel, check_on_card,
                                       dtype_code, ptr, stream_of)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

MIN_DIST = CudaKernel("min_dist.cu", "rt_min_dist",
                      [_P, _I, _L, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P])


def centers_f32(name: str, c: torch.Tensor, d: int) -> torch.Tensor:
    """(k, d) centers as the float32 the kernels read (a copy only for a
    reduced-precision or non-contiguous center set, k·d values)."""
    if c.dim() != 2 or c.shape[1] != d:
        raise ValueError(f"{name}: centers must be (k, {d}), got "
                         f"{tuple(c.shape)}")
    return c.to(torch.float32).contiguous()


def center_mask(name: str, c_valid: Optional[torch.Tensor],
                k: int) -> Optional[torch.Tensor]:
    """(k,) bool mask as the kernels read it (one byte each); None = all
    valid."""
    if c_valid is None:
        return None
    if c_valid.shape != (k,):
        raise ValueError(f"{name}: c_valid must be ({k},), got "
                         f"{tuple(c_valid.shape)}")
    return c_valid.to(torch.bool).contiguous()


def min_dist_cuda(x: torch.Tensor, c: torch.Tensor,
                  c_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) float32 min-d2 over valid centers and (n,) int32 argmin."""
    if x.dim() != 2:
        raise ValueError(f"min_dist: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    cf = centers_f32("min_dist", c, d)
    cv = center_mask("min_dist", c_valid, cf.shape[0])
    check_on_card("min_dist", x, centers=cf, c_valid=cv)
    k = cf.shape[0]
    ppt = walk.points_per_thread(d)
    slices = walk.center_slices(n, k, walk.sm_count(x.device), ppt,
                                device=x.device, d=d, dtype=x.dtype)
    scratch = None
    if slices > 1:
        scratch = torch.empty((walk.split_scratch_bytes(n, ppt, slices),),
                              dtype=torch.uint8, device=x.device)
    d2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    MIN_DIST(ptr(x), dtype_code(x), n, d, ptr(cf), ptr(cv), k, ppt, slices,
             ptr(scratch), ptr(d2), ptr(idx), stream_of(x))
    return d2, idx
