"""CUDA kernel: weighted per-center sums and counts for a given assignment.

Python wrapper over ``csrc/lloyd.cu``, which replaces
``repro/kernels/lloyd.py::lloyd_reduce_pallas``: the reduce half of a Lloyd
step when the assignment is already known (kzmeans' trimmed Lloyd step
re-weighs the rows between the assignment and the reduction). One kernel
at every k: the Lloyd step's grouped fixed-point reduce without its walk,
the group totals in each warp's shared rows or, past
``fused_lloyd.WARP_ACC_ENTRIES`` entries, in global int64 accumulators
(``fused_lloyd.acc_mode``, the Lloyd step's own rule). The sums are
exact, so a call gives the same bits on every run, and they equal
``kernels.ref.fixed_point_reduce_ref`` bit for bit. The plain version is
``kernels.ref.lloyd_reduce_ref``; ``kernels.ops.lloyd_reduce`` picks by
device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import walk
from repro_torch.kernels.build import (CudaKernel, check_on_card,
                                       dtype_code, ptr, stream_of, vector_f32)
from repro_torch.kernels.fused_lloyd import ACC_MODES, acc_mode

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

LLOYD_REDUCE = CudaKernel(
    "lloyd.cu", "rt_lloyd_reduce",
    [_P, _I, _L, _I, _P, _P, _I, _I, _I, _P, _L, _P, _P])


def scratch_bytes(k: int, d: int) -> int:
    """Bytes of the kernel's scratch: the (k, d + 1) int64 accumulators,
    then the bound (``csrc/lloyd.cu::rt_lloyd_reduce``)."""
    return (k * (d + 1) + 1) * 8


def lloyd_reduce_cuda(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """((k, d) float32 sums of w_i·x_i, (k,) float32 sums of w_i) per
    assigned center; an assignment outside [0, k) adds nothing. Exact
    fixed-point sums rounded once to float32; finite inputs only."""
    if x.dim() != 2:
        raise ValueError(f"lloyd_reduce: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    wf = vector_f32("lloyd_reduce", "w", w, n)
    if assign.shape != (n,):
        raise ValueError(f"lloyd_reduce: assign must be ({n},), got "
                         f"{tuple(assign.shape)}")
    a = assign.to(torch.int32).contiguous()
    check_on_card("lloyd_reduce", x, w=wf, assign=a)
    dev = x.device
    nbytes = scratch_bytes(k, d)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    out = torch.empty((k * d + k,), dtype=torch.float32, device=dev)
    LLOYD_REDUCE(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(a), k,
                 ACC_MODES[acc_mode(k, d)], walk.sm_count(dev), ptr(scratch),
                 nbytes, ptr(out), stream_of(x))
    return out[:k * d].view(k, d), out[k * d:]
