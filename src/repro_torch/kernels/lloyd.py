"""CUDA kernel: weighted per-center sums and counts for a given assignment.

Python wrapper over ``csrc/lloyd.cu``, which replaces
``repro/kernels/lloyd.py::lloyd_reduce_pallas``: the reduce half of a Lloyd
step when the assignment is already known (kzmeans' trimmed Lloyd step
re-weighs the rows between the assignment and the reduction). Up to
``ops.MAX_RESIDENT_K`` centers the kernel writes per-block partials added
in a fixed order; beyond it, fixed-point integer accumulators. Either way
a call gives the same bits on every run. The plain version is
``kernels.ref.lloyd_reduce_ref``; ``kernels.ops.lloyd_reduce`` picks by
device and passes the branch.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import (CudaKernel, blocks, check_on_card,
                                       dtype_code, ptr, stream_of, vector_f32)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

LLOYD_REDUCE = CudaKernel(
    "lloyd.cu", "rt_lloyd_reduce",
    [_P, _I, _L, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P])


def lloyd_reduce_cuda(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                      k: int, *, fixed_point: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((k, d) float32 sums of w_i·x_i, (k,) float32 sums of w_i) per
    assigned center; an assignment outside [0, k) adds nothing.

    ``fixed_point`` takes the (k, d + 1) int64 accumulators instead of the
    per-block partials, whose scratch is (k·d + k) floats a block of 256
    points. Finite inputs only.
    """
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
    out = torch.empty((k * d + k,), dtype=torch.float32, device=dev)
    if fixed_point:
        part = None
        bound = torch.empty((2,), dtype=torch.int32, device=dev)
        acc = torch.empty((k, d + 1), dtype=torch.int64, device=dev)
    else:
        part = torch.empty(((k * d + k) * blocks(n),), dtype=torch.float32,
                           device=dev)
        bound = acc = None
    LLOYD_REDUCE(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(a), k,
                 int(fixed_point), ptr(part), ptr(bound), ptr(acc), ptr(out),
                 stream_of(x))
    return out[:k * d].view(k, d), out[k * d:]
