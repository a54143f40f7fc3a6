"""CUDA kernel: the weighted cost split at a distance threshold.

Python wrapper over ``csrc/truncated.cu``, which replaces
``repro/kernels/truncated.py::truncated_cost_pallas``: one sweep of each
machine's points gives its kept cost (min-d2 ``<= v``), tail weight mass
and tail cost (``> v``); rows of weight 0 fall on neither side. The grid
covers every machine, so one launch returns the (m,) triples that kzmeans
psums; ``kernels.ops.truncated_cost`` also serves the reference's (n, d)
contract through it. The sums go through per-block partials added in a
fixed order: the same bits on every run. The plain version is
``kernels.ref.truncated_cost_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (CudaKernel, blocks, check_on_card,
                                       dtype_code, ptr, stream_of)
from repro_torch.kernels.min_dist import center_mask, centers_f32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

TRUNCATED_COST = CudaKernel(
    "truncated.cu", "rt_truncated_cost",
    [_P, _I, _I, _L, _I, _P, _P, _P, _I, _P, _P, _P, _P])


def truncated_cost_cuda(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                        v, c_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per machine of (m, p, d) points and (m, p) weights: ((m,) kept cost
    of the rows with min-d2 <= v, (m,) tail weight mass, (m,) tail cost),
    float32. ``v`` is read by the kernel through a device pointer."""
    if x.dim() != 3:
        raise ValueError(f"truncated_cost: points must be (m, p, d), got "
                         f"{tuple(x.shape)}")
    m, p, d = x.shape
    if w.shape != (m, p):
        raise ValueError(f"truncated_cost: w must be ({m}, {p}), got "
                         f"{tuple(w.shape)}")
    wf = w.to(torch.float32).contiguous()
    cf = centers_f32("truncated_cost", c, d)
    cv = center_mask("truncated_cost", c_valid, cf.shape[0])
    vt = torch.as_tensor(v, dtype=torch.float32, device=x.device).reshape(())
    check_on_card("truncated_cost", x, w=wf, centers=cf, c_valid=cv, v=vt)
    part = torch.empty((m * 3 * blocks(p),), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((m, 3), dtype=torch.float32, device=x.device)
    TRUNCATED_COST(ptr(x), dtype_code(x), m, p, d, ptr(wf), ptr(cf), ptr(cv),
                   cf.shape[0], ptr(vt), ptr(part), ptr(out), stream_of(x))
    return out[:, 0], out[:, 1], out[:, 2]
