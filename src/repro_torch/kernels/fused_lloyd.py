"""CUDA kernels: one-sweep fused clustering passes.

Python wrappers over ``csrc/fused_lloyd.cu``, which replaces the
resident-center kernels of ``repro/kernels/fused_lloyd.py``:

* ``remove_below_cuda`` — SOCCER's removal over (m, p, d) shards: min-d2,
  the strict ``> v`` compare, the alive-mask update and per-machine live
  counts in one sweep (replaces ``remove_below_pallas``);
* ``update_min_dist_cuda`` — one D²-seeding step: ``min(d2, d2(x, c))``
  and the weighted mass ``sum w·d2_new`` (replaces
  ``update_min_dist_pallas`` and its pipelined big-n twin);
* ``fused_assign_reduce_cuda`` — one Lloyd step: assignment, weighted
  (k, d) sums, (k,) counts and the cost in one sweep (replaces
  ``fused_assign_reduce_pallas`` and its pipelined big-n twin);
* ``fused_assign_reduce_chunked_cuda`` — the same step for any number of
  centers (``csrc/fused_chunked.cu``; replaces
  ``fused_assign_reduce_chunked_pallas`` and its two-walk fallback
  ``_fused_assign_reduce_chunked_twopass``).

Float sums across blocks go through per-block partials reduced in a
fixed order, or, in the chunked kernel, through fixed-point integer
accumulators, so each call gives the same bits on every run. The plain
versions are in ``kernels/ref.py``; ``kernels/ops.py`` picks by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (CudaKernel, blocks, check_on_card,
                                       dtype_code, ptr, stream_of, vector_f32)
from repro_torch.kernels.min_dist import center_mask, centers_f32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

REMOVE_BELOW = CudaKernel(
    "fused_lloyd.cu", "rt_remove_below",
    [_P, _I, _I, _L, _I, _P, _P, _I, _P, _P, _P, _P, _P])
UPDATE_MIN_DIST = CudaKernel(
    "fused_lloyd.cu", "rt_update_min_dist",
    [_P, _I, _L, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P])
FUSED_ASSIGN_REDUCE = CudaKernel(
    "fused_lloyd.cu", "rt_fused_assign_reduce",
    [_P, _I, _L, _I, _P, _P, _P, _I, _P, _P, _P])
FUSED_ASSIGN_REDUCE_CHUNKED = CudaKernel(
    "fused_chunked.cu", "rt_fused_assign_reduce_chunked",
    [_P, _I, _L, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P])


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
    part = torch.empty((blocks(n),), dtype=torch.float32, device=x.device)
    mass = torch.empty((), dtype=torch.float32, device=x.device)
    UPDATE_MIN_DIST(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(d2f), ptr(cf),
                    ptr(cv), cf.shape[0], ptr(d2_new), ptr(part), ptr(mass),
                    stream_of(x))
    return d2_new, mass


def fused_assign_reduce_cuda(x: torch.Tensor, w: torch.Tensor,
                             c: torch.Tensor,
                             c_valid: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """((k, d) weighted sums, (k,) weight counts, () weighted cost)."""
    if x.dim() != 2:
        raise ValueError(f"fused_assign_reduce: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    wf = vector_f32("fused_assign_reduce", "w", w, n)
    cf = centers_f32("fused_assign_reduce", c, d)
    k = cf.shape[0]
    cv = center_mask("fused_assign_reduce", c_valid, k)
    check_on_card("fused_assign_reduce", x, w=wf, centers=cf, c_valid=cv)
    rows = k * d + k + 1
    part = torch.empty((rows * blocks(n),), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    FUSED_ASSIGN_REDUCE(ptr(x), dtype_code(x), n, d, ptr(wf), ptr(cf),
                        ptr(cv), k, ptr(part), ptr(out), stream_of(x))
    return out[:k * d].view(k, d), out[k * d:k * d + k], out[k * d + k]


def fused_assign_reduce_chunked_cuda(x: torch.Tensor, w: torch.Tensor,
                                     c: torch.Tensor,
                                     c_valid: Optional[torch.Tensor] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """``fused_assign_reduce_cuda`` for any number of centers: ((k, d)
    weighted sums, (k,) weight counts, () weighted cost).

    Scratch is (k, d + 1) int64 fixed-point accumulators and one float per
    block of points, whatever k is; the sums are exact integer additions,
    so a call gives the same bits on every run (``csrc/fused_chunked.cu``
    says how the fixed-point scale is chosen). Finite inputs only.
    """
    if x.dim() != 2:
        raise ValueError(f"fused_assign_reduce: points must be (n, d), got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    wf = vector_f32("fused_assign_reduce", "w", w, n)
    cf = centers_f32("fused_assign_reduce", c, d)
    k = cf.shape[0]
    cv = center_mask("fused_assign_reduce", c_valid, k)
    check_on_card("fused_assign_reduce", x, w=wf, centers=cf, c_valid=cv)
    bound = torch.empty((2,), dtype=torch.int32, device=x.device)
    acc = torch.empty((k, d + 1), dtype=torch.int64, device=x.device)
    part = torch.empty((blocks(n),), dtype=torch.float32, device=x.device)
    out = torch.empty((k * d + k + 1,), dtype=torch.float32, device=x.device)
    FUSED_ASSIGN_REDUCE_CHUNKED(ptr(x), dtype_code(x), n, d, ptr(wf),
                                ptr(cf), ptr(cv), k, ptr(bound), ptr(acc),
                                ptr(part), ptr(out), stream_of(x))
    return out[:k * d].view(k, d), out[k * d:k * d + k], out[k * d + k]
