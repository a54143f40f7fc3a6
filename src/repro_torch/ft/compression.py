"""Payload compression: affine int8 quantization + top-k error feedback.

The port of ``repro.ft.compression``. Two wire-shrinking mechanisms:

* **Affine int8 quantization** — the ``uplink_dtype="int8"`` path of the
  clustering uplinks. A payload is mapped to 256 levels spanning its own
  range, ``q = round((x - zp) / scale)`` (round half to even, as
  ``jnp.round``), with one (scale, zero-point) pair per payload, or per
  machine for a ``(machine, rows, d)`` batch. The pair rides the metadata
  channel; ``fake_quantize_int8`` returns the float32 reconstruction the
  coordinator decodes, so the clustering needs no int8 kernel, and the
  accounting charges 1 byte a coordinate. The codes equal the
  reference's bit for bit: the same float32 operations in the same order.
* **Top-k + error feedback** — each machine sends only its top-k
  magnitude entries (values + int32 indices) and keeps the residual in a
  local error-feedback accumulator (Stich et al.).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.comm import record_wire


def affine_qparams(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-payload affine code book: (scale, zero_point) spanning
    [min, max] with 256 levels (a constant payload gets a tiny positive
    scale, so dequantization is exact).

    A 2-d payload gets scalar qparams; a higher-rank payload is a
    (machine, rows, d) batch and gets one code book per leading entry,
    kept as (m, 1, 1) so it broadcasts over the batch."""
    xf = x.to(torch.float32)
    if xf.dim() > 2:
        lo = torch.amin(xf, dim=(-2, -1), keepdim=True)
        hi = torch.amax(xf, dim=(-2, -1), keepdim=True)
    else:
        lo, hi = torch.min(xf), torch.max(xf)
    scale = torch.clamp((hi - lo) / 255.0, min=1e-12)
    return scale, lo


def quantize_affine_int8(x: torch.Tensor, scale: torch.Tensor,
                         zp: torch.Tensor) -> torch.Tensor:
    """float32 -> int8 codes in [-128, 127] (level 0 at the payload min)."""
    q = torch.round((x.to(torch.float32) - zp) / scale)
    return (torch.clamp(q, 0.0, 255.0) - 128.0).to(torch.int8)


def dequantize_affine_int8(q: torch.Tensor, scale: torch.Tensor,
                           zp: torch.Tensor) -> torch.Tensor:
    """int8 codes -> float32 reconstruction on the 256-level grid."""
    return (q.to(torch.float32) + 128.0) * scale + zp


def fake_quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize round trip: float32 values on the int8 grid,
    exactly what the coordinator decodes from an int8 upload."""
    scale, zp = affine_qparams(x)
    return dequantize_affine_int8(quantize_affine_int8(x, scale, zp),
                                  scale, zp)


def topk_compress(g: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten, keep the top-k entries by |value|: ((k,) values,
    (k,) int32 indices)."""
    flat = g.reshape(-1)
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx.to(torch.int32)


def topk_wire_bytes(m: int, k: int, dtype) -> int:
    """The top-k gather's wire width: every machine ships k (value, int32
    index) pairs of the ``dtype`` (a torch dtype or its name).
    ``compressed_psum`` records this and returns it, so the modeled and
    the measured bytes are one number."""
    if not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, str(dtype))
    return int(m) * int(k) * (dtype.itemsize + 4)


def compressed_psum(comm, g: torch.Tensor, err: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Error-feedback top-k mean over machines.

    Args:
      g: (m, ...) per-machine gradients.
      err: (m, ...) error-feedback state (same shape).
      k: entries kept per machine.

    Returns:
      (mean gradient estimate (...), new err (m, ...), wire bytes).
    """
    corrected = g + err
    flat = corrected.reshape(corrected.shape[0], -1)
    _, idx = torch.topk(flat.abs(), k, dim=1)
    sparse = torch.zeros_like(flat).scatter_(1, idx, torch.gather(flat, 1,
                                                                  idx))
    sparse = sparse.reshape(corrected.shape)
    # the wire is the k (value, index) pairs a machine, not the dense sum
    # below; record the former and sum through the raw collective
    comm_bytes = topk_wire_bytes(comm.m, k, g.dtype)
    record_wire(payload=comm_bytes)
    total = comm._reduce(sparse) / comm.m
    return total, corrected - sparse, comm_bytes


def init_error_feedback(g_like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(g_like)
