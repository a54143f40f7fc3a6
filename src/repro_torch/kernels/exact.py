"""Float sums that give the same bits on every run, on any device.

A floating-point ``torch.cumsum`` or ``index_add_`` on the card combines
its terms in an order that changes from run to run (PyTorch lists both
among its nondeterministic operations), so a draw or threshold read off
one can change between two runs of one seed. These take the sums in
64-bit fixed point instead, as ``ref.fixed_point_reduce_ref`` does, with
the shift found on the device (no host read): integer sums are exact in
any order. Each term is rounded once to 2^-s, s the largest shift with
n·max|v|·2^s < 2^62, and each sum once to float32 (``exact_cumsum``
may keep float64). Finite inputs only.
"""
from __future__ import annotations

import torch


def _fixed_scale(vd: torch.Tensor) -> torch.Tensor:
    """() float64 2^s for the float64 terms ``vd`` (1 when all are 0)."""
    top = vd.abs().max() * vd.shape[0]
    _, e = torch.frexp(top)                              # top < 2^e
    s = torch.where(top > 0, 62 - e, 0)
    return torch.ldexp(torch.ones((), dtype=torch.float64, device=vd.device),
                       s)


def exact_cumsum(v: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n,) inclusive prefix sums of the (n,) values ``v``, rounded once
    to ``dtype`` (float64 keeps a row's share of a total past 2^24)."""
    vd = v.double()
    if vd.shape[0] == 0:
        return vd.to(dtype)
    scale = _fixed_scale(vd)
    q = torch.round(vd * scale).long()
    return (torch.cumsum(q, 0).double() / scale).to(dtype)


def exact_index_add(v: torch.Tensor, index: torch.Tensor,
                    k: int) -> torch.Tensor:
    """(k,) float32 sums of the (n,) values ``v`` by their index in
    [0, k)."""
    vd = v.double()
    out = torch.zeros((k,), dtype=torch.int64, device=v.device)
    if vd.shape[0] == 0:
        return out.float()
    scale = _fixed_scale(vd)
    out.index_add_(0, index.long(), torch.round(vd * scale).long())
    return (out.double() / scale).float()
