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

``exact_row_sum`` takes its shift per row, so a row's sum does not
depend on the other rows: the same bits for machine j's row of a
virtual cluster's (m, p) tensor and a mesh rank's (1, p) block, where a
float ``torch.sum(dim=1)`` on the card may split the two differently.
"""
from __future__ import annotations

import torch


def _fixed_scale(vd: torch.Tensor, dim=None) -> torch.Tensor:
    """float64 2^s for the float64 terms ``vd`` (1 when all are 0): one
    for all of them, or one a row along ``dim`` (kept as a size-1
    axis)."""
    if dim is None:
        top = vd.abs().max() * vd.shape[0]
    else:
        top = vd.abs().amax(dim=dim, keepdim=True) * vd.shape[dim]
    _, e = torch.frexp(top)                              # top < 2^e
    s = torch.where(top > 0, 62 - e, 0)
    return torch.ldexp(torch.ones_like(top), s)


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


def exact_row_sum(v: torch.Tensor) -> torch.Tensor:
    """(r,) float32 sums of the rows of the (r, p) values ``v``, each row
    at its own fixed-point scale (a bool or integer ``v`` is summed as
    float32 too)."""
    return row_terms_sum(*row_terms(v))


def row_terms(v: torch.Tensor):
    """The (r, p) int64 fixed-point terms of the (r, p) values ``v`` and
    the (r, 1) float64 scale of each row (``exact_row_sum``'s). A subset
    of a row's terms sums exactly too, so a loop that sums masked subsets
    of one set of values quantizes them once: ``row_terms_sum(
    torch.where(mask, q, 0), scale)``."""
    vd = v.double()
    if vd.shape[-1] == 0:
        return vd.long(), vd.new_ones((*vd.shape[:-1], 1))
    scale = _fixed_scale(vd, dim=-1)
    return torch.round(vd * scale).long(), scale


def row_terms_sum(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(r,) float32 row sums of ``row_terms``' terms (or a subset)."""
    return (q.sum(dim=-1).double() / scale[..., 0]).float()


def fixed_shifts(bound: torch.Tensor, n: int):
    """The Lloyd kernel's (s_x, s_w) as () int tensors on the device, from
    its (2,) int32 bound words (float32 bits of max |w|, max |x|) and row
    count n: the largest s with b·2^s < 2^62 for b = n·max|w|·max|x| and
    n·max|w| (csrc/common.cuh::shifts), 0 where b is 0."""
    bf = bound.view(torch.float32).double()
    nd = torch.full((), float(n), dtype=torch.float64, device=bound.device)
    out = []
    for b in ((nd * bf[0]) * bf[1], nd * bf[0]):
        _, e = torch.frexp(b)                            # b < 2^e
        out.append(torch.where(b > 0, 62 - e, torch.zeros_like(e)))
    return out[0], out[1]


def pow2(s: torch.Tensor) -> torch.Tensor:
    """float64 2^s for integer tensors s in [-1022, 1023], built from the
    exponent bits: exact, on any device."""
    return ((s.to(torch.int64) + 1023) << 52).view(torch.float64)


def fixed_finalize(acc: torch.Tensor, bound: torch.Tensor, n: int):
    """(k, d + 1) int64 Lloyd accumulators -> ((k, d) float32 sums, (k,)
    float32 counts), as the kernel's finalize rounds them
    (csrc/common.cuh::fixed_finalize): each through float64, times
    2^-s, rounded once to float32."""
    sx, sw = fixed_shifts(bound, n)
    d = acc.shape[1] - 1
    return ((acc[:, :d].double() * pow2(-sx)).float(),
            (acc[:, d].double() * pow2(-sw)).float())
