"""Plain PyTorch versions of the port's kernels.

These are the semantics of record, as ``repro.kernels.ref`` is for the
JAX package: the CPU tests hold them against the JAX oracles on the same
numpy inputs, ``kernels/ops.py`` runs them for tensors on the CPU, and
``chip_smoke.py`` holds every CUDA kernel against them on the card.

Semantics carried over from the reference (``repro/kernels/ref.py``):

* invalid centers are +inf, and a point with no valid center gets
  index 0 (``torch.min`` returns the first index of the minimum);
* ``min_dist`` takes the min of ``||c||^2 - 2 x.c`` and adds ``||x||^2``
  after it, then clamps at >= 0 (ref.py:72-73);
* ``update_min_dist`` is an exact no-op on ``d2`` when no center is
  valid (+inf candidates);
* ``remove_below`` keeps a point only if its min-d2 is strictly ``> v``.

Distances use the expanded form ``||x||^2 - 2 x.c + ||c||^2`` in float32,
as the reference and the CUDA kernels do, never ``sum((x - c)^2)``: at
the paper's σ = 0.001 with means in the unit cube, ``||x||^2 ~ 5`` while
a typical d2 ~ 1.5e-5, so the cancellation error is a few percent of d2,
and the removal threshold ``v`` is computed from these same d2 values.
Every implementation has to make the same error for v to mean the same
thing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


# center-panel size; bounds the live (n, panel) distance matrix
# (repro/kernels/ref.py:15: EIM11's clustering reaches 173 k rows)
CHUNK_K = 4096


def min_dist_ref(x: torch.Tensor, c: torch.Tensor,
                 c_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) float32 min_j ||x_i - c_j||^2 over valid centers (>= 0) and
    (n,) int32 argmin.

    The centers are walked in panels of ``CHUNK_K`` with a running (min,
    argmin), as the reference's oracle does, so the (n, k) matrix never
    exists; a later panel wins only if strictly nearer, so ties keep the
    first index.
    """
    xf = x.float()
    cf = c.float()
    best = arg = None
    for j0 in range(0, cf.shape[0], CHUNK_K):
        cp = cf[j0:j0 + CHUNK_K]
        d2 = -2.0 * (xf @ cp.T) + torch.sum(cp * cp, dim=-1)[None, :]
        if c_valid is not None:
            d2 = torch.where(c_valid[None, j0:j0 + CHUNK_K], d2, torch.inf)
        dmin, loc = torch.min(d2, dim=-1)
        del d2
        if best is None:
            best, arg = dmin, loc
        else:
            better = dmin < best
            arg = torch.where(better, loc + j0, arg)
            best = torch.where(better, dmin, best)
    x2 = torch.sum(xf * xf, dim=-1)
    return torch.clamp(best + x2, min=0.0), arg.to(torch.int32)


def update_min_dist_ref(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                        d2: torch.Tensor,
                        c_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One D²-seeding step: ((n,) min(d2, min-d2 to ``c``), () sum w*d2_new).

    ``min_dist_ref`` returns +inf with zero valid centers, so the min is
    already the required no-op.
    """
    cand, _ = min_dist_ref(x, c, c_valid)
    d2_new = torch.minimum(d2.float(), cand)
    return d2_new, torch.sum(w.float() * d2_new)


def fused_assign_reduce_ref(x: torch.Tensor, w: torch.Tensor,
                            c: torch.Tensor,
                            c_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One Lloyd step: ((k, d) sum of w_i x_i per assigned center, (k,)
    sum of w_i per center, () sum of w_i * min-d2_i — the cost of ``c``).

    The plain version of both the resident and the chunked CUDA kernel:
    the function does not depend on how many centers there are."""
    d2, assign = min_dist_ref(x, c, c_valid)
    k, d = c.shape
    wf = w.float()
    a = assign.long()
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    sums.index_add_(0, a, x.float() * wf[:, None])
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, a, wf)
    return sums, counts, torch.sum(wf * d2)


def remove_below_ref(x: torch.Tensor, c: torch.Tensor, alive: torch.Tensor,
                     v: torch.Tensor,
                     c_valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SOCCER removal over (m, p, d) shards: ((m, p) bool
    ``alive & (min-d2 > v)``, (m,) int32 surviving counts)."""
    m, p, d = x.shape
    d2, _ = min_dist_ref(x.reshape(m * p, d), c, c_valid)
    alive_new = alive & (d2.reshape(m, p) > v)
    return alive_new, torch.sum(alive_new, dim=1, dtype=torch.int32)
