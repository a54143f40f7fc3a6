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
* ``remove_below`` keeps a point only if its min-d2 is strictly ``> v``;
  ``truncated_cost`` keeps it below the threshold if ``<= v``, and a row
  of weight 0 falls on neither side;
* ``lloyd_reduce`` ignores an assignment outside [0, k), as the
  reference's one-hot and segment sum do.

Distances use the expanded form ``||x||^2 - 2 x.c + ||c||^2`` in float32,
as the reference and the CUDA kernels do, never ``sum((x - c)^2)``: at
the paper's σ = 0.001 with means in the unit cube, ``||x||^2 ~ 5`` while
a typical d2 ~ 1.5e-5, so the cancellation error is a few percent of d2,
and the removal threshold ``v`` is computed from these same d2 values.
Every implementation has to make the same error for v to mean the same
thing.
"""
from __future__ import annotations

import math
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


def lloyd_reduce_ref(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-center accumulation for a given assignment: ((k, d)
    sum of w_i x_i, (k,) sum of w_i per center).

    Up to ``CHUNK_K`` centers a weighted (n, k) one-hot times ``x``, as the
    reference's oracle (ref.py:226-231); beyond, a scatter-add with no
    (n, k) one-hot."""
    wf = w.float()
    xf = x.float()
    if k > CHUNK_K:
        a = assign.long()
        ok = (a >= 0) & (a < k)
        a, wk = a[ok], wf[ok]
        sums = torch.zeros((k, xf.shape[1]), dtype=torch.float32,
                           device=x.device)
        sums.index_add_(0, a, xf[ok] * wk[:, None])
        counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
        counts.index_add_(0, a, wk)
        return sums, counts
    onehot = (assign[:, None] == torch.arange(k, dtype=assign.dtype,
                                              device=x.device)[None, :])
    onehot = onehot.to(torch.float32) * wf[:, None]
    return onehot.T @ xf, torch.sum(onehot, dim=0)


def sensitivity_from_min(w: torch.Tensor, d2: torch.Tensor,
                         assign: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(scores, assign, mass, cost) from a finished min-distance pass: the
    tail of the sensitivity pass, (n,)- and (k,)-sized only (no sweep of
    the points). ``ops`` also runs it after the ``min_dist`` kernel for
    center sets beyond the resident limit."""
    wf = w.float()
    scores = wf * d2.float()
    mass = torch.zeros((k,), dtype=torch.float32, device=w.device)
    mass.index_add_(0, assign.long(), wf)
    return scores, assign.to(torch.int32), mass, torch.sum(scores)


def sensitivity_scores_ref(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                           c_valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """The coreset sensitivity pass: ((n,) scores w_i·min-d2_i, (n,) int32
    argmin, (k,) weight mass per center, () weighted cost of ``c``).

    A point is assigned to a valid center whenever one exists, so invalid
    centers get no mass. With none valid (outside the reference's
    contract) every d2 is +inf, every point goes to center 0, which takes
    the whole mass, and the scores are w·inf (NaN at w = 0)."""
    d2, assign = min_dist_ref(x, c, c_valid)
    return sensitivity_from_min(w, d2, assign, c.shape[0])


def truncated_from_min(w: torch.Tensor, d2: torch.Tensor, v
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(kept cost, tail mass, tail cost) from a finished min-distance pass,
    summed over the last axis: scalars for (n,) inputs, (m,) for (m, p)."""
    wf = w.float()
    s = torch.where(wf > 0, wf * d2.float(), 0.0)
    below = d2 <= v
    return (torch.sum(torch.where(below, s, 0.0), dim=-1),
            torch.sum(torch.where(below, 0.0, wf), dim=-1),
            torch.sum(torch.where(below, 0.0, s), dim=-1))


def truncated_cost_ref(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, v,
                       c_valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weighted cost of ``c`` split at the threshold ``v``: (kept cost
    of the rows with min-d2 <= v, tail weight mass and tail cost of those
    with min-d2 > v); rows of weight 0 fall on neither side.

    ``x`` is (n, d) with (n,) ``w`` (scalars out), or (m, p, d) machine
    shards with (m, p) ``w`` (one triple a machine, (m,) each)."""
    d = x.shape[-1]
    d2, _ = min_dist_ref(x.reshape(-1, d), c, c_valid)
    return truncated_from_min(w, d2.reshape(w.shape), v)


def fused_assign_reduce_ref(x: torch.Tensor, w: torch.Tensor,
                            c: torch.Tensor,
                            c_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One Lloyd step: ((k, d) sum of w_i x_i per assigned center, (k,)
    sum of w_i per center, () sum of w_i * min-d2_i — the cost of ``c``).

    The plain version of the CUDA kernel, which serves every number of
    centers; the kernel's exact sums are ``fixed_point_reduce_ref``'s."""
    d2, assign = min_dist_ref(x, c, c_valid)
    k, d = c.shape
    wf = w.float()
    a = assign.long()
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    sums.index_add_(0, a, x.float() * wf[:, None])
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, a, wf)
    return sums, counts, torch.sum(wf * d2)


def fixed_shift(b: float) -> int:
    """The largest s with b·2^s < 2^62 (0 when b is not > 0), as
    ``csrc/common.cuh::fixed_shift``."""
    if not b > 0.0:
        return 0
    return 62 - math.frexp(b)[1]


def fixed_point_reduce_ref(x: torch.Tensor, w: torch.Tensor,
                           assign: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Lloyd kernel's own arithmetic for its ((k, d) sums, (k,)
    counts), given the (n,) assignment: the exact oracle the card's
    ``fused_assign_reduce`` matches bit for bit (``csrc/fused_assign.cu``).

    max |w| over every row and max |x| over the rows with w != 0, in
    float32; the shifts from ((double)n·max|w|)·max|x| and n·max|w| as
    ``common.cuh::shifts``; each term w·x_q (exact in float64) scaled by
    2^s and rounded half to even to an int64, as ``llrint``; an int64
    ``index_add_`` (exact in any order); back through float64 and 2^-s to
    float32. An assignment outside [0, k) adds nothing. A check's oracle,
    never on the main path: it reads the bounds back to the host."""
    n, d = x.shape
    xf, wf = x.float(), w.float()
    mw = float(wf.abs().max()) if n else 0.0
    weighted = wf != 0
    mx = float(xf[weighted].abs().max()) if bool(weighted.any()) else 0.0
    sx = fixed_shift(float(n) * mw * mx)
    sw = fixed_shift(float(n) * mw)
    a = assign.long()
    ok = (a >= 0) & (a < k)
    a, wd = a[ok], wf[ok].double()
    tx = torch.round(wd[:, None] * xf[ok].double() * 2.0 ** sx).long()
    tw = torch.round(wd * 2.0 ** sw).long()
    acc_x = torch.zeros((k, d), dtype=torch.int64,
                        device=x.device).index_add_(0, a, tx)
    acc_w = torch.zeros((k,), dtype=torch.int64,
                        device=x.device).index_add_(0, a, tw)
    return ((acc_x.double() * 2.0 ** -sx).float(),
            (acc_w.double() * 2.0 ** -sw).float())


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
