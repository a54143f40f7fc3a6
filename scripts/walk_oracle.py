"""The walk oracle: each point's nearest valid center, found without the
walk kernels under test, on the card.

    from walk_oracle import equal_nan, misses, nearest

``nearest(ops, x, c, cv)`` folds the draw-off seeding step over the
valid centers one at a time, from d2 = +inf:
``ops.update_min_dist(x, w, c[j:j+1], d2)`` for each valid j in order.
A one-center step runs ``fused_lloyd.cu::tiled_seed_kernel`` at d > 16
(a thread a point, its own ``cp.async`` stages) and ``seed_walk`` at
d <= 16: no center tile, no argmin, none of the walks
(``csrc/common.cuh``: ``tiled_nearest``, ``nearest_split``) that
``min_dist``, the Lloyd kernel, ``remove_below``, ``sensitivity_scores``
and ``truncated_cost`` take. Each step computes a point's d2 to one
center with the walks' arithmetic (one fmaf chain over ascending
coordinates for x·c, ||x||^2 and ||c||^2, t = fmaf(-2, x·c, ||c||^2),
d2 = clamp0(t + ||x||^2)). Rounding and clamp0 are monotone, so the
running minimum is clamp0(min_j t_j + ||x||^2): a walk's d2, bit for bit.

A walk's argmin is held by its realized distance (``misses``): the
one-center d2 of the chosen center (the same step from +inf) equals the
minimum, and the center is valid; with no valid center every d2 is +inf
and every argmin 0. A tie may go to either center. Imports only
``torch``; ``ops`` is the caller's ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def nearest(ops, x: torch.Tensor, c: torch.Tensor,
            cv: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((n,) float32 least d2 over the valid centers of c, +inf with
    none; (k, n) float32 one-center d2 of each center, NaN for an invalid
    one) for the (n, d) points x, by the draw-off seeding step alone."""
    n, k = x.shape[0], c.shape[0]
    w = torch.ones(n, device=x.device)
    inf = torch.full((n,), torch.inf, device=x.device)
    d2 = inf
    each = torch.full((k, n), torch.nan, device=x.device)
    valid = range(k) if cv is None else cv.nonzero().flatten().tolist()
    for j in valid:
        cj = c[j:j + 1]
        d2 = ops.update_min_dist(x, w, cj, d2)[0]
        each[j] = ops.update_min_dist(x, w, cj, inf)[0]
    return d2, each


def misses(d2: torch.Tensor, each: torch.Tensor, got_d2: torch.Tensor,
           got_arg: torch.Tensor) -> Tuple[int, int]:
    """(points whose d2 differs from the oracle's ``d2``, points whose
    argmin's one-center d2 differs from it or names an invalid center;
    with no valid center, points whose argmin is not 0), from
    ``nearest``'s pair."""
    d2_miss = int((got_d2 != d2).sum())
    if bool(torch.isnan(each).all()):                 # no valid center
        return d2_miss, int((got_arg != 0).sum())
    real = each.gather(0, got_arg.long().view(1, -1))[0]
    return d2_miss, int((real != d2).sum())


def equal_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same values, NaN equal to NaN (with no valid center a weight of
    0 scores 0·inf)."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
