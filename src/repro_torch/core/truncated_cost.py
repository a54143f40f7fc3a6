"""Weighted l-truncated cost and the SOCCER removal threshold.

The port of ``repro.core.truncated_cost``. ``cost_l(S, T)`` (paper §5) is
the clustering cost after removing the ``l`` points of ``S`` that incur
the most cost. Samples carry Horvitz–Thompson weights (w_i ≈ 1/α), so the
weighted generalization drops the highest-cost points totalling ``L``
units of weight mass, the boundary point counted fractionally. Sorting is
stable (``argsort(-d2, stable=True)``, as ``jnp.argsort``), so results
equal the reference's up to float32 summation order.
"""
from __future__ import annotations

import torch


def _sorted_desc(d2: torch.Tensor, w: torch.Tensor):
    order = torch.argsort(-d2, stable=True)
    return order, d2[order].to(torch.float32), w[order].to(torch.float32)


def weighted_truncated_cost(d2: torch.Tensor, w: torch.Tensor,
                            trunc_mass) -> torch.Tensor:
    """Sum of w*d2 after dropping ``trunc_mass`` weight of the largest d2."""
    _, d2s, ws = _sorted_desc(d2, w)
    cum = torch.cumsum(ws, 0)          # inclusive, in descending-d2 order
    kept = torch.minimum(torch.clamp(cum - trunc_mass, min=0.0), ws)
    return torch.sum(kept * d2s)


def weighted_top_mass(d2: torch.Tensor, w: torch.Tensor,
                      mass) -> torch.Tensor:
    """Sum of w*d2 over the ``mass`` heaviest-cost weight units (the
    complement of ``weighted_truncated_cost``)."""
    _, d2s, ws = _sorted_desc(d2, w)
    cum_ex = torch.cumsum(ws, 0) - ws                  # exclusive
    taken = torch.minimum(torch.clamp(mass - cum_ex, min=0.0), ws)
    return torch.sum(taken * d2s)


def trim_top_mass(d2: torch.Tensor, w: torch.Tensor, mass) -> torch.Tensor:
    """(n,) float32 kept weights after dropping ``mass`` weight of the
    largest d2, in the original point order (``0 <= kept <= w`` and
    ``sum(kept * d2) == weighted_truncated_cost(d2, w, mass)``)."""
    order, _, ws = _sorted_desc(d2, w)
    kept = torch.minimum(torch.clamp(torch.cumsum(ws, 0) - mass, min=0.0), ws)
    out = torch.empty_like(kept)
    out[order] = kept
    return out


def removal_threshold(d2: torch.Tensor, w: torch.Tensor, k: int, d_k: float,
                      alpha: torch.Tensor,
                      outlier_mass=0.0) -> torch.Tensor:
    """SOCCER line 9: v = 2·cost_{3/2(k+1)d_k}(P2, C_iter) / (3·k·d_k).

    With HT weights this is v = ψ·α/(k·d_k), ψ = (2/3)·Σ_kept w·d2, where
    the truncated sample count l = 3/2·(k+1)·d_k is weight mass L = l/α.
    """
    trunc_mass = (1.5 * (k + 1) * d_k / torch.clamp(alpha, min=1e-30)
                  + outlier_mass)
    psi = (2.0 / 3.0) * weighted_truncated_cost(d2, w, trunc_mass)
    return psi * alpha / (k * d_k)
