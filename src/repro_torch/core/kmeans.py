"""Centralized weighted k-means black box A (the port of
``repro.core.kmeans``).

Weighted k-means++ seeding (Gumbel-max categorical D²-sampling, one
``update_min_dist`` launch per new center) followed by weighted Lloyd
iterations (one ``fused_assign_reduce`` launch per iteration plus one for
the final cost), so the same kernels serve the machines and the
coordinator. Zero-weight rows are padding and never selected; empty
clusters keep their previous center.

PyTorch runs eagerly: the reference's ``lax.scan`` loops are Python loops
here, and no value is read back to the host inside them, so a fit on the
card queues its launches without waiting.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sampling import gumbel_argmax
from repro_torch.kernels import ops


def pick_row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a () index on the device) of ``x``, without reading the
    index back to the host as ``x[i]`` would."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def kmeans_plusplus(gen: torch.Generator, x: torch.Tensor, w: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Weighted D²-seeding. Returns (k, d) float32 initial centers.

    Each seeding step is one fused sweep of ``x`` (``ops.update_min_dist``)
    that lowers the running min-d2 against the newly chosen center and
    totals the weighted mass for the next draw: k - 1 launches in all.
    """
    n, d = x.shape
    centers = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    centers[0] = pick_row(x, gumbel_argmax(gen, w))
    d2min = torch.full((n,), torch.inf, dtype=torch.float32, device=x.device)
    for i in range(1, k):
        d2min, mass = ops.update_min_dist(x, w, centers[i - 1:i], d2min)
        # all-zero mass (every point on a center) -> fall back to uniform w
        p = torch.where(mass > 0, w * d2min, w)
        centers[i] = pick_row(x, gumbel_argmax(gen, p))
    return centers


def lloyd(x: torch.Tensor, w: torch.Tensor, centers: torch.Tensor,
          iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Lloyd. Returns ((k, d) float32 centers, () final cost).

    Each iteration, and the final cost, is one fused assign+reduce sweep
    of ``x`` (``ops.fused_assign_reduce``).
    """
    c = centers.to(torch.float32)
    for _ in range(iters):
        sums, counts, _ = ops.fused_assign_reduce(x, w, c)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts[:, None], min=1e-30), c)
    _, _, cost = ops.fused_assign_reduce(x, w, c)
    return c, cost


def kmeans(gen: torch.Generator, x: torch.Tensor, w: torch.Tensor, k: int,
           iters: int = 25) -> Tuple[torch.Tensor, torch.Tensor]:
    """A(S, k): weighted k-means++ + Lloyd. Returns ((k, d) centers, cost)."""
    return lloyd(x, w, kmeans_plusplus(gen, x, w, k), iters)
