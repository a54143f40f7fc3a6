"""Centralized weighted k-means black box A (the port of
``repro.core.kmeans``).

Weighted k-means++ seeding (Gumbel-max categorical D²-sampling) followed
by weighted Lloyd iterations (one ``fused_assign_reduce`` launch per
iteration plus one for the final cost), so the same kernels serve the
machines and the coordinator. Zero-weight rows are padding and never
selected; empty clusters keep their previous center.

The reference's seeding is a ``lax.scan`` in which XLA fuses the draw
into each ``update_min_dist`` step; here the whole loop is one entry
point (``ops.kmeans_plusplus_indices``), on the card one C call that
launches the k steps of ``update_min_dist``'s kernel with its draw on.
The Lloyd loop stays in Python; nothing inside either loop is read back
to the host, so a fit on the card queues its launches without waiting.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def pick_row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a () index on the device) of ``x``, without reading the
    index back to the host as ``x[i]`` would."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def draw_seed(gen: torch.Generator, device) -> torch.Tensor:
    """A seeding's 64-bit Philox key, a (2,) int64 tensor drawn from
    ``gen``."""
    return torch.randint(0, 1 << 32, (2,), generator=gen, device=device,
                         dtype=torch.int64)


def kmeans_plusplus(gen: Optional[torch.Generator], x: torch.Tensor,
                    w: torch.Tensor, k: int,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted D²-seeding. Returns (k, d) float32 initial centers.

    Draws the seeding's 64-bit Philox key from ``gen`` (on ``x``'s
    device; or takes ``seed``, one drawn before by ``draw_seed``), runs
    the k steps in ``ops.kmeans_plusplus_indices`` and gathers the chosen
    rows with one ``index_select``.
    """
    if seed is None:
        seed = draw_seed(gen, x.device)
    idx = ops.kmeans_plusplus_indices(x, w, k, seed)
    return torch.index_select(x, 0, idx).to(torch.float32)


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
