"""Weighted reduction of an oversampled center set to exactly k centers
(the port of ``repro.core.reduce``).

SOCCER outputs more than k centers; the standard recipe (paper §2, Guha
et al. 2003 Thm. 4) weighs each center by the mass of data assigned to
it and runs a centralized weighted k-means over the centers.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kmeans import kmeans
from repro_torch.core.metrics import assignment_counts


def reduce_to_k(gen: torch.Generator, centers: torch.Tensor,
                weights: torch.Tensor, k: int, iters: int = 25
                ) -> torch.Tensor:
    """Weighted k-means over the center set itself -> (k, d)."""
    out, _ = kmeans(gen, centers, weights, k, iters)
    return out


def weighted_reduce(gen: torch.Generator, comm, x: torch.Tensor,
                    w: torch.Tensor, centers: torch.Tensor,
                    centers_valid: Optional[torch.Tensor] = None,
                    *, k: int, iters: int = 25) -> torch.Tensor:
    """Weigh C_out by data assignment, then reduce it to k centers."""
    counts = assignment_counts(comm, x, w, centers, centers_valid)
    if centers_valid is not None:
        counts = counts * centers_valid.to(counts.dtype)
    return reduce_to_k(gen, centers, counts, k, iters)
