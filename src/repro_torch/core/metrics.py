"""Cost / assignment utilities (the port of ``repro.core.metrics``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def centralized_cost(x: torch.Tensor, centers: torch.Tensor,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_i w_i * min_j ||x_i - c_j||^2 on one device."""
    d2, _ = ops.min_dist(x, centers)
    if w is None:
        return torch.sum(d2)
    return torch.sum(w.to(torch.float32) * d2)


def distributed_cost(comm, x: torch.Tensor, w: torch.Tensor,
                     centers: torch.Tensor,
                     centers_valid: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Global k-means cost of replicated ``centers`` over sharded ``x``
    ((m, p, d) points, (m, p) weights; weight 0 = ignore)."""
    m, p, d = x.shape
    d2, _ = ops.min_dist(x.reshape(m * p, d), centers, centers_valid)
    local = torch.sum(w.to(torch.float32) * d2.reshape(m, p), dim=1)
    return comm.psum(local)


def assignment_counts(comm, x: torch.Tensor, w: torch.Tensor,
                      centers: torch.Tensor,
                      centers_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Per-center total assigned weight of the full dataset (replicated):
    each machine's pass is one Lloyd step (the baselines' weighing of
    their oversampled sets)."""
    local = torch.stack([
        ops.fused_assign_reduce(x[j], w[j], centers, centers_valid)[1]
        for j in range(x.shape[0])])                 # (m, k)
    return comm.psum(local)
