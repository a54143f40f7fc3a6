"""MiniBatchKMeans black box (paper Appendix D.2's faster coordinator).

The port of ``repro.core.minibatch``: Sculley-style mini-batch k-means
with per-center learning rates 1/N_c. Seeding is k-means++ on the first
``min(n, 16k)`` rows, then ``steps`` updates, each on ``batch`` rows
drawn ∝ w with replacement and each one ``ops.fused_assign_reduce``
launch, then one cost on the full weighted set.

The reference draws each batch with ``jax.random.categorical``. Here the
CDF of w is built once with ``kernels.exact.exact_cumsum`` (a float
``torch.cumsum`` on the card changes from run to run) and each batch is
one ``searchsorted`` of uniforms from the generator, so a fit on the card
repeats bit for bit and no step reads anything back to the host. The CDF
and the uniforms are float64: in float32 a uniform times a total of 10 M
unit weights falls on a grid of spacing ~0.6, which draws some rows twice
as often as others.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.kmeans import kmeans_plusplus
from repro_torch.kernels import ops
from repro_torch.kernels.exact import exact_cumsum


def row_sampler(cdf: torch.Tensor):
    """A draw of (batch,) row indices ∝ the weights whose float64
    inclusive prefix sums are ``cdf``, with replacement:
    ``draw(gen, batch)``. A row of weight 0 is never drawn (an index is
    clamped to the last row of positive weight, found once here)."""
    total = cdf[-1]
    last = torch.sum(cdf < total)

    def draw(gen: torch.Generator, batch: int) -> torch.Tensor:
        u = torch.rand((batch,), generator=gen, dtype=cdf.dtype,
                       device=cdf.device) * total
        return torch.minimum(torch.searchsorted(cdf, u, right=True), last)

    return draw


def minibatch_kmeans(gen: torch.Generator, x: torch.Tensor, w: torch.Tensor,
                     k: int, batch: int = 1024, steps: int = 60
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ((k, d) float32 centers, () cost on the full weighted set).

    ``x`` may be bfloat16 or float16 (a narrow uplink's payload): the
    seeding and every Lloyd step widen on load with float32 accumulators.
    """
    n = x.shape[0]
    m0 = min(n, 16 * k)
    c = kmeans_plusplus(gen, x[:m0], w[:m0], k)
    draw = row_sampler(exact_cumsum(w.to(torch.float32), torch.float64))
    ones = torch.ones((batch,), dtype=torch.float32, device=x.device)
    n_c = torch.zeros((k,), dtype=torch.float32, device=x.device)
    for _ in range(steps):
        xb = torch.index_select(x, 0, draw(gen, batch))
        sums, counts, _ = ops.fused_assign_reduce(xb.to(torch.float32),
                                                  ones, c)
        n_c = n_c + counts
        lr = torch.where(n_c > 0, counts / torch.clamp(n_c, min=1.0), 0.0)
        mean_b = sums / torch.clamp(counts[:, None], min=1e-30)
        c = c + lr[:, None] * (torch.where(counts[:, None] > 0, mean_b, c)
                               - c)
    _, _, cost = ops.fused_assign_reduce(x, w, c)
    return c, cost
