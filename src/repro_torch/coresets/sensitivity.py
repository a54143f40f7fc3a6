"""Per-machine sensitivity-sampling coreset construction.

The port of ``repro.coresets.sensitivity``. The classic recipe
(Feldman-Langberg; Bachem et al.; the distributed form of Balcan et al.
2013):

1. **Bicriteria solve** B: weighted k-means++ seeding with ``kb`` centers
   (``core.kmeans.kmeans_plusplus``: on the card one C call that
   launches one step of ``update_min_dist``'s kernel a center).
2. **Sensitivity scores**: one sweep (``kernels.ops.sensitivity_scores``,
   one launch) gives per-point weighted cost shares, assignments,
   per-cluster weight masses and cost(B), from which the standard
   sensitivity upper bound is assembled with (n,)-sized arithmetic only::

       sigma_i = w_i * d2_i / cost(B)  +  w_i / (|live B| * mass(B_i))

3. **Importance sample** ``t`` points iid with probability ``p ∝ sigma``
   (with replacement) by the inverse CDF of one ``torch.rand`` draw from
   the explicit generator (an exact prefix sum, ``kernels/exact.py``,
   + ``searchsorted``), and attach the
   Horvitz–Thompson weight ``u = w / (t * p)``, so every weighted cost
   estimate over the coreset is unbiased.

Zero-weight (dead or padded) points have ``sigma = 0`` and are never
drawn; an all-zero-weight shard gives an all-weight-0 coreset.
``build_coresets`` runs the recipe on every machine of (local_m, p, d)
shards as a host loop over the machines (the reference vmaps it): ``kb``
kernel launches a machine, m·kb a call, none of them waiting on the host;
``machine_data`` places a driver's shards and weights on the device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm import VirtualCluster
from repro_torch.core.kmeans import draw_seed, kmeans_plusplus
from repro_torch.kernels import ops
from repro_torch.kernels.exact import exact_cumsum


def default_coreset_size(k: int, n: Optional[int] = None) -> int:
    """Default total coreset budget: enough rows for a stable weighted
    clustering at the target k, never more than the data itself."""
    total = max(128, 40 * k)
    return min(total, n) if n else total


def sensitivity_sigma(x: torch.Tensor, w: torch.Tensor,
                      centers: torch.Tensor,
                      c_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) float32 sensitivity upper bounds of (x, w) against ``centers``;
    zero-weight points get 0."""
    scores, assign, mass, cost = ops.sensitivity_scores(x, w, centers,
                                                        c_valid)
    live = torch.clamp(torch.sum((mass > 0).to(torch.float32)), min=1.0)
    cost_term = torch.where(cost > 0,
                            scores / torch.clamp(cost, min=1e-30), 0.0)
    mass_at = torch.clamp(mass[assign.long()], min=1e-30)
    wf = w.to(torch.float32)
    cluster_term = wf / (live * mass_at)
    return torch.where(wf > 0, cost_term + cluster_term, 0.0)


def coreset_draws(gen: torch.Generator, t: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One machine's random inputs to ``build_coreset``, in the order it
    consumes them: the bicriteria seeding's key and the t uniforms of the
    inverse-CDF draw."""
    return draw_seed(gen, device), torch.rand((t,), generator=gen,
                                              device=device)


def build_coreset(gen: Optional[torch.Generator], x: torch.Tensor,
                  w: torch.Tensor, t: int, kb: int,
                  draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress weighted points (x, w) to a t-row sensitivity coreset.

    Args:
      gen: generator on ``x``'s device (None when ``draws`` is given).
      x: (n, d) points.
      w: (n,) nonnegative weights; 0 marks padded or dead rows.
      t: coreset rows (duplicates allowed).
      kb: bicriteria center count.
      draws: ``coreset_draws``' result, drawn before (None: drawn here
        from ``gen``).

    Returns:
      ((t, d) sampled points in ``x``'s dtype, (t,) float32 HT weights
      whose sum estimates sum(w)).
    """
    seed, u = coreset_draws(gen, t, x.device) if draws is None else draws
    centers = kmeans_plusplus(None, x, w, kb, seed=seed)
    sigma = sensitivity_sigma(x, w, centers)
    total = torch.sum(sigma)
    p = sigma / torch.clamp(total, min=1e-30)
    # t iid draws by inverse CDF: O(n + t) memory
    cdf = exact_cumsum(p)                # the same bits on every run
    u = u * cdf[-1]
    idx = torch.clamp(torch.searchsorted(cdf, u), 0, p.shape[0] - 1)
    pw = p[idx]
    wts = torch.where((pw > 0) & (total > 0),
                      w[idx].to(torch.float32)
                      / (t * torch.clamp(pw, min=1e-38)), 0.0)
    return x[idx], wts


def build_coresets(gen: torch.Generator, x: torch.Tensor, w: torch.Tensor,
                   t: int, kb: int, comm=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``build_coreset`` on each machine of (local_m, p, d) points and
    (local_m, p) weights: ((local_m, t, d) points, (local_m, t) weights).
    Every machine's draws come from ``gen`` in machine order
    (``comm.machine_draws``; None: a virtual cluster of ``x``'s
    machines), so a machine's coreset is the same on either backend."""
    comm = VirtualCluster(x.shape[0]) if comm is None else comm
    draws = comm.machine_draws(lambda: coreset_draws(gen, t, x.device))
    blocks = [build_coreset(None, x[j], w[j], t, kb, draws=draws[j])
              for j in range(x.shape[0])]
    return (torch.stack([b[0] for b in blocks]),
            torch.stack([b[1] for b in blocks]))


def machine_data(x_parts, w, alive, dev, backend=None):
    """(local_m, p, d) float32 points and (local_m, p) float32 weights on
    ``dev``, dead points weight 0: every machine's on the virtual backend
    (``backend`` None), this rank's on a mesh (``backend.put``)."""
    from repro_torch.api.backends import MACHINE, VirtualBackend
    m, p, _ = x_parts.shape
    w_np = np.ones((m, p), np.float32) if w is None else np.asarray(
        w, np.float32)
    if alive is not None:
        w_np = np.where(np.asarray(alive), w_np, 0.0).astype(np.float32)
    bk = VirtualBackend() if backend is None else backend
    return bk.put((np.asarray(x_parts, np.float32), w_np), MACHINE,
                  device=dev)
