"""Public entry points over the clustering kernels, dispatched by device.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written CUDA kernel, or the call raises —
there is no fallback from the card to a plain version. The CUDA kernels
loop over d, so every feature width runs on the kernel.

Entry points (``ENTRY_POINTS``; the CPU tests cover every one against the
JAX package's oracles):

* ``min_dist(x, c, c_valid)`` — (n,) min-d2 + argmin, any number of
  centers.
* ``fused_assign_reduce(x, w, c, c_valid)`` — one Lloyd step: (k, d)
  weighted sums, (k,) counts and the weighted cost in one sweep of ``x``;
  on the card one kernel at every number of centers.
* ``remove_below(x, c, alive, v, c_valid)`` — SOCCER's removal over
  (m, p, d) shards: ``alive & (min-d2 > v)`` and per-machine live counts.
* ``update_min_dist(x, w, c, d2, c_valid)`` — one D²-seeding step:
  ``min(d2, d2(x, c))`` and ``sum w·d2_new``.
* ``kmeans_plusplus_indices(x, w, k, seed)`` — a whole weighted
  k-means++ seeding: the (k,) chosen rows, drawn by Gumbel-max with
  Philox bits keyed by ``seed``; on the card one C call runs the k steps
  on ``update_min_dist``'s kernel with its draw on.
* ``lloyd_reduce(x, w, assign, k)`` — (k, d) weighted sums and (k,)
  counts for a given assignment; beyond ``MAX_RESIDENT_K`` centers on the
  card, fixed-point accumulators instead of per-block partials.
* ``sensitivity_scores(x, w, c, c_valid)`` — the coreset sensitivity
  pass: (n,) scores w·min-d2, (n,) argmin, (k,) masses, () cost.
* ``truncated_cost(x, w, c, v, c_valid)`` — the weighted cost split at
  ``v``: kept cost (min-d2 <= v), tail mass and tail cost (> v).

All take float32, bfloat16 or float16 points and accumulate in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_lloyd import (FUSED_ASSIGN_REDUCE,
                                             REMOVE_BELOW, UPDATE_MIN_DIST,
                                             fused_assign_reduce_cuda,
                                             kmeans_plusplus_indices_cuda,
                                             remove_below_cuda,
                                             update_min_dist_cuda)
from repro_torch.kernels.lloyd import LLOYD_REDUCE, lloyd_reduce_cuda
from repro_torch.kernels.min_dist import MIN_DIST, min_dist_cuda
from repro_torch.kernels.sensitivity import (SENSITIVITY_SCORES,
                                             sensitivity_scores_cuda)
from repro_torch.kernels.truncated import (TRUNCATED_COST,
                                           truncated_cost_cuda)

# The kernels that keep per-block partials of every center
# (lloyd_reduce's partials branch, sensitivity_scores) serve up to this
# many centers; beyond it lloyd_reduce runs its fixed-point branch and
# sensitivity_scores the min_dist kernel with its (n,)-sized tail in
# PyTorch. fused_assign_reduce has one kernel at every k (fixed-point
# sums grouped by center), and remove_below, min_dist, update_min_dist and
# truncated_cost stream the centers through shared memory and keep nothing
# per center, so none of them reads this limit.
MAX_RESIDENT_K = 1024

# The reference's seven (repro.kernels.ops.ENTRY_POINTS), then the
# seeding loop, which the reference runs as a lax.scan over
# update_min_dist and which the port runs on that kernel with its draw on.
ENTRY_POINTS = ("min_dist", "lloyd_reduce", "fused_assign_reduce",
                "remove_below", "update_min_dist", "sensitivity_scores",
                "truncated_cost", "kmeans_plusplus_indices")

# CUDA kernel -> its wrapper's launch counter (for chip_smoke.py); the
# seeding's launches count as update_min_dist's, whose kernel they run
KERNELS = {"min_dist": MIN_DIST, "fused_assign_reduce": FUSED_ASSIGN_REDUCE,
           "remove_below": REMOVE_BELOW, "update_min_dist": UPDATE_MIN_DIST,
           "lloyd_reduce": LLOYD_REDUCE,
           "sensitivity_scores": SENSITIVITY_SCORES,
           "truncated_cost": TRUNCATED_COST}


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {x.device}: expected cpu or cuda")


def min_dist(x: torch.Tensor, c: torch.Tensor,
             c_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) min squared distance to valid centers and (n,) argmin."""
    if _on_card(x):
        return min_dist_cuda(x, c, c_valid)
    return ref.min_dist_ref(x, c, c_valid)


def lloyd_reduce(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-center ((k, d) sums, (k,) counts) for a Lloyd step with
    the (n,) assignment given; an assignment outside [0, k) adds nothing."""
    if _on_card(x):
        return lloyd_reduce_cuda(x, w, assign, k,
                                 fixed_point=k > MAX_RESIDENT_K)
    return ref.lloyd_reduce_ref(x, w, assign, k)


def fused_assign_reduce(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                        c_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-sweep Lloyd step: ((k, d) sums, (k,) counts, () weighted cost)."""
    if _on_card(x):
        return fused_assign_reduce_cuda(x, w, c, c_valid)
    return ref.fused_assign_reduce_ref(x, w, c, c_valid)


def remove_below(x: torch.Tensor, c: torch.Tensor, alive: torch.Tensor, v,
                 c_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused SOCCER removal: ((m, p) bool alive & min-d2 > v, (m,) counts)."""
    if _on_card(x):
        return remove_below_cuda(x, c, alive, v, c_valid)
    return ref.remove_below_ref(x, c, alive, v, c_valid)


def update_min_dist(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                    d2: torch.Tensor,
                    c_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused D²-seeding step: ((n,) min(d2, d2(x, c)), () sum w * new d2).

    With zero valid centers the update is a no-op on ``d2``. The kernel
    streams the new-center block through shared memory, so a block of any
    size stays on the card.
    """
    if _on_card(x):
        return update_min_dist_cuda(x, w, c, d2, c_valid)
    return ref.update_min_dist_ref(x, w, c, d2, c_valid)


def kmeans_plusplus_indices(x: torch.Tensor, w: torch.Tensor, k: int,
                            seed: torch.Tensor) -> torch.Tensor:
    """Weighted k-means++ (D²) seeding: (k,) int64 rows of ``x``.

    Step 0 draws a row ∝ ``w``; each later step lowers the running min-d2
    against the row drawn last and draws ∝ ``w·d2``, or ∝ ``w`` when that
    mass is 0 (every point on a center). Each draw is a Gumbel-max over
    Philox4x32-10 bits keyed by ``seed``, a (2,) int64 tensor on ``x``'s
    device; a zero-weight row is never drawn unless every weight is 0. On
    the card the whole loop is one C call: nothing is read back.
    """
    if _on_card(x):
        return kmeans_plusplus_indices_cuda(x, w, k, seed)
    return ref.kmeans_plusplus_indices_ref(x, w, k, seed)


def sensitivity_scores(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                       c_valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """The coreset sensitivity pass: ((n,) w·min-d2 scores, (n,) argmin,
    (k,) per-center weight mass, () weighted cost of ``c``).

    Beyond ``MAX_RESIDENT_K`` centers on the card (which the coreset path,
    with O(k) bicriteria centers, never reaches) it is the ``min_dist``
    kernel followed by the (n,)-sized tail in PyTorch, as the reference's
    dispatch does; its masses are exact sums (``kernels/exact.py``: a
    float ``index_add_`` on the card changes its bits from run to run).
    With no valid center the result is the plain version's (+inf scores,
    all mass on center 0), outside the reference's contract.
    """
    if _on_card(x):
        if c.shape[0] > MAX_RESIDENT_K:
            d2, assign = min_dist_cuda(x, c, c_valid)
            return ref.sensitivity_from_min(w, d2, assign, c.shape[0])
        return sensitivity_scores_cuda(x, w, c, c_valid)
    return ref.sensitivity_scores_ref(x, w, c, c_valid)


def truncated_cost(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, v,
                   c_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weighted cost split at ``v``: (kept cost of min-d2 <= v, tail
    weight mass of min-d2 > v, tail cost); rows of weight 0 on neither side.

    ``x`` (n, d) with (n,) ``w`` gives three scalars, the reference's
    contract; (m, p, d) machine shards with (m, p) ``w`` give one triple a
    machine, (m,) each, from one launch. The kernel keeps nothing per
    center, so it serves any number of centers.
    """
    if _on_card(x):
        if x.dim() == 2:
            kept, tmass, tcost = truncated_cost_cuda(x[None], w[None], c, v,
                                                     c_valid)
            return kept[0], tmass[0], tcost[0]
        return truncated_cost_cuda(x, w, c, v, c_valid)
    return ref.truncated_cost_ref(x, w, c, v, c_valid)
