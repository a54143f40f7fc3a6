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
  beyond ``MAX_RESIDENT_K`` centers on the card, the chunked kernel.
* ``remove_below(x, c, alive, v, c_valid)`` — SOCCER's removal over
  (m, p, d) shards: ``alive & (min-d2 > v)`` and per-machine live counts.
* ``update_min_dist(x, w, c, d2, c_valid)`` — one D²-seeding step:
  ``min(d2, d2(x, c))`` and ``sum w·d2_new``.

All take float32, bfloat16 or float16 points and accumulate in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_lloyd import (FUSED_ASSIGN_REDUCE,
                                             FUSED_ASSIGN_REDUCE_CHUNKED,
                                             REMOVE_BELOW, UPDATE_MIN_DIST,
                                             fused_assign_reduce_chunked_cuda,
                                             fused_assign_reduce_cuda,
                                             remove_below_cuda,
                                             update_min_dist_cuda)
from repro_torch.kernels.min_dist import MIN_DIST, min_dist_cuda

# The resident Lloyd kernel keeps per-block partials of every center, so
# it serves up to this many centers; beyond it fused_assign_reduce runs
# the chunked kernel. remove_below has no chunked kernel yet.
MAX_RESIDENT_K = 1024

ENTRY_POINTS = ("min_dist", "fused_assign_reduce", "remove_below",
                "update_min_dist")

# CUDA kernel -> its wrapper's launch counter (for chip_smoke.py);
# fused_assign_reduce has two, by the number of centers
KERNELS = {"min_dist": MIN_DIST, "fused_assign_reduce": FUSED_ASSIGN_REDUCE,
           "fused_assign_reduce_chunked": FUSED_ASSIGN_REDUCE_CHUNKED,
           "remove_below": REMOVE_BELOW, "update_min_dist": UPDATE_MIN_DIST}


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


def fused_assign_reduce(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                        c_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-sweep Lloyd step: ((k, d) sums, (k,) counts, () weighted cost)."""
    if _on_card(x):
        if c.shape[0] > MAX_RESIDENT_K:
            return fused_assign_reduce_chunked_cuda(x, w, c, c_valid)
        return fused_assign_reduce_cuda(x, w, c, c_valid)
    return ref.fused_assign_reduce_ref(x, w, c, c_valid)


def remove_below(x: torch.Tensor, c: torch.Tensor, alive: torch.Tensor, v,
                 c_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused SOCCER removal: ((m, p) bool alive & min-d2 > v, (m,) counts)."""
    if _on_card(x):
        if c.shape[0] > MAX_RESIDENT_K:
            raise NotImplementedError(
                f"remove_below with k={c.shape[0]} > {MAX_RESIDENT_K} "
                f"centers needs the chunked-center kernel "
                f"(remove_below_chunked_pallas in "
                f"repro/kernels/fused_lloyd.py; PERF.md table row 9), which "
                f"is not ported yet (ROADMAP Queue 2 item 7)")
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
