"""Per-machine merge-and-reduce coreset trees (the streaming compressor).

The port of ``repro.streaming.tree``: the classic Bentley-Saxe /
merge-and-reduce scheme in the distributed form of Balcan et al.
(arXiv:1306.0604), each tree node compressed by the sensitivity sampler
of ``repro_torch.coresets``:

* every incoming ``(m, pb, d)`` batch is compressed machine-side to a
  ``t``-row weighted coreset, a **level-0 bucket**;
* when two buckets occupy the same level their union (``2t`` rows) is
  re-compressed to ``t`` rows and promoted one level up, a binary-counter
  increment, so after ``B`` batches the occupied levels are the set bits
  of ``B`` and each machine holds ``t * popcount(B) <= t * (log2(B) + 1)``
  resident rows: **O(t log n) memory** for an unbounded stream;
* a bucket at level ``l`` has been through ``l + 1`` compressions, so its
  error compounds as ``(1 + eps_node)^(l+1)`` with
  ``eps_node = O(sqrt(S / t))``, ``S <= 2``; ``tree_epsilon`` reports the
  compounded bound for the current height.

A compression is ``coresets.sensitivity.build_coreset`` on each machine:
the ``kb``-step k-means++ seeding (on the card one C call over
``update_min_dist``'s kernel) and one ``sensitivity_scores`` launch over
the machine's rows, then the importance draw. Each machine draws from its
own generator, seeded from the fold's key, the tree level and the
machine id (``machine_generators``), the port's counterpart of the
reference's ``fold_in`` keys.

Batches are padded to ``stream_bucket`` widths, the reference's, so the
padded layouts match its bit for bit. The reference pads to bound its
jit signatures and counts them in ``TRACE_COUNTS``; eager PyTorch traces
nothing, so that counter is not ported.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.coresets.sensitivity import build_coreset

# One level's buckets across machines: ((m, t, d) points, (m, t) weights).
Bucket = Tuple[torch.Tensor, torch.Tensor]


def stream_bucket(n: int) -> int:
    """Static per-machine batch width for an ``n``-row update.

    Tile-round up to the 128-row grid, then take the next power of two,
    so a stream of arbitrary batch sizes maps to O(log max_batch) widths.
    Padding rows carry weight 0 and are never sampled by the compressor.
    """
    tiled = max(128, -(-int(n) // 128) * 128)
    return 1 << (tiled - 1).bit_length()


def derive_seed(*ints: int) -> int:
    """A 63-bit generator seed from non-negative ints (numpy's
    ``SeedSequence`` hash: distinct tuples give independent streams)."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def machine_generators(key: int, level: int, m: int,
                       device) -> List[torch.Generator]:
    """One generator a machine for one compression of the tree at
    ``level`` (0: the batch's own compression, l + 1: a merge at l)."""
    return [torch.Generator(device).manual_seed(derive_seed(key, level, j))
            for j in range(m)]


def _compress(gens: Sequence[torch.Generator], x: torch.Tensor,
              w: torch.Tensor, t: int, kb: int) -> Bucket:
    """(m, n, d) weighted points -> ((m, t, d), (m, t)), machine by
    machine."""
    blocks = [build_coreset(g, x[j], w[j], t, kb) for j, g in enumerate(gens)]
    return (torch.stack([b[0] for b in blocks]),
            torch.stack([b[1] for b in blocks]))


def fold_batch(levels: List[Optional[Bucket]], occupied: List[bool],
               key: int, x: torch.Tensor, w: torch.Tensor,
               t: int, kb: int) -> None:
    """Fold one padded ``(m, pb, d)`` batch into the tree, in place.

    ``levels``/``occupied`` are the per-level bucket list and its
    occupancy (a binary counter over batches); the carry cascade mutates
    both. ``key`` seeds every compression of this fold. Weight-0 rows in
    ``w`` are padding and contribute nothing.
    """
    m = x.shape[0]
    carry = _compress(machine_generators(key, 0, m, x.device), x, w, t, kb)
    lvl = 0
    while True:
        if lvl == len(levels):
            levels.append(None)
            occupied.append(False)
        if not occupied[lvl]:
            levels[lvl] = carry
            occupied[lvl] = True
            return
        pa, wa = levels[lvl]
        carry = _compress(machine_generators(key, lvl + 1, m, x.device),
                          torch.cat([pa, carry[0]], dim=1),
                          torch.cat([wa, carry[1]], dim=1), t, kb)
        levels[lvl] = None
        occupied[lvl] = False
        lvl += 1


def flatten_tree(levels: List[Optional[Bucket]], occupied: List[bool],
                 m: int, t: int, d: int, device="cuda") -> Bucket:
    """All resident rows as one fixed-width per-machine block.

    Returns ``((m, L*t, d), (m, L*t))`` with ``L = len(levels)``:
    unoccupied levels contribute weight-0 rows, so the flattened width
    changes only when the tree grows a level.
    """
    zero = (torch.zeros((m, t, d), dtype=torch.float32, device=device),
            torch.zeros((m, t), dtype=torch.float32, device=device))
    if not levels:
        return zero
    pts = [levels[i][0] if occupied[i] else zero[0]
           for i in range(len(levels))]
    wts = [levels[i][1] if occupied[i] else zero[1]
           for i in range(len(levels))]
    return torch.cat(pts, dim=1), torch.cat(wts, dim=1)


def resident_rows(occupied: List[bool], t: int) -> int:
    """Rows held per machine right now (<= t * ceil(log2(B) + 1))."""
    return t * sum(1 for o in occupied if o)


def tree_epsilon(occupied: List[bool], t: int) -> float:
    """Compounded relative-error bound of the current tree.

    One sensitivity-coreset node concentrates at
    ``eps_node ~ sqrt(S / t)`` with ``S <= 2``; a height-``h`` tree
    composes to ``(1 + eps_node)^h - 1`` (Balcan et al. 1306.0604).
    """
    h = len(occupied)
    if h == 0:
        return 0.0
    eps_node = math.sqrt(2.0 / max(t, 1))
    return (1.0 + eps_node) ** h - 1.0
