"""Plain PyTorch versions of the port's kernels.

These are the semantics of record, as ``repro.kernels.ref`` is for the
JAX package: the CPU tests hold them against the JAX oracles on the same
numpy inputs, ``kernels/ops.py`` runs them for tensors on the CPU, and
``chip_smoke.py`` holds every CUDA kernel against them on the card.

Semantics carried over from the reference (``repro/kernels/ref.py``):

* invalid centers are +inf, and a point with no valid center gets
  index 0 (``torch.min`` returns the first index of the minimum);
* ``min_dist`` takes the min of ``||c||^2 - 2 x.c`` and adds ``||x||^2``
  after it, then clamps at >= 0 (ref.py:72-73);
* ``update_min_dist`` is an exact no-op on ``d2`` when no center is
  valid (+inf candidates);
* the k-means++ seeding draws each center by Gumbel-max over
  ``log(max(w·d2, 1e-38))`` where ``w·d2 > 0``, else over the weights
  (the reference's uniform fallback at zero mass, core/kmeans.py:56-57),
  with Philox4x32-10 bits that the CUDA kernel draws too;
* ``remove_below`` keeps a point only if its min-d2 is strictly ``> v``;
  ``truncated_cost`` keeps it below the threshold if ``<= v``, and a row
  of weight 0 falls on neither side;
* ``lloyd_reduce`` ignores an assignment outside [0, k), as the
  reference's one-hot and segment sum do.

Distances use the expanded form ``||x||^2 - 2 x.c + ||c||^2`` in float32,
as the reference and the CUDA kernels do, never ``sum((x - c)^2)``: at
the paper's σ = 0.001 with means in the unit cube, ``||x||^2 ~ 5`` while
a typical d2 ~ 1.5e-5, so the cancellation error is a few percent of d2,
and the removal threshold ``v`` is computed from these same d2 values.
Every implementation has to make the same error for v to mean the same
thing.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.exact import exact_index_add

# center-panel size; bounds the live (n, panel) distance matrix
# (repro/kernels/ref.py:15: EIM11's clustering reaches 173 k rows)
CHUNK_K = 4096


def min_dist_ref(x: torch.Tensor, c: torch.Tensor,
                 c_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n,) float32 min_j ||x_i - c_j||^2 over valid centers (>= 0) and
    (n,) int32 argmin.

    The centers are walked in panels of ``CHUNK_K`` with a running (min,
    argmin), as the reference's oracle does, so the (n, k) matrix never
    exists; a later panel wins only if strictly nearer, so ties keep the
    first index.
    """
    xf = x.float()
    cf = c.float()
    best = arg = None
    for j0 in range(0, cf.shape[0], CHUNK_K):
        cp = cf[j0:j0 + CHUNK_K]
        d2 = -2.0 * (xf @ cp.T) + torch.sum(cp * cp, dim=-1)[None, :]
        if c_valid is not None:
            d2 = torch.where(c_valid[None, j0:j0 + CHUNK_K], d2, torch.inf)
        dmin, loc = torch.min(d2, dim=-1)
        del d2
        if best is None:
            best, arg = dmin, loc
        else:
            better = dmin < best
            arg = torch.where(better, loc + j0, arg)
            best = torch.where(better, dmin, best)
    x2 = torch.sum(xf * xf, dim=-1)
    return torch.clamp(best + x2, min=0.0), arg.to(torch.int32)


def update_min_dist_ref(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                        d2: torch.Tensor,
                        c_valid: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One D²-seeding step: ((n,) min(d2, min-d2 to ``c``), () sum w*d2_new).

    ``min_dist_ref`` returns +inf with zero valid centers, so the min is
    already the required no-op.
    """
    cand, _ = min_dist_ref(x, c, c_valid)
    d2_new = torch.minimum(d2.float(), cand)
    return d2_new, torch.sum(w.float() * d2_new)


def lloyd_reduce_ref(x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-center accumulation for a given assignment: ((k, d)
    sum of w_i x_i, (k,) sum of w_i per center).

    Up to ``CHUNK_K`` centers a weighted (n, k) one-hot times ``x``, as the
    reference's oracle (ref.py:226-231); beyond, a scatter-add with no
    (n, k) one-hot."""
    wf = w.float()
    xf = x.float()
    if k > CHUNK_K:
        a = assign.long()
        ok = (a >= 0) & (a < k)
        a, wk = a[ok], wf[ok]
        sums = torch.zeros((k, xf.shape[1]), dtype=torch.float32,
                           device=x.device)
        sums.index_add_(0, a, xf[ok] * wk[:, None])
        counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
        counts.index_add_(0, a, wk)
        return sums, counts
    onehot = (assign[:, None] == torch.arange(k, dtype=assign.dtype,
                                              device=x.device)[None, :])
    onehot = onehot.to(torch.float32) * wf[:, None]
    return onehot.T @ xf, torch.sum(onehot, dim=0)


def sensitivity_from_min(w: torch.Tensor, d2: torch.Tensor,
                         assign: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """(scores, assign, mass, cost) from a finished min-distance pass: the
    tail of the sensitivity pass, (n,)- and (k,)-sized only (no sweep of
    the points). The masses are a float ``index_add_``, the reference's
    arithmetic, on the CPU, and the fixed-point sums of
    ``kernels/exact.py`` on the card, where a float ``index_add_`` changes
    its bits from run to run."""
    wf = w.float()
    scores = wf * d2.float()
    if wf.is_cuda:
        mass = exact_index_add(wf, assign, k)
    else:
        mass = torch.zeros((k,), dtype=torch.float32, device=w.device)
        mass.index_add_(0, assign.long(), wf)
    return scores, assign.to(torch.int32), mass, torch.sum(scores)


def sensitivity_scores_ref(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                           c_valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """The coreset sensitivity pass: ((n,) scores w_i·min-d2_i, (n,) int32
    argmin, (k,) weight mass per center, () weighted cost of ``c``).

    A point is assigned to a valid center whenever one exists, so invalid
    centers get no mass. With none valid (outside the reference's
    contract) every d2 is +inf, every point goes to center 0, which takes
    the whole mass, and the scores are w·inf (NaN at w = 0)."""
    d2, assign = min_dist_ref(x, c, c_valid)
    return sensitivity_from_min(w, d2, assign, c.shape[0])


def truncated_from_min(w: torch.Tensor, d2: torch.Tensor, v
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(kept cost, tail mass, tail cost) from a finished min-distance pass,
    summed over the last axis: scalars for (n,) inputs, (m,) for (m, p)."""
    wf = w.float()
    s = torch.where(wf > 0, wf * d2.float(), 0.0)
    below = d2 <= v
    return (torch.sum(torch.where(below, s, 0.0), dim=-1),
            torch.sum(torch.where(below, 0.0, wf), dim=-1),
            torch.sum(torch.where(below, 0.0, s), dim=-1))


def truncated_cost_ref(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, v,
                       c_valid: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The weighted cost of ``c`` split at the threshold ``v``: (kept cost
    of the rows with min-d2 <= v, tail weight mass and tail cost of those
    with min-d2 > v); rows of weight 0 fall on neither side.

    ``x`` is (n, d) with (n,) ``w`` (scalars out), or (m, p, d) machine
    shards with (m, p) ``w`` (one triple a machine, (m,) each)."""
    d = x.shape[-1]
    d2, _ = min_dist_ref(x.reshape(-1, d), c, c_valid)
    return truncated_from_min(w, d2.reshape(w.shape), v)


def fused_assign_reduce_ref(x: torch.Tensor, w: torch.Tensor,
                            c: torch.Tensor,
                            c_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One Lloyd step: ((k, d) sum of w_i x_i per assigned center, (k,)
    sum of w_i per center, () sum of w_i * min-d2_i — the cost of ``c``).

    The plain version of the CUDA kernel, which serves every number of
    centers; the kernel's exact sums are ``fixed_point_reduce_ref``'s."""
    d2, assign = min_dist_ref(x, c, c_valid)
    k, d = c.shape
    wf = w.float()
    a = assign.long()
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    sums.index_add_(0, a, x.float() * wf[:, None])
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, a, wf)
    return sums, counts, torch.sum(wf * d2)


def fixed_shift(b: float) -> int:
    """The largest s with b·2^s < 2^62 (0 when b is not > 0), as
    ``csrc/common.cuh::fixed_shift``."""
    if not b > 0.0:
        return 0
    return 62 - math.frexp(b)[1]


def fixed_point_reduce_ref(x: torch.Tensor, w: torch.Tensor,
                           assign: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Lloyd kernel's own arithmetic for its ((k, d) sums, (k,)
    counts), given the (n,) assignment: the exact oracle the card's
    ``fused_assign_reduce`` matches bit for bit (``csrc/fused_assign.cu``).

    max |w| over every row and max |x| over the rows with w != 0, in
    float32; the shifts from ((double)n·max|w|)·max|x| and n·max|w| as
    ``common.cuh::shifts``; each term w·x_q (exact in float64) scaled by
    2^s and rounded half to even to an int64, as ``llrint``; an int64
    ``index_add_`` (exact in any order); back through float64 and 2^-s to
    float32. An assignment outside [0, k) adds nothing. A check's oracle,
    never on the main path: it reads the bounds back to the host."""
    n, d = x.shape
    xf, wf = x.float(), w.float()
    mw = float(wf.abs().max()) if n else 0.0
    weighted = wf != 0
    mx = float(xf[weighted].abs().max()) if bool(weighted.any()) else 0.0
    sx = fixed_shift(float(n) * mw * mx)
    sw = fixed_shift(float(n) * mw)
    a = assign.long()
    ok = (a >= 0) & (a < k)
    a, wd = a[ok], wf[ok].double()
    tx = torch.round(wd[:, None] * xf[ok].double() * 2.0 ** sx).long()
    tw = torch.round(wd * 2.0 ** sw).long()
    acc_x = torch.zeros((k, d), dtype=torch.int64,
                        device=x.device).index_add_(0, a, tx)
    acc_w = torch.zeros((k,), dtype=torch.int64,
                        device=x.device).index_add_(0, a, tw)
    return ((acc_x.double() * 2.0 ** -sx).float(),
            (acc_w.double() * 2.0 ** -sw).float())


def remove_below_ref(x: torch.Tensor, c: torch.Tensor, alive: torch.Tensor,
                     v: torch.Tensor,
                     c_valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SOCCER removal over (m, p, d) shards: ((m, p) bool
    ``alive & (min-d2 > v)``, (m,) int32 surviving counts)."""
    m, p, d = x.shape
    d2, _ = min_dist_ref(x.reshape(m * p, d), c, c_valid)
    alive_new = alive & (d2.reshape(m, p) > v)
    return alive_new, torch.sum(alive_new, dim=1, dtype=torch.int32)


# ---------------------------------------------------- k-means++ seeding
# Philox4x32-10 (Salmon et al., SC'11; Random123's round and key
# schedule), as csrc/fused_lloyd.cu::philox_word0 computes it. Words are
# uint32 values held in int64: a product of two of them wraps mod 2^64,
# its low word is ``p & MASK32`` and its high word ``(p >> 32) & MASK32``.
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
MASK32 = 0xFFFFFFFF
# the most seeding steps whose bits are drawn at once, times n
SEED_BATCH = 1 << 22


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four words of the Philox4x32-10 block at counter (c0, c1, c2,
    c3) under key (k0, k1): int64 tensors (or ints) of uint32 values,
    broadcast together."""
    x = [torch.as_tensor(c, dtype=torch.int64) for c in (c0, c1, c2, c3)]
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        p0 = x[0] * PHILOX_M[0]
        p1 = x[2] * PHILOX_M[1]
        x = [((p1 >> 32) & MASK32) ^ x[1] ^ k0, p1 & MASK32,
             ((p0 >> 32) & MASK32) ^ x[3] ^ k1, p0 & MASK32]
    return x


def seed_gumbel(seed: torch.Tensor, n: int, steps: range) -> torch.Tensor:
    """(len(steps), n) float32 Gumbel noise g = -log(-log u) of the
    seeding keyed by ``seed`` ((2,) int64), for points 0..n-1 at the given
    steps: counter (point, step, 0, 0), word 0 r, u = (2·(r >> 9) + 1)·2^-24
    (exact in float32, never 0 or 1)."""
    dev = seed.device
    c0 = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    c1 = torch.as_tensor(list(steps), dtype=torch.int64, device=dev)[:, None]
    r = philox4x32_10(c0, c1, 0, 0, seed[0], seed[1])[0]
    u = ((r >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def gumbel_keys(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gumbel-max keys of weights ``p``: log(max(p, 1e-38)) + g where
    p > 0, else -inf (core/sampling.py::gumbel_argmax's formula)."""
    logp = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-38)),
                       -torch.inf)
    return logp + g


def draw_winner(key_d2: Optional[torch.Tensor],
                key_w: torch.Tensor) -> torch.Tensor:
    """The step's draw, a () int64 index: the argmax of the D² keys if one
    is above -inf, else of the w keys (``key_d2`` None: step 0); ties to
    the lowest index (torch.argmax)."""
    aw = torch.argmax(key_w)
    if key_d2 is None:
        return aw
    return torch.where(torch.max(key_d2) > -torch.inf, torch.argmax(key_d2),
                       aw)


def kmeans_pp_step_ref(x: torch.Tensor, w: torch.Tensor, d2: torch.Tensor,
                       prev: Optional[torch.Tensor], g: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """One seeding step: ((n,) d2 lowered against row ``prev`` of ``x``
    (unchanged when None), (n,) D² keys (None when ``prev`` is None) and
    (n,) w keys), with the step's Gumbel noise ``g``."""
    wf = w.float()
    key_d2 = None
    if prev is not None:
        c = torch.index_select(x, 0, prev.reshape(1)).float()
        d2 = torch.minimum(d2, min_dist_ref(x, c)[0])
        key_d2 = gumbel_keys(wf * d2, g)
    return d2, key_d2, gumbel_keys(wf, g)


def kmeans_plusplus_indices_ref(x: torch.Tensor, w: torch.Tensor, k: int,
                                seed: torch.Tensor) -> torch.Tensor:
    """(k,) int64 rows of ``x`` drawn by weighted k-means++ seeding keyed
    by the (2,) int64 ``seed``: the CUDA kernel's steps, bits and
    tie rule, with ``min_dist_ref``'s d2 (the kernel's to a few ulps)."""
    n = x.shape[0]
    d2 = torch.full((n,), torch.inf, dtype=torch.float32, device=x.device)
    idx = torch.empty((k,), dtype=torch.int64, device=x.device)
    batch = max(1, SEED_BATCH // max(n, 1))
    prev = None
    for s0 in range(0, k, batch):
        g = seed_gumbel(seed, n, range(s0, min(k, s0 + batch)))
        for j in range(g.shape[0]):
            d2, key_d2, key_w = kmeans_pp_step_ref(x, w, d2, prev, g[j])
            prev = draw_winner(key_d2, key_w)
            idx[s0 + j] = prev
    return idx


def key_of_word(word: torch.Tensor) -> torch.Tensor:
    """The float32 key in the high half of a draw word
    (csrc/fused_lloyd.cu::key_word), int64 storage in, float32 out."""
    o = (word >> 32) & MASK32
    b = torch.where(o >= 0x80000000, o - 0x80000000, MASK32 - o)
    b = torch.where(b >= 0x80000000, b - (1 << 32), b)   # as int32 bits
    return b.to(torch.int32).view(torch.float32)


def winner_from_words(words: torch.Tensor) -> torch.Tensor:
    """The index a step's (D² word, w word) draw: the D² word's if its key
    is above -inf, else the w word's (csrc/fused_lloyd.cu::winner_of)."""
    above = ((words[0] >> 32) & MASK32) > 0x007FFFFF
    word = torch.where(above, words[0], words[1])
    return MASK32 - (word & MASK32)
