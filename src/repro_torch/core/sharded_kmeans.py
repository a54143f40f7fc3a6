"""Beyond-paper optimization: the **sharded coordinator**.

The port of ``repro.core.sharded_kmeans``. The paper's coordinator
gathers P1 and P2; here both samples stay sharded where they were drawn,
as (m, cap_sharded, d) buffers whose empty slots carry weight 0, and the
same math runs distributed:

* k-means++ seeding: k₊ sequential D² choices. A two-stage choice
  (machine ∝ its mass, then point ∝ its weight) has the distribution of
  one draw ∝ ``ws·d2`` over the flattened buffer, and both fall back to
  ``ws`` when the mass is 0, so the port runs the whole seeding as one
  ``ops.kmeans_plusplus_indices`` call over the flattened buffer (on the
  card one C call); a zero-weight slot is never drawn;
* Lloyd: one ``ops.fused_assign_reduce`` launch over the flattened buffer
  a step, since the machines' sums added together are the sums over all
  rows, plus the psum of (k₊, d) sums and (k₊,) counts;
* the truncated-cost threshold: Σw·d² by psum and the truncation
  boundary found by a 32-step bisection of scalar psums (``bisect``) or
  from the union of per-machine top-l candidates (``topk``).

On the mesh backend no rank holds the flattened buffer, so the seeding
and the Lloyd step run part by part and give the virtual run's bits:

* each seeding step is one ``ops.kmeans_pp_step_at`` launch over the
  rank's slots, its Philox counters keyed on the slots' global indices
  (rank·cap + i); a Gumbel-max draw over a union is the largest of the
  per-rank maxima, so one small all-gather of each rank's two draw words
  and the two rows they name picks the flattened call's winner, the
  zero-mass fallback decided on the global words;
* each Lloyd step gathers the ranks' fixed-point bound words
  (``ops.fixed_bound``), takes its exact int64 accumulators at the whole
  buffer's shifts (``ops.fused_assign_reduce_fixed``), sums them over the
  ranks in integers and rounds once (``exact.fixed_finalize``): the
  flattened launch's sums on the card. The plain version's float sums
  have no such split, so on the CPU a mesh Lloyd step is the card's
  fixed-point arithmetic and a virtual one is not.

The per-machine float sums the threshold reads are exact row sums
(``exact.exact_row_sum``; the bisection quantizes the weights once and
sums a subset of their terms each step), so a rank's (1, cap) block
gives its row of the virtual (m, cap) buffer's bits.

Wire accounting counts every executed collective, so where the reference
records a scanned or looped collective once a trace, the port records it
once an iteration. A round's metadata bytes on the virtual backend, with
``s = k_plus``, ``T = lloyd_iters``, m machines and d features, are::

    4m                          live counts
  + s·(4m + 4md) + (s - 1)·4m   D² seeding: per choice the machine masses
                                and the chosen point's psum, per later
                                step the psum of the local masses
  + T·(4m·s·d + 4m·s)           Lloyd: each step's psum of sums, counts
  + 4m·36                       bisect: Σw·d², the max, 32 steps, 2 sums
    (topk: 4m + 8m·t, t = min(cap_sharded, ceil(1.5(k+1)d_k) + 8 + z))
  + 4m                          removal's live counts

and no payload bytes (``sharded_round_meta_bytes``); the reference counts
one seeding step, one Lloyd step and one bisection step.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.comm import record_wire
from repro_torch.core.kmeans import draw_seed, kmeans_plusplus
from repro_torch.core.metrics import assignment_counts
from repro_torch.core.sampling import (apportion, global_weighted_choice,
                                       ordered_topk, sample_local,
                                       scatter_selected)
from repro_torch.core.truncated_cost import weighted_top_mass
from repro_torch.kernels import ops, ref
from repro_torch.kernels.exact import (exact_row_sum, fixed_finalize,
                                       row_terms, row_terms_sum)

BISECT_STEPS = 32


def draw_local_sample(comm, gen: torch.Generator, x: torch.Tensor,
                      w: torch.Tensor, alive: torch.Tensor,
                      n_vec_resp: torch.Tensor, total: int, cap: int):
    """Exact-size global sample that stays sharded: (m, cap, d) points,
    (m, cap) HT weights (0 = empty slot), the () int32 realized count.

    A machine's quota is truncated to ``cap`` (~8x the balanced share
    eta/m); its HT weight rescales by n_j/min(c_j, cap), so the estimator
    stays consistent and the sample only shrinks."""
    ids = comm.machine_ids(x.device)
    c_vec = torch.clamp(apportion(n_vec_resp, total), max=cap)
    my_c = c_vec[ids]
    idx, take = sample_local(gen, alive, my_c, cap, comm)
    pts = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    w_pt = torch.gather(w, 1, idx)
    n_local = torch.sum(alive, dim=1).to(torch.float32)
    ht = n_local / torch.clamp(my_c.to(torch.float32), min=1.0)
    ws = w_pt * ht[:, None] * take.to(torch.float32)
    return pts, ws, torch.sum(c_vec, dtype=torch.int32)


def _choice_meta_bytes(m: int, d: int) -> int:
    """One two-stage global choice: the (m,) masses and the psum of the
    chosen point, a (d,) f32 row from every machine."""
    return 4 * m + 4 * m * d


def sharded_round_meta_bytes(m: int, d: int, k_plus: int, lloyd_iters: int,
                             topk_rows: int = 0) -> int:
    """The closed form of the module docstring: a sharded round's
    metadata bytes with D² seeding, under ``bisect`` or, given its
    per-machine candidate rows, ``topk``."""
    seeding = k_plus * _choice_meta_bytes(m, d) + (k_plus - 1) * 4 * m
    lloyd = lloyd_iters * 4 * m * (k_plus * d + k_plus)
    threshold = (4 * m + 8 * m * topk_rows if topk_rows
                 else 4 * m * (BISECT_STEPS + 4))
    return 4 * m + seeding + lloyd + threshold + 4 * m


def _split(comm) -> bool:
    """True where no process holds every machine (a mesh of several)."""
    return comm.local_m != comm.m


def distributed_kmeans_pp(gen: torch.Generator, comm, pts: torch.Tensor,
                          ws: torch.Tensor, k: int) -> torch.Tensor:
    """Weighted D²-seeding over sharded points -> (k, d) float32.

    One ``ops.kmeans_plusplus_indices`` call over the flattened buffer
    (see the module docstring), or on a mesh one ``_mesh_kmeans_pp`` step
    a center, recording the reference's collectives: a global choice per
    center and the psum of the machines' masses per step after the
    first."""
    m, cap, d = pts.shape
    if _split(comm):
        centers = _mesh_kmeans_pp(gen, comm, pts, ws, k)
    else:
        centers = kmeans_plusplus(gen, pts.reshape(m * cap, d),
                                  ws.reshape(-1), k)
    record_wire(meta=k * _choice_meta_bytes(comm.m, d)
                + (k - 1) * 4 * comm.m)
    return centers


def _mesh_kmeans_pp(gen: torch.Generator, comm, pts: torch.Tensor,
                    ws: torch.Tensor, k: int) -> torch.Tensor:
    """The flattened seeding's k draws with each rank holding its (1, cap)
    slots: per step one ``ops.kmeans_pp_step_at`` over the rank's slots
    (rows rank·cap ..), then one all-gather of each rank's (D² word, w
    word) and the two rows they name; every rank picks the same winner
    and row, which becomes the next step's center. Nothing is read back
    to the host."""
    _, cap, d = pts.shape
    x, w = pts.reshape(cap, d), ws.reshape(cap)
    seed = draw_seed(gen, x.device)
    base = comm.machine_base * cap
    d2 = torch.full((cap,), torch.inf, dtype=torch.float32, device=x.device)
    center, rows = None, []
    cols = torch.arange(d, device=x.device)
    for step in range(k):
        d2, words = ops.kmeans_pp_step_at(x, w, d2, center, step, seed, base)
        local = torch.clamp(ref.MASK32 - (words & ref.MASK32) - base, 0,
                            cap - 1)
        named = torch.index_select(x, 0, local).to(torch.float32)
        g = comm._gather(torch.cat([words.view(torch.int32),
                                    named.reshape(-1).view(torch.int32)]
                                   )[None])              # (m, 4 + 2d)
        best = ref.max_word(g[:, :4].contiguous().view(torch.int64), 0)
        kind = (((best[0] >> 32) & ref.MASK32) <= ref.NEG_INF_KEY).long()
        flip = torch.iinfo(torch.int64).min
        owner = torch.argmax(
            g[:, :4].contiguous().view(torch.int64) ^ flip, dim=0)
        row = torch.index_select(g, 0, torch.gather(owner, 0, kind[None]))[0]
        center = torch.gather(row, 0, 4 + kind * d + cols).view(torch.float32)
        rows.append(center)
    return torch.stack(rows)


def distributed_lloyd(comm, pts: torch.Tensor, ws: torch.Tensor,
                      centers: torch.Tensor, iters: int) -> torch.Tensor:
    """Weighted Lloyd over sharded points; each step one Lloyd launch over
    the flattened buffer and the psum of each machine's (k, d) sums and
    (k,) counts. On a mesh each step gathers the ranks' fixed-point bound
    words and sums their exact accumulators (module docstring)."""
    m, cap, d = pts.shape
    k = centers.shape[0]
    x, w = pts.reshape(m * cap, d), ws.reshape(-1)
    c = centers.to(torch.float32)
    for _ in range(iters):
        if _split(comm):
            n_all = comm.m * cap
            bound = torch.amax(comm._gather(ops.fixed_bound(x, w)[None]),
                               dim=0)
            acc = comm._reduce(ops.fused_assign_reduce_fixed(
                x, w, c, bound, n_all)[None])
            sums, counts = fixed_finalize(acc, bound, n_all)
        else:
            sums, counts, _ = ops.fused_assign_reduce(x, w, c)
        record_wire(meta=4 * comm.m * k * d + 4 * comm.m * k)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts[:, None], min=1e-30), c)
    return c


def topk_candidates(k: int, d_k: float, cap: int, extra_top: int = 0) -> int:
    """Per-machine candidate rows of the ``topk`` threshold: the
    truncation's sample count l plus 8 and the (k, z) extra, at most the
    buffer width."""
    return min(cap, int(math.ceil(1.5 * (k + 1) * d_k)) + 8 + int(extra_top))


def distributed_threshold(comm, pts: torch.Tensor, ws: torch.Tensor,
                          c_iter: torch.Tensor, k: int, d_k: float,
                          alpha: torch.Tensor, mode: str = "bisect",
                          outlier_mass=0.0, extra_top: int = 0
                          ) -> torch.Tensor:
    """v from the truncated cost of sharded P2.

    mode="topk": gather the union of per-machine top-l candidates; the
      global top-l sample points are always among them (exact).
    mode="bisect": bisect the truncation boundary tau with one scalar
      psum a step, 32 steps to float32 precision, then
      top_L_sum = Σ w·d2·[d2 > tau] + (L - mass above tau)·tau; exact at
      convergence. The steps select with ``torch.where`` on device
      scalars, so nothing is read back to the host.
    """
    m, cap, d = pts.shape
    d2, _ = ops.min_dist(pts.reshape(m * cap, d), c_iter)
    d2 = d2.reshape(m, cap)
    total = comm.psum(exact_row_sum(ws * d2))
    d2 = d2 * (ws > 0)
    trunc_mass = (1.5 * (k + 1) * d_k / torch.clamp(alpha, min=1e-30)
                  + outlier_mass)
    if mode == "topk":
        t = topk_candidates(k, d_k, cap, extra_top)
        top_idx = ordered_topk(d2, t)
        top_d2 = torch.gather(d2, 1, top_idx)
        top_w = torch.gather(ws, 1, top_idx)
        dropped = weighted_top_mass(comm.all_machines(top_d2).reshape(-1),
                                    comm.all_machines(top_w).reshape(-1),
                                    trunc_mass)
    else:
        hi = torch.max(comm.all_machines(torch.amax(d2, dim=1)))
        lo = torch.zeros_like(hi)
        # the weights quantized once; each step sums a subset of them
        qw, sw = row_terms(ws)
        for _ in range(BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            above = comm.psum(row_terms_sum(torch.where(d2 > mid, qw, 0),
                                            sw))
            up = above > trunc_mass
            lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
        tau = 0.5 * (lo + hi)
        over = d2 > tau
        above_sum = comm.psum(exact_row_sum(ws * d2 * over))
        mass_above = comm.psum(row_terms_sum(torch.where(over, qw, 0), sw))
        dropped = above_sum + torch.clamp(trunc_mass - mass_above,
                                          min=0.0) * tau
    psi = (2.0 / 3.0) * torch.clamp(total - dropped, min=0.0)
    return psi * alpha / (k * d_k)


def sharded_center_threshold(comm, const, state, alive_eff: torch.Tensor,
                             n_vec_r1: torch.Tensor, n_vec_r2: torch.Tensor,
                             n_total: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """The sharded replacement of gather -> cluster -> threshold: returns
    ``(c_iter, v, uplink_rows, alpha)``, alpha being P2's own realized
    rate (cap_sharded truncation and per-draw straggler deadlines can
    make the two draws' sizes differ)."""
    gen = state.gen
    p1, w1, real1 = draw_local_sample(comm, gen, state.x, state.w, alive_eff,
                                      n_vec_r1, const.eta, const.cap_sharded)
    p2, w2, real2 = draw_local_sample(comm, gen, state.x, state.w, alive_eff,
                                      n_vec_r2, const.eta, const.cap_sharded)
    if const.sharded_seeding == "kmeanspar":
        init = distributed_kmeans_parallel_seed(gen, comm, p1, w1,
                                                const.k_plus)
    else:
        init = distributed_kmeans_pp(gen, comm, p1, w1, const.k_plus)
    c_iter = distributed_lloyd(comm, p1, w1, init, const.lloyd_iters)
    n_f = n_total.to(torch.float32)
    alpha = real2.to(torch.float32) / torch.clamp(n_f, min=1.0)
    v = distributed_threshold(
        comm, p2, w2, c_iter, const.k, const.d_k, alpha,
        mode=const.sharded_threshold,
        outlier_mass=n_f * const.outlier_frac,
        extra_top=int(math.ceil(const.outlier_frac * const.eta)))
    return c_iter, v, real1 + real2, alpha


def distributed_kmeans_parallel_seed(gen: torch.Generator, comm,
                                     pts: torch.Tensor, ws: torch.Tensor,
                                     k: int, rounds: int = 5,
                                     oversample: float = 2.0
                                     ) -> torch.Tensor:
    """k-means‖-style seeding for the sharded coordinator: ``rounds``
    Bernoulli oversampling passes (each point selected w.p.
    l·w·d²/φ, l = oversample·k) into a replicated (rounds·cap + 1, d)
    candidate buffer, the candidates weighed by their assigned sample
    mass, then a replicated weighted k-means++ over them. ~15
    collectives instead of ~3k₊."""
    m, p, d = pts.shape
    l = oversample * k
    cap = int(3 * l) + 16
    rows = rounds * cap + 1
    x, w = pts.reshape(m * p, d), ws.reshape(-1)
    first = global_weighted_choice(gen, comm, ws, pts)
    # row 0 is the first choice, valid (last column 1)
    cand = torch.cat([torch.cat([first, first.new_ones(1)])[None],
                      first.new_zeros((rows - 1, d + 1))])
    # candidates are append-only, so lowering the running min-d2 against
    # each new block equals a full recompute against the whole set
    d2, _ = ops.update_min_dist(
        x, w, first[None, :],
        torch.full((m * p,), torch.inf, dtype=torch.float32,
                   device=pts.device))
    for r in range(rounds):
        d2m = d2.reshape(m, p)
        phi = comm.psum(exact_row_sum(ws * d2m))
        prob = torch.clamp(l * ws * d2m / torch.clamp(phi, min=1e-30),
                           max=1.0)
        sel = (comm.machine_rand(gen, (p,), pts.device) < prob) & (ws > 0)
        buf, _ = scatter_selected(comm, pts, sel, cap, 1 + r * cap, rows)
        cand = torch.where(buf[:, d:] > 0, buf, cand)
        block = cand[1 + r * cap: 1 + (r + 1) * cap]
        d2, _ = ops.update_min_dist(x, w, block[:, :d], d2, block[:, d] > 0)
    centers, valid = cand[:, :d].contiguous(), cand[:, d] > 0
    counts = assignment_counts(comm, pts, ws, centers, valid) * valid
    return kmeans_plusplus(gen, centers, counts, k)
