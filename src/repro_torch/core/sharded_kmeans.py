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
from repro_torch.core.kmeans import kmeans_plusplus
from repro_torch.core.metrics import assignment_counts
from repro_torch.core.sampling import (apportion, global_weighted_choice,
                                       sample_local, scatter_selected)
from repro_torch.core.truncated_cost import weighted_top_mass
from repro_torch.kernels import ops

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
    idx, take = sample_local(gen, alive, my_c, cap)
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


def distributed_kmeans_pp(gen: torch.Generator, comm, pts: torch.Tensor,
                          ws: torch.Tensor, k: int) -> torch.Tensor:
    """Weighted D²-seeding over sharded points -> (k, d) float32.

    One ``ops.kmeans_plusplus_indices`` call over the flattened buffer
    (see the module docstring), recording the reference's collectives: a
    global choice per center and the psum of the machines' masses per
    step after the first."""
    m, cap, d = pts.shape
    centers = kmeans_plusplus(gen, pts.reshape(m * cap, d), ws.reshape(-1),
                              k)
    record_wire(meta=k * _choice_meta_bytes(comm.m, d)
                + (k - 1) * 4 * comm.m)
    return centers


def distributed_lloyd(comm, pts: torch.Tensor, ws: torch.Tensor,
                      centers: torch.Tensor, iters: int) -> torch.Tensor:
    """Weighted Lloyd over sharded points; each step one Lloyd launch over
    the flattened buffer and the psum of each machine's (k, d) sums and
    (k,) counts."""
    m, cap, d = pts.shape
    k = centers.shape[0]
    x, w = pts.reshape(m * cap, d), ws.reshape(-1)
    c = centers.to(torch.float32)
    for _ in range(iters):
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
    total = comm.psum(torch.sum(ws * d2, dim=1))
    d2 = d2 * (ws > 0)
    trunc_mass = (1.5 * (k + 1) * d_k / torch.clamp(alpha, min=1e-30)
                  + outlier_mass)
    if mode == "topk":
        t = topk_candidates(k, d_k, cap, extra_top)
        top_d2, top_idx = torch.topk(d2, t, dim=1)
        top_w = torch.gather(ws, 1, top_idx)
        dropped = weighted_top_mass(comm.all_machines(top_d2).reshape(-1),
                                    comm.all_machines(top_w).reshape(-1),
                                    trunc_mass)
    else:
        hi = torch.max(comm.all_machines(torch.amax(d2, dim=1)))
        lo = torch.zeros_like(hi)
        for _ in range(BISECT_STEPS):
            mid = 0.5 * (lo + hi)
            above = comm.psum(torch.sum(ws * (d2 > mid), dim=1))
            up = above > trunc_mass
            lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
        tau = 0.5 * (lo + hi)
        over = d2 > tau
        above_sum = comm.psum(torch.sum(ws * d2 * over, dim=1))
        mass_above = comm.psum(torch.sum(ws * over, dim=1))
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
        phi = comm.psum(torch.sum(ws * d2m, dim=1))
        prob = torch.clamp(l * ws * d2m / torch.clamp(phi, min=1e-30),
                           max=1.0)
        sel = (torch.rand((m, p), generator=gen, device=pts.device)
               < prob) & (ws > 0)
        buf, _ = scatter_selected(comm, pts, sel, cap, 1 + r * cap, rows)
        cand = torch.where(buf[:, d:] > 0, buf, cand)
        block = cand[1 + r * cap: 1 + (r + 1) * cap]
        d2, _ = ops.update_min_dist(x, w, block[:, :d], d2, block[:, d] > 0)
    centers, valid = cand[:, :d].contiguous(), cand[:, d] > 0
    counts = assignment_counts(comm, pts, ws, centers, valid) * valid
    return kmeans_plusplus(gen, centers, counts, k)
