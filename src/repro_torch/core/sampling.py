"""Exact-size distributed sampling with static shapes.

The port of ``repro.core.sampling`` for SOCCER's main path. The paper
samples each point with probability α = η/N and fixes |P1| = |P2| = α·N
exactly "to reduce variance". The same three steps:

1. ``apportion`` — largest-remainder apportionment splits the global
   budget across machines proportionally to their live counts
   (deterministic; float32 arithmetic equal to the reference's).
2. per-machine Gumbel top-k draws ``c_j`` live points uniformly without
   replacement (static cap, dynamic count).
3. ``comm.gather_ragged`` — machine j's ``c_j`` drawn rows land at offset
   ``sum(c[:j])`` of the global ``(rows, d)`` buffer.

Sampled points carry Horvitz–Thompson weights ``w_i · n_j / c_j``. The
random bits come from an explicit ``torch.Generator`` on the data's
device; they are not the JAX package's threefry bits, so a test holds a
sampled step to the reference's outcomes, not to its draws.

The baselines add ``scatter_at`` (k-means‖'s rank-positioned upload into a
dense per-machine buffer, whose pad is recorded as wire), the two-stage
``global_weighted_choice`` and ``quantize_uplink``; the coreset uplinks
add ``gather_weighted``, the fixed-width weighted gather.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.comm import record_wire


def quantize_uplink(x: torch.Tensor, upload_dtype: str) -> torch.Tensor:
    """Round an upload payload to the uplink precision. The port runs the
    float32 uplink, which passes ``x`` through; the narrower precisions
    wait for ROADMAP Queue 1 item 11 (uplink compression)."""
    if upload_dtype == "float32":
        return x
    raise NotImplementedError(
        f"uplink_dtype={upload_dtype!r} is not ported yet (ROADMAP Queue 1 "
        f"item 11 (uplink compression)); the port runs 'float32'")


def apportion(counts: torch.Tensor, total: int) -> torch.Tensor:
    """Largest-remainder apportionment of ``total`` across machines.

    Args:
      counts: (m,) int32 live-point counts per machine.
      total: global sample budget (static).

    Returns:
      (m,) int32 with  c_j <= counts_j  and  sum(c) == min(total, sum(counts))
      up to float-rounding slack of a few units (weight-0 padding absorbs it).
    """
    m = counts.shape[0]
    cf = counts.to(torch.float32)
    n = torch.sum(cf)
    total_eff = torch.clamp(n, max=float(total))
    quota = torch.where(n > 0, total_eff * cf / torch.clamp(n, min=1.0),
                        0.0)
    base = torch.minimum(torch.floor(quota), cf)
    r = total_eff - torch.sum(base)                      # leftover budget
    frac = quota - base
    eligible = base < cf
    # rank machines by fractional part (eligible first, ties by id)
    order = torch.argsort(torch.where(eligible, -frac, torch.inf),
                          stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(m, device=counts.device)
    add = (rank.to(torch.float32) < r) & eligible
    c = base + add.to(torch.float32)
    return torch.minimum(c, cf).to(torch.int32)


def exclusive_cumsum(c: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(c, 0, dtype=c.dtype) - c


def sample_local(gen: torch.Generator, alive: torch.Tensor, c: torch.Tensor,
                 cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``c[j]`` live points of each machine uniformly without
    replacement (Gumbel top-k), all machines at once.

    Args:
      gen: generator on ``alive``'s device.
      alive: (m, p) bool.
      c: (m,) int32 draw counts, each <= that machine's live count.
      cap: static upper bound on c (buffer width).

    Returns:
      idx: (m, cap) int64 point indices (the first ``c[j]`` are the draw).
      take: (m, cap) bool — ``arange(cap) < c[j]``.
    """
    m, p = alive.shape
    g = torch.rand((m, p), generator=gen, device=alive.device)
    g = g * (1.0 - 1e-7) + 1e-7                      # uniform in [1e-7, 1)
    scores = torch.where(alive, g, -1.0)
    _, idx = torch.topk(scores, min(cap, p), dim=1)
    if cap > p:  # degenerate tiny-machine case
        idx = torch.nn.functional.pad(idx, (0, cap - p))
    slot = torch.arange(cap, dtype=torch.int32, device=alive.device)
    return idx, slot[None, :] < c[:, None]


def scatter_at(comm, values: torch.Tensor, pos: torch.Tensor,
               take: torch.Tensor, rows: int) -> torch.Tensor:
    """Scatter machine-local rows at explicit global positions + psum.

    Args:
      values: (local_m, q, d); pos: (local_m, q) global row ids;
      take: (local_m, q) bool. Rows with pos outside [0, rows) are dropped.

    Returns:
      (rows, d) replicated buffer; untouched slots are exactly zero.

    Each machine's dense (rows, d) buffer is this path's wire, pad and
    all, and is recorded as such (the ragged gathers are the padless
    alternative).
    """
    m, q, d = values.shape
    keep = take & (pos >= 0) & (pos < rows)
    # dropped rows land, zeroed, on a spare row per machine, cut off below
    slot = torch.where(keep, pos, rows).to(torch.long)
    flat = (torch.arange(m, device=values.device)[:, None] * (rows + 1)
            + slot).reshape(-1)
    masked = (values * keep[..., None].to(values.dtype)).reshape(m * q, d)
    local = torch.zeros((m * (rows + 1), d), dtype=values.dtype,
                        device=values.device).index_add_(0, flat, masked)
    local = local.reshape(m, rows + 1, d)[:, :rows]
    record_wire(payload=m * rows * d * values.element_size() * comm._fan)
    return comm._reduce(local)


def gather_weighted(comm, pts: torch.Tensor, wts: torch.Tensor,
                    upload_dtype: str = "float32", wire: str = "values"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width weighted gather: per-machine summary blocks -> one
    replicated weighted point set.

    The coreset uplinks upload exactly ``t`` rows per machine (dead or
    empty machines send weight-0 rows), so the gather is a plain
    concatenation over machines, with no apportionment or offsets.

    Args:
      pts: (local_m, t, d) summary points.
      wts: (local_m, t) summary weights (0 = padding row).
      upload_dtype: payload precision; the points are quantized
        machine-side (``quantize_uplink``), the weights ride the metadata
        channel at full precision, like the HT weights.
      wire: "values" (blocks move at storage width); the int8 "codes"
        wire waits for ROADMAP Queue 1 item 11.

    Returns:
      ((m*t, d) points, (m*t,) float32 weights), both replicated.
    """
    if wire == "codes":
        raise NotImplementedError(
            "uplink_wire='codes' is not ported yet (ROADMAP Queue 1 item 11 "
            "(uplink compression)); the port runs 'values'")
    g_pts = comm.concat_machines(quantize_uplink(pts, upload_dtype))
    return g_pts, comm.concat_machines(wts.to(torch.float32), meta=True)


def global_weighted_choice(gen: torch.Generator, comm,
                           weights: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Sample one point globally with probability ∝ weights (two-stage:
    a machine by its weight mass, then a point of it by its weight).

    Args:
      weights: (local_m, p) nonneg, may be ragged-masked with zeros.
      x: (local_m, p, d).

    Returns:
      (d,) the selected point, replicated. A zero weight is never chosen
      (its Gumbel-max logit is -inf) unless every weight is zero.
    """
    mass_all = comm.all_machines(torch.sum(weights, dim=1))     # (m,)
    mid = gumbel_argmax(gen, mass_all)                          # () machine
    pidx = gumbel_argmax(gen, weights)                          # (local_m,)
    ids = comm.machine_ids(x.device)
    onehot = (ids == mid).to(x.dtype)
    picked = torch.gather(x, 1, pidx[:, None, None].expand(-1, 1, x.shape[-1])
                          )[:, 0, :]
    return comm.psum(picked * onehot[:, None])


def gumbel_argmax(gen: torch.Generator, p: torch.Tensor) -> torch.Tensor:
    """Index along the last axis drawn ∝ ``p`` (>= 0, not necessarily
    normalized), by the Gumbel-max trick with the explicit generator; a
    zero ``p`` is never drawn unless all are zero."""
    logp = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-38)),
                       -torch.inf)
    u = torch.rand(p.shape, generator=gen, device=p.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-38)))
    return torch.argmax(logp + gumbel, dim=-1)


def draw_global_sample(comm, gen: torch.Generator, x: torch.Tensor,
                       w: torch.Tensor, alive: torch.Tensor,
                       n_vec_resp: torch.Tensor, total: int, cap: int):
    """Exact-size global uniform sample with HT weights.

    Args:
      x: (m, p, d); w: (m, p) data weights; alive: (m, p).
      n_vec_resp: (m,) live counts of responding machines.
      total: global sample size (static, e.g. η); cap: per-machine buffer.

    Returns:
      (total, d) points and (total,) float32 weights, replicated; the
      realized draw count (a () int32 tensor).
    """
    ids = comm.machine_ids(x.device)
    c_vec = apportion(n_vec_resp, total)
    my_c = c_vec[ids]
    idx, take = sample_local(gen, alive, my_c, cap)
    pts = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    # buffer rows beyond the draw are never uploaded (the ragged gather
    # drops them); row 0 stands in for them, as in the reference
    pts = torch.where(take[..., None], pts, pts[:, :1])
    out = comm.gather_ragged(pts, c_vec, total)
    w_pt = torch.gather(w, 1, idx)
    n_local = torch.sum(alive, dim=1).to(torch.float32)
    ht = n_local / torch.clamp(my_c.to(torch.float32), min=1.0)
    wts = comm.gather_ragged(w_pt * ht[:, None], c_vec, total, meta=True)
    return out, wts, torch.sum(c_vec, dtype=torch.int32)
