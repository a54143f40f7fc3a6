"""``kzmeans`` — one-round distributed (k, z)-means with outlier
pre-aggregation (the port of ``repro.robust.kzmeans``).

The (k, z)-means objective scores a center set by the cost of the best
``n - z`` points: up to ``z = outlier_frac * n`` weight mass may be
discarded for free. The clusterz decomposition: the global top-z outliers
lie in the union of the per-machine top-z farthest points, so each machine
ships those explicitly and compresses only the rest.

1. **Per machine** (``_machine_summary``, a host loop over the machines):
   peel a provisional far-from-mean mass, seed a bicriteria solution on
   the rest, rank the shard by min-d2 to it and split off the ``t_out``
   farthest live points as outlier candidates (shipped with their true
   weights); the remainder, candidates zero-weighted, compresses to a
   ``t``-row sensitivity coreset (``coresets.build_coreset``).
2. **One gather** of the fixed-width ``(t + t_out)``-row blocks
   (``gather_weighted``).
3. **Coordinator**: best-of-4 k-means++ seedings over the gathered rows
   with the candidates' weights zeroed, kept by their trimmed cost; then
   ``trimmed_lloyd`` — each step assigns (``ops.min_dist``), trims the top
   ``z`` weight mass (``trim_top_mass``) and refits
   (``ops.lloyd_reduce``). Nothing in the loop reads back to the host.
4. **Scoring**: the trim threshold realized on the gathered rows is
   applied to the full data by ``ops.truncated_cost``, one launch over
   every machine; the per-machine (kept cost, tail mass, tail cost)
   triples psum into the (k, z) objective.

    fit(x, k, algo="kzmeans", outlier_frac=0.02)

With ``outlier_frac=0`` the candidate channel and the trim disappear and
this is a plain one-round coreset clustering.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import register_algorithm
from repro_torch.api.result import ClusterResult, uplink_bytes
from repro_torch.core.comm import wire_tally
from repro_torch.core.kmeans import draw_seed, kmeans_plusplus, pick_row
from repro_torch.core.sampling import gather_weighted
from repro_torch.core.soccer import check_run_knobs
from repro_torch.core.truncated_cost import trim_top_mass
from repro_torch.coresets.sensitivity import (build_coreset, coreset_draws,
                                              default_coreset_size,
                                              machine_data)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.exact import exact_cumsum, exact_row_sum
from repro_torch.obs import trace as obs_trace

# seedings drawn on the coordinator; the lowest trimmed cost is kept
SEEDINGS = 4


def _summary_draws(gen: torch.Generator, t: int, t_out: int, device):
    """One machine's random inputs to ``_machine_summary``, in the order
    it consumes them: the ranking's bicriteria key (with candidates),
    then the coreset's (``coreset_draws``)."""
    ranking = (draw_seed(gen, device),) if t_out else ()
    return ranking + coreset_draws(gen, t, device)


def _machine_summary(xp: torch.Tensor, wp: torch.Tensor, t: int, t_out: int,
                     kb: int, draws):
    """One machine's uplink block: ((t + t_out, d) rows, (t + t_out,)
    weights), the coreset first and the outlier candidates last, from the
    machine's ``_summary_draws``."""
    if t_out == 0:
        return build_coreset(None, xp, wp, t, kb, draws=draws)
    # Rank by distance to a bicriteria fit, but peel a provisional
    # far-from-mean mass before fitting it: seeded on the raw shard, the
    # bicriteria would place centers on the outliers (their D² mass
    # dominates the draw) and hide them from the ranking.
    wf = wp.to(torch.float32)
    xf = xp.to(torch.float32)
    mu = torch.sum(xf * wf[:, None], dim=0) / torch.clamp(torch.sum(wf),
                                                          min=1e-30)
    r2 = torch.sum((xf - mu) ** 2, dim=-1)
    _, idx0 = torch.topk(torch.where(wp > 0, r2, -torch.inf), t_out)
    bi = kmeans_plusplus(None, xp, wp.index_fill(0, idx0, 0.0), kb,
                         seed=draws[0])
    d2, _ = ops.min_dist(xp, bi)
    far = torch.where(wp > 0, d2, -torch.inf)     # dead rows never chosen
    _, idx = torch.topk(far, t_out)
    cand_w = torch.where(torch.isfinite(far[idx]), wp[idx], 0.0)
    cpts, cw = build_coreset(None, xp, wp.index_fill(0, idx, 0.0), t, kb,
                             draws=draws[1:])
    return (torch.cat([cpts, xp[idx]], dim=0),
            torch.cat([cw, cand_w.to(torch.float32)], dim=0))


def trimmed_lloyd(x: torch.Tensor, w: torch.Tensor, c0: torch.Tensor,
                  z_mass, iters: int) -> torch.Tensor:
    """Trimmed Lloyd: each iteration assigns the rows, drops the top
    ``z_mass`` weight by distance and refits on what remains; a center that
    keeps no mass stays where it was. Returns (k, d) float32 centers."""
    k = c0.shape[0]
    c = c0.to(torch.float32)
    for _ in range(iters):
        d2, assign = ops.min_dist(x, c)
        w_t = trim_top_mass(d2, w, z_mass)
        sums, counts = ops.lloyd_reduce(x, w_t, assign, k)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts[:, None], min=1e-30), c)
    return c


def realized_threshold(d2: torch.Tensor, w: torch.Tensor, z_mass
                       ) -> torch.Tensor:
    """The distance of the first kept row when the top ``z_mass`` weight is
    peeled off in descending order of ``d2``."""
    order = torch.argsort(-d2, stable=True)
    cum = exact_cumsum(w[order])
    z = torch.as_tensor(z_mass, dtype=cum.dtype, device=cum.device)
    j = torch.clamp(torch.searchsorted(cum, z.reshape(1)), max=d2.shape[0] - 1)
    return d2[order][j][0]


@register_algorithm("kzmeans")
def fit_kzmeans(x_parts, k: int, *, backend="virtual",
                generator: Optional[torch.Generator] = None, w=None,
                alive=None, seed: int = 0, outlier_frac: float = 0.0,
                coreset_size: int = 0, bicriteria: int = 0,
                lloyd_iters: int = 25, uplink_mode: Optional[str] = None,
                device: DeviceLike = "cuda", **run_knobs) -> ClusterResult:
    """One-round distributed (k, z)-means (see the module docstring).

    Args:
      outlier_frac: fraction z/n of the total weight the objective may
        discard (0 = plain coreset clustering, no candidate channel).
      coreset_size: total uplink budget in rows, split evenly across
        machines (0 = ``default_coreset_size`` plus the candidate
        channel). The candidate rows are carved out of the budget, so the
        uplink is the same whether or not the robust channel is on.
      bicriteria: machine-side bicriteria center count (0 = min(k, t)).
      uplink_mode: the uplink is a coreset plus candidate rows, so only
        "coreset" (or None) is valid.
    """
    if not 0.0 <= outlier_frac < 1.0:
        raise ValueError(f"outlier_frac must be in [0, 1), got "
                         f"{outlier_frac!r}")
    if uplink_mode not in (None, "coreset"):
        raise ValueError(
            f"kzmeans always uploads coresets + outlier candidates; "
            f"uplink_mode={uplink_mode!r} is contradictory")
    m, p, d = x_parts.shape
    bk, upload_dtype, wire = check_run_knobs(m, backend=backend,
                                             **run_knobs)
    # clusterz sizing: all z global outliers could sit on one machine, so
    # each ships up to z candidates (capped by its shard)
    t_out = min(p, int(math.ceil(outlier_frac * m * p)))
    total = coreset_size or (default_coreset_size(k, m * p) + m * t_out)
    rows = max(t_out + 1, -(-total // m))         # per-machine uplink rows
    t = rows - t_out                              # coreset rows
    kb = bicriteria or max(1, min(k, t))

    dev = resolve_device(device)
    comm = bk.make_comm(m)
    x, w_dev = machine_data(x_parts, w, alive, dev, bk)
    gen = (torch.Generator(dev).manual_seed(seed) if generator is None
           else generator)
    # candidate rows never seed (layout [t coreset | t_out candidates] per
    # machine)
    seed_mask = torch.cat([torch.ones(t, device=dev),
                           torch.zeros(t_out, device=dev)]).repeat(m)
    trace = obs_trace.current_trace()
    sc = obs_trace.step_clock()
    with obs_trace.span("kzmeans.upload"), wire_tally() as tally:
        draws = comm.machine_draws(
            lambda: _summary_draws(gen, t, t_out, dev))
        blocks = [_machine_summary(x[j], w_dev[j], t, t_out, kb, draws[j])
                  for j in range(comm.local_m)]
        g_pts, g_w = gather_weighted(
            comm, torch.stack([b[0] for b in blocks]),
            torch.stack([b[1] for b in blocks]), upload_dtype, wire=wire)
        n_mass = comm.psum(exact_row_sum(w_dev))      # population mass
        z_mass = n_mass * outlier_frac
        # best-of-4 seeding on the trimmed cost (outliers get no vote)
        seeds, costs = [], []
        for _ in range(SEEDINGS):
            c = kmeans_plusplus(gen, g_pts, g_w * seed_mask, k)
            d2s, _ = ops.min_dist(g_pts, c)
            seeds.append(c)
            costs.append(torch.sum(trim_top_mass(d2s, g_w, z_mass) * d2s))
        c0 = pick_row(torch.stack(seeds), torch.argmin(torch.stack(costs)))
        centers = trimmed_lloyd(g_pts, g_w, c0, z_mass, lloyd_iters)

        if outlier_frac > 0.0:
            d2g, _ = ops.min_dist(g_pts, centers)
            v = realized_threshold(d2g, g_w, z_mass)
        else:
            v = torch.full((), torch.finfo(torch.float32).max, device=dev)
        # the (k, z) objective on the full data: one launch over every
        # machine, the per-machine triples psum'd
        kept, tmass, tcost = (comm.psum(s) for s in ops.truncated_cost(
            x, w_dev, centers, v))
        # every machine with any uplink mass ships its full rows-block
        realized = torch.sum(torch.any(g_w.reshape(m, rows) > 0, dim=1)) * rows
        up = np.asarray([int(realized)], np.int64)
    sc.stop()
    if trace is not None:
        trace.emit_round(
            round=1, phase="upload", v=float(v), uplink_rows=up[0],
            wire_payload_bytes=tally.payload, wire_meta_bytes=tally.meta,
            wall_s=sc.wall_s, compile_s=sc.compile_s)
        trace.stop_reason = "one_shot"
    return ClusterResult(
        centers=centers.cpu().numpy(), k=k, algo="kzmeans",
        backend=bk.name, rounds=1, uplink_points=up,
        uplink_bytes=uplink_bytes(up, d, dtype=upload_dtype),
        wire_bytes=np.asarray([tally.payload], np.int64),
        wire_meta_bytes=np.asarray([tally.meta], np.int64),
        extra={"kz_cost": float(kept), "trim_threshold": float(v),
               "trimmed_mass": float(tmass), "trimmed_cost": float(tcost),
               "outlier_frac": float(outlier_frac),
               "coreset_rows_per_machine": t,
               "candidate_rows_per_machine": t_out, "bicriteria": kb})


# The uplink is a coreset (+ candidate rows) by construction, so
# fit(uplink_mode="coreset") is a validated no-op.
fit_kzmeans.supports_uplink_mode = True
