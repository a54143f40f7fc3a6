"""EIM11 (Ene, Im, Moseley 2011) — the paper's second baseline.

The port of ``repro.core.eim11`` on the virtual backend. Per round (paper §2's description): machines upload two samples;
the coordinator *adds the whole first sample to the clustering*, computes
a quantile threshold of the second sample's distances to the clustering,
and broadcasts the threshold **and the clustering** — whose size grows by
the full per-round sample (Θ(k·n^ε·log n) points, vs SOCCER's k₊). Every
machine then removes the points within the threshold; a fixed fraction of
the data is removed per round regardless of structure, so EIM11 *never
stops early*. The run surfaces the two costs the paper criticizes:
broadcast volume and machine-side distance work.

The clustering buffer has ``max_rounds·s`` rows and its valid rows are
always a prefix, so every distance pass of a round is taken to that
prefix only (the same d² and argmin as the full buffer with its mask).
The host loop reads one value back per round, the live count, as the
reference does; the uplink counts stay on the device until the end, and
the broadcast volume follows from host-known sizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm import VirtualCluster, wire_tally
from repro_torch.core.kmeans import kmeans
from repro_torch.core.metrics import assignment_counts
from repro_torch.core.reduce import reduce_to_k
from repro_torch.core.sampling import draw_global_sample
from repro_torch.core.soccer import check_run_knobs, effective_n
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.exact import exact_cumsum


@dataclasses.dataclass
class EIM11Result:
    centers: np.ndarray          # (k, d) final reduced centers
    rounds: int
    broadcast_points: int        # total points broadcast to machines
    n_hist: np.ndarray
    # points uploaded per round (two samples each) + the finalize gather
    uplink: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))
    # achieved wire bytes per round (core.comm.WireTally accounting)
    wire_payload: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))
    wire_meta: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))
    uplink_dtype: str = "float32"  # as check_run_knobs resolved it


def sample_sizes(m: int, p: int, k: int, epsilon: float, delta: float,
                 max_rounds: int, w=None, alive=None) -> Tuple[int, int]:
    """(s, rows): the per-round sample and clustering growth
    ``9·k·n^ε·log(n/δ)`` (sized from the live weight mass, like SOCCER's
    eta; capped at the live count) and the clustering buffer's height."""
    alive0 = np.ones((m, p), bool) if alive is None else np.asarray(
        alive, bool)
    n = int(np.sum(alive0))
    n_w = effective_n(m, p, w, alive0)
    s = min(int(math.ceil(9 * k * (n_w ** epsilon)
                          * math.log(n_w / delta))), n)
    return s, max_rounds * s


def weighted_quantile(d2: torch.Tensor, w: torch.Tensor,
                      q: float) -> torch.Tensor:
    """The smallest d2 whose cumulative weight share reaches ``q``
    (ties in d2 keep their input order)."""
    order = torch.argsort(d2, stable=True)
    cum = exact_cumsum(w[order])
    total = torch.clamp(cum[-1], min=1e-30)
    idx = torch.searchsorted(cum / total, torch.tensor(
        [q], dtype=cum.dtype, device=cum.device))
    return d2[order][torch.clamp(idx, max=d2.shape[0] - 1)][0]


def _round(comm: VirtualCluster, gen: torch.Generator, x: torch.Tensor,
           w: torch.Tensor, alive: torch.Tensor, centers: torch.Tensor,
           base: int, s: int, cap: int, remove_frac: float, uplink: dict):
    """One round; adds the first sample at rows [base, base + s) of
    ``centers`` in place. Returns the new alive mask, the () live count
    and the () points uploaded. ``uplink`` is the samples' upload dtype
    and wire."""
    m, p, d = x.shape
    n_vec = comm.all_machines(torch.sum(alive, dim=1, dtype=torch.int32))
    s1, _, r1 = draw_global_sample(comm, gen, x, w, alive, n_vec, s, cap,
                                   **uplink)
    s2, w2, r2 = draw_global_sample(comm, gen, x, w, alive, n_vec, s, cap,
                                    **uplink)
    # the coordinator adds the whole first sample to the clustering (the
    # clustering is broadcast downlink, so it stays float32; only the
    # uploads s1, s2 may arrive narrowed)
    centers[base:base + s] = s1
    clustering = centers[:base + s]
    d2s, _ = ops.min_dist(s2, clustering)
    v = weighted_quantile(d2s, w2, remove_frac)
    # machines: remove everything within the threshold
    d2x, _ = ops.min_dist(x.reshape(m * p, d), clustering)
    alive = alive & (d2x.reshape(m, p) > v)
    n_rem = comm.psum(torch.sum(alive, dim=1, dtype=torch.int32))
    return alive, n_rem, r1 + r2


def run_eim11(x_parts, k: int, epsilon: float, *, delta: float = 0.1,
              remove_frac: float = 0.5, w=None, alive=None,
              generator: Optional[torch.Generator] = None,
              max_rounds: int = 12, seed: int = 0,
              device: DeviceLike = "cuda", backend: str = "virtual",
              **run_knobs) -> EIM11Result:
    """Driver on the virtual backend; ``x_parts`` is (m, p, d), ``w`` and
    ``alive`` optional (m, p) weights and mask. ``run_knobs`` are the
    reference's run-condition options, checked by the one guard
    (``soccer.check_run_knobs``)."""
    upload_dtype, wire = check_run_knobs(backend=backend, **run_knobs)
    uplink = dict(upload_dtype=upload_dtype, wire=wire)
    dev = resolve_device(device)
    m, p, d = x_parts.shape
    comm = VirtualCluster(m)
    s, rows = sample_sizes(m, p, k, epsilon, delta, max_rounds, w, alive)
    cap = min(p, s)
    x = torch.as_tensor(x_parts, device=dev).to(torch.float32)
    w = (torch.ones((m, p), dtype=torch.float32, device=dev) if w is None
         else torch.as_tensor(np.asarray(w, np.float32), device=dev))
    alive = (torch.ones((m, p), dtype=torch.bool, device=dev)
             if alive is None
             else torch.as_tensor(np.asarray(alive, bool), device=dev))
    gen = (torch.Generator(dev).manual_seed(seed) if generator is None
           else generator)

    centers = torch.zeros((rows, d), dtype=torch.float32, device=dev)
    n = int(alive.sum())
    n_hist, ups, tallies = [n], [], []
    rounds = broadcast = 0
    n_rem = n
    while n_rem > s and rounds < max_rounds:
        with wire_tally() as t:
            alive, n_rem_t, up = _round(comm, gen, x, w, alive, centers,
                                        rounds * s, s, cap, remove_frac,
                                        uplink)
        n_rem = int(n_rem_t)          # the one device->host read a round
        rounds += 1
        # the coordinator re-broadcasts its whole clustering
        broadcast += min(rounds * s, rows)
        n_hist.append(n_rem)
        ups.append(up)
        tallies.append(t)

    # final: survivors -> coordinator -> k-means; then weighted reduction
    # over the clustering (its valid rows: the rounds' samples and c_fin)
    base = max(min(rounds * s, rows - k), 0)
    with wire_tally() as t_fin:
        n_vec = comm.all_machines(torch.sum(alive, dim=1, dtype=torch.int32))
        v_pts, v_w, real = draw_global_sample(comm, gen, x, w, alive, n_vec,
                                              s, cap, **uplink)
        c_fin, _ = kmeans(gen, v_pts, v_w, k)
        centers[base:base + k] = c_fin
        row = torch.arange(rows, device=dev)
        valid = (row < rounds * s) | ((row >= base) & (row < base + k))
        counts = assignment_counts(comm, x, w, centers, valid)
        final = reduce_to_k(gen, centers, counts * valid, k)
    tallies.append(t_fin)
    ups.append(real)

    up_arr = torch.stack(ups).cpu().numpy().astype(np.int64)
    return EIM11Result(
        centers=final.cpu().numpy(), rounds=rounds,
        broadcast_points=broadcast, n_hist=np.asarray(n_hist),
        uplink=up_arr,
        wire_payload=np.asarray([t.bytes_at(u) for t, u in
                                 zip(tallies, up_arr)], np.int64),
        wire_meta=np.asarray([t.meta_bytes_at(u) for t, u in
                              zip(tallies, up_arr)], np.int64),
        uplink_dtype=upload_dtype)
