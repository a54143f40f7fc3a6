"""k-means‖ (scalable k-means++, Bahmani et al. 2012) — the paper's baseline.

The port of ``repro.core.kmeans_parallel`` on the virtual backend.
Distributed seeding over the same machine/coordinator
abstraction as SOCCER: per round every point is selected with probability
min(1, l·w·d²(x,C)/φ(C)) (expected ``l`` selections, paper/MLLib default
l = 2k), the selections are scattered into the replicated center buffer
of ``1 + rounds·cap`` rows, and after ``rounds`` rounds the oversampled
set is weighed by a full assignment pass (``metrics.assignment_counts``,
the Lloyd kernel) and reduced to k with weighted k-means. k-means‖ has **no stopping mechanism** —
``rounds`` is the hyper-parameter the paper criticizes.

The reference runs all rounds as one ``lax.scan``; here they are a host
loop that reads nothing back from the device inside it: φ and the
selection counts stay on the card until the last round has been queued.
The reference's ``TRACE_COUNTS`` counts JAX traces of the round body and
has no counterpart in eager PyTorch, so it is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.comm import VirtualCluster, WireTally, wire_tally
from repro_torch.core.metrics import assignment_counts
from repro_torch.core.reduce import reduce_to_k
from repro_torch.core.sampling import (global_weighted_choice,
                                       quantize_uplink, scatter_selected)
from repro_torch.core.soccer import check_run_knobs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass
class KMeansParallelResult:
    centers: np.ndarray          # (k, d) final reduced centers
    oversampled: np.ndarray      # (C, d) the seeding set (valid rows)
    rounds: int
    phi_hist: np.ndarray         # cost before each round's selection
    selected_hist: np.ndarray    # points added per round
    # achieved wire bytes per round — the dense rank-positioned scatter
    # ships its full (rows, d + 1) buffer every round, pad included
    wire_payload: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))
    wire_meta: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))
    uplink_dtype: str = "float32"  # as check_run_knobs resolved it


def buffer_rows(k: int, rounds: int, l: Optional[float] = None,
                oversample_slack: float = 3.0) -> Tuple[float, int, int]:
    """(l, cap, rows): the expected selections per round, the per-round
    slot budget and the center buffer's height (kmeans_parallel.py:110-112
    of the reference)."""
    l = float(l if l is not None else 2 * k)
    cap = int(oversample_slack * l) + 16
    return l, cap, 1 + rounds * cap


def _one_round(comm: VirtualCluster, l: float, cap: int,
               gen: torch.Generator, x: torch.Tensor, payload: torch.Tensor,
               w: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor,
               base: int):
    """One oversampling round; writes into rows [base, base + cap).

    ``payload`` is ``x`` rounded to the uplink precision: the points the
    machines upload (the f32 scatter channel promotes them back).
    Rows from ``base`` on are all invalid when the round starts, so the
    distances are taken to ``centers[:base]``: the same d² as the full
    buffer, without streaming its empty rows past every point.
    """
    m, p, d = x.shape
    d2, _ = ops.min_dist(x.reshape(m * p, d), centers[:base], valid[:base])
    d2 = d2.reshape(m, p)
    phi = comm.psum(torch.sum(w * d2, dim=1))
    prob = torch.clamp(l * w * d2 / torch.clamp(phi, min=1e-30), max=1.0)
    sel = (torch.rand((m, p), generator=gen, device=x.device) < prob) & (w > 0)
    buf, c_vec = scatter_selected(comm, payload, sel, cap, base,
                                  centers.shape[0])
    landed = buf[:, -1] > 0
    new_centers = torch.where(landed[:, None], buf[:, :-1], centers)
    return (new_centers, valid | landed, phi,
            torch.sum(torch.clamp(c_vec, max=cap)))


def oversample(comm: VirtualCluster, gen: torch.Generator, x: torch.Tensor,
               w: torch.Tensor, rounds: int, l: float, cap: int, rows: int,
               upload_dtype: str = "float32"):
    """The seeding phase: one weighted choice, then ``rounds`` rounds,
    whose uploads are rounded to ``upload_dtype`` (int8: one code book a
    machine over its whole shard, as the reference quantizes ``x``).

    Returns the (rows, d) centers, (rows,) valid mask, (rounds,) φ and
    selection counts — all still on ``x``'s device, nothing read back —
    and the seed's and each round's ``WireTally``.
    """
    m, p, d = x.shape
    with wire_tally() as t_seed:
        c0 = global_weighted_choice(gen, comm, w, x)
    centers = torch.zeros((rows, d), dtype=torch.float32, device=x.device)
    centers[0] = c0
    # from a device-side compare: setting an element from a host value
    # would copy it to the card and wait for that copy
    valid = torch.arange(rows, device=x.device) == 0
    payload = quantize_uplink(x, upload_dtype)
    phis, nsels, tallies = [], [], []
    for r in range(rounds):
        with wire_tally() as t:
            centers, valid, phi, nsel = _one_round(
                comm, l, cap, gen, x, payload, w, centers, valid,
                1 + r * cap)
        phis.append(phi)
        nsels.append(nsel)
        tallies.append(t)
    empty = torch.zeros((0,), device=x.device)
    return (centers, valid,
            torch.stack(phis) if phis else empty,
            torch.stack(nsels) if nsels else empty.to(torch.int64),
            t_seed, tallies)


def run_kmeans_parallel(x_parts, k: int, rounds: int, *,
                        l: Optional[float] = None, w=None,
                        generator: Optional[torch.Generator] = None,
                        lloyd_iters: int = 25,
                        oversample_slack: float = 3.0, seed: int = 0,
                        device: DeviceLike = "cuda",
                        backend: str = "virtual",
                        **run_knobs) -> KMeansParallelResult:
    """Driver on the virtual backend; ``x_parts`` is (m, p, d) (numpy or a
    tensor), ``w`` optional (m, p) weights (0 = padding). ``run_knobs``
    are the reference's run-condition options, checked by the one guard
    (``soccer.check_run_knobs``); ``uplink_dtype`` rounds the uploaded
    points, and the wire is the dense f32 scatter channel whatever
    ``uplink_wire`` says, as in the reference."""
    upload_dtype, _ = check_run_knobs(backend=backend, **run_knobs)
    dev = resolve_device(device)
    m, p, d = x_parts.shape
    comm = VirtualCluster(m)
    x = torch.as_tensor(x_parts, device=dev).to(torch.float32)
    w = (torch.ones((m, p), dtype=torch.float32, device=dev) if w is None
         else torch.as_tensor(np.asarray(w, np.float32), device=dev))
    l, cap, rows = buffer_rows(k, rounds, l, oversample_slack)
    gen = (torch.Generator(dev).manual_seed(seed) if generator is None
           else generator)

    centers, valid, phis, nsels, t_seed, t_rounds = oversample(
        comm, gen, x, w, rounds, l, cap, rows, upload_dtype)
    with wire_tally() as t_counts:
        counts = assignment_counts(comm, x, w, centers, valid)
    final = reduce_to_k(gen, centers, counts * valid, k, lloyd_iters)

    # per-round achieved bytes, laid out as the reference's: the seeding
    # choice joins round 0 and the weighing pass the last round. Where no
    # round ran, the one entry holds the seed and the weighing alone.
    ticks: List[WireTally] = t_rounds or [WireTally()]
    wire_payload = np.asarray([t.payload for t in ticks], np.int64)
    wire_meta = np.asarray([t.meta for t in ticks], np.int64)
    wire_payload[0] += t_seed.payload
    wire_meta[0] += t_seed.meta
    wire_payload[-1] += t_counts.payload
    wire_meta[-1] += t_counts.meta
    return KMeansParallelResult(
        centers=final.cpu().numpy(),
        oversampled=centers[valid].cpu().numpy(), rounds=rounds,
        phi_hist=phis.cpu().numpy(), selected_hist=nsels.cpu().numpy(),
        wire_payload=wire_payload, wire_meta=wire_meta,
        uplink_dtype=upload_dtype)
