"""``fit_update`` — incremental clustering over a live point stream.

The port of ``repro.streaming.update``. One call folds a new batch into
the per-machine merge-and-reduce coreset trees
(``repro_torch.streaming.tree``: machine-local, zero uplink),
warm-starts Lloyd from the previous centers over the flattened tree
coreset (uplink: ``m * k`` rows of center sums per iteration,
independent of the batch or tree size), and escalates to a **full SOCCER
re-cluster** over the tree only when the drift trigger fires.

The trigger is SOCCER's own stopping rule (``core.soccer.stopping_rule``)
evaluated on costs instead of counts: ``fit_update`` issues a re-cluster
only while the warm-started centers' per-weight cost on the tree coreset
exceeds ``drift_tol`` times the reference cost recorded at the last full
re-cluster. Stationary streams therefore never re-cluster; a mean shift
or cluster birth that Lloyd cannot track from stale centers pushes the
cost over the budget and fires exactly when needed.

Uplink accounting (``ClusterResult.uplink_points``/``bytes`` are the
*per-update* realized uploads, so totals are cumulative over the
stream):

* fold: 0, the compression is machine-local;
* warm-start refine: ``m * k * refine_iters`` rows (each machine uploads
  its (k, d) weighted sums per Lloyd iteration);
* escalation: whatever the SOCCER run reports.

The refine is ``core.sharded_kmeans.distributed_lloyd`` (one Lloyd
launch over the flattened tree a step), ``core.metrics.distributed_cost``
and the total weight: plain calls, where the reference caches one
compiled body. Backends: None, "virtual" and "auto" run; a mesh backend
raises NotImplementedError with the reference's wording (its stream has
no mesh leg either), and "mesh" without a process group raises
``api.backends.resolve_backend``'s ValueError.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.api.backends import MeshBackend, resolve_backend
from repro_torch.api.registry import get_algorithm
from repro_torch.api.result import ClusterResult, uplink_bytes
from repro_torch.core.comm import VirtualCluster
from repro_torch.core.kmeans import kmeans
from repro_torch.core.metrics import assignment_counts, distributed_cost
from repro_torch.core.sharded_kmeans import distributed_lloyd
from repro_torch.core.soccer import stopping_rule
from repro_torch.coresets.sensitivity import default_coreset_size
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.streaming.state import StreamState
from repro_torch.streaming.tree import flatten_tree, fold_batch, stream_bucket

# Every drift-trigger evaluation lands here (fired or not) with the cost
# ratio it saw: the re-cluster decision history of a live stream.
DRIFT_EVENTS = REGISTRY.event_log("streaming.drift.events")


def _refine(comm: VirtualCluster, pts: torch.Tensor, ws: torch.Tensor,
            centers: torch.Tensor, iters: int):
    """Warm-start Lloyd over the sharded tree: (centers, cost, total w)."""
    new = distributed_lloyd(comm, pts, ws, centers, iters)
    cost = distributed_cost(comm, pts, ws, new)
    total_w = comm.psum(torch.sum(ws, dim=1))
    return new, cost, total_w


def _shard_stream_batch(x_new, w_new: Optional[np.ndarray], m: int,
                        device: DeviceLike = "cuda") -> tuple:
    """(n, d) batch -> ((m, pb, d), (m, pb)) tensors with a bucketed width.

    ``pb = stream_bucket(ceil(n / m))``; empty slots carry weight 0 (the
    compressor never samples them). Points land contiguously, machine j
    taking the next of m even quotas: in a real service each machine
    ingests its own stream.
    """
    x_new = np.asarray(x_new, np.float32)
    n, d = x_new.shape
    w_new = (np.ones((n,), np.float32) if w_new is None
             else np.asarray(w_new, np.float32))
    pb = stream_bucket(-(-n // m))
    xs = np.zeros((m, pb, d), np.float32)
    ws = np.zeros((m, pb), np.float32)
    quota = [n // m + (1 if j < n % m else 0) for j in range(m)]
    off = 0
    for j, q in enumerate(quota):
        xs[j, :q] = x_new[off:off + q]
        ws[j, :q] = w_new[off:off + q]
        off += q
    dev = resolve_device(device)
    return torch.as_tensor(xs, device=dev), torch.as_tensor(ws, device=dev)


def _condense_centers(gen: torch.Generator, centers: np.ndarray, k: int,
                      device: torch.device) -> np.ndarray:
    """A prior fit's center set (SOCCER returns the round union, which
    can exceed k rows) -> exactly (k, d) serving centers."""
    centers = np.asarray(centers, np.float32)
    if centers.shape[0] == k:
        return centers
    c = torch.as_tensor(centers, device=device)
    w = torch.ones((c.shape[0],), dtype=torch.float32, device=device)
    out, _ = kmeans(gen, c, w, k, 10)
    return out.cpu().numpy()


def init_stream(result: ClusterResult, *, m: Optional[int] = None,
                coreset_rows: int = 0, bicriteria: int = 0,
                seed: int = 0, device: DeviceLike = "cuda") -> StreamState:
    """Fresh StreamState warm-started from a batch ``fit`` result."""
    k = result.k
    m = m or int(result.params.get("m", 8))
    t = coreset_rows or max(128, default_coreset_size(k) // m)
    kb = bicriteria or max(1, min(k, t))
    state = StreamState(levels=[], occupied=[], centers=None, version=1,
                        key=np.asarray([seed, 0], np.int64), k=k, m=m, t=t,
                        kb=kb, device=resolve_device(device))
    state.centers = _condense_centers(state.generator(), result.centers, k,
                                      state.device)
    return state


def fit_update(result: ClusterResult, x_new, *, backend=None,
               w: Optional[np.ndarray] = None, m: Optional[int] = None,
               seed: int = 0, refine_iters: int = 4,
               drift_tol: float = 2.0, recluster: str = "auto",
               coreset_rows: int = 0, bicriteria: int = 0,
               recluster_params: Optional[dict] = None,
               device: DeviceLike = "cuda") -> ClusterResult:
    """Fold a new batch into a stream and return refreshed centers.

    Args:
      result: the previous ``fit``/``fit_update`` result. The stream
        state rides in ``result.extra["stream"]``; a plain batch-fit
        result initializes a fresh stream warm-started from its centers.
      x_new: (n_new, d) new points (any batch size).
      backend: None/"virtual"/"auto" (all machines on one device); a mesh
        backend raises NotImplementedError, as in the reference.
      w: optional (n_new,) weights for the new points.
      m / seed / coreset_rows / bicriteria: stream-init knobs (ignored
        after the first update; the state carries them).
      refine_iters: warm-start Lloyd iterations per update.
      drift_tol: re-cluster budget: escalate when the post-refine
        per-weight tree cost exceeds ``drift_tol * ref_cost``.
      recluster: "auto" (drift-triggered) | "always" | "never".
      recluster_params: extra SOCCER params for the escalation run
        (e.g. ``eta_override`` to force a multi-round re-cluster).
      device: where a new stream's tree lives ("cuda" default, or "cpu");
        a carried stream must be updated on its own device.

    Returns:
      A ``ClusterResult`` whose ``centers`` are the (k, d) refreshed
      serving centers, ``rounds`` counts full re-clusters so far, and
      ``uplink_points``/``uplink_bytes`` list every update's realized
      upload. The carried ``StreamState`` is at ``extra["stream"]``; the
      center snapshot version at ``extra["version"]``.
    """
    if recluster not in ("auto", "always", "never"):
        raise ValueError(
            f"unknown recluster mode {recluster!r}: expected 'auto', "
            f"'always' or 'never'")
    t0 = obs_trace.clock()
    state: Optional[StreamState] = result.extra.get("stream")
    dev = resolve_device(device)
    if state is None:
        state = init_stream(result, m=m, coreset_rows=coreset_rows,
                            bicriteria=bicriteria, seed=seed, device=dev)
    elif m is not None and m != state.m:
        raise ValueError(f"m={m} conflicts with the carried stream state "
                         f"(m={state.m})")
    elif dev != state.device:
        raise ValueError(f"device={dev} conflicts with the carried stream "
                         f"state (on {state.device})")
    bk = resolve_backend(backend, state.m)
    if isinstance(bk, MeshBackend):
        raise NotImplementedError(
            "fit_update currently runs on the virtual/comm backends; the "
            "mesh leg is the multi-host extension point (ROADMAP)")
    comm = bk.make_comm(state.m)
    d = state.centers.shape[1]

    # --- 1. fold the batch into the per-machine trees (zero uplink)
    xs, ws = _shard_stream_batch(x_new, w, state.m, dev)
    if xs.shape[-1] != d:
        raise ValueError(f"x_new has d={xs.shape[-1]}, stream carries d={d}")
    with obs_trace.span("streaming.fold"):
        fold_batch(state.levels, state.occupied, state.next_key(), xs, ws,
                   state.t, state.kb)
    state.n_seen += float(torch.sum(ws, dtype=torch.float64))

    # --- 2. warm-start Lloyd over the flattened tree coreset
    pts, wts = flatten_tree(state.levels, state.occupied, state.m,
                            state.t, d, dev)
    with obs_trace.span("streaming.refine"):
        centers, cost, total_w = _refine(
            comm, pts, wts, torch.as_tensor(state.centers, device=dev),
            refine_iters)
        cost_per_w = float(cost) / max(float(total_w), 1e-30)
    up_rows = state.m * state.k * refine_iters

    # --- 3. drift trigger: SOCCER's stopping rule on costs
    fire = {"auto": stopping_rule(cost_per_w,
                                  drift_tol * state.ref_cost, math.inf)
            if math.isfinite(state.ref_cost) else False,
            "always": True, "never": False}[recluster]
    DRIFT_EVENTS.append(
        update=int(state.n_updates), fired=bool(fire),
        cost_per_weight=cost_per_w, ref_cost=state.ref_cost,
        version=int(state.version))
    reclustered = False
    if fire:
        obs_trace.event("streaming.drift.recluster",
                        update=int(state.n_updates),
                        cost_per_weight=cost_per_w,
                        ref_cost=state.ref_cost)
        with obs_trace.span("streaming.recluster"):
            w_np = wts.cpu().numpy()
            rc = get_algorithm("soccer")(
                pts.cpu().numpy(), state.k, generator=state.generator(),
                w=w_np, alive=w_np > 0, seed=int(state.n_updates) + 1,
                device=dev, **(recluster_params or {}))
            # SOCCER's solution is the UNION of every round's centers plus
            # the finalize block (> k rows once removal rounds ran), so the
            # k serving centers come from condensing the union: weight each
            # union center by its assigned tree-coreset mass, run a small
            # weighted k-means, then warm-refine over the tree.
            union = torch.as_tensor(rc.centers, dtype=torch.float32,
                                    device=dev)
            masses = assignment_counts(comm, pts, wts, union)
            cond, _ = kmeans(state.generator(), union, masses, state.k, 10)
            centers, cost, total_w = _refine(comm, pts, wts, cond,
                                             refine_iters)
            cost_per_w = float(cost) / max(float(total_w), 1e-30)
        up_rows += int(rc.uplink_points_total)
        state.n_reclusters += 1
        state.ref_cost = cost_per_w
        reclustered = True
    elif not math.isfinite(state.ref_cost):
        state.ref_cost = cost_per_w      # first update sets the reference
    else:
        # ratchet: the reference is the best per-weight cost ever seen,
        # so a lucky warm start tightens the drift band instead of a
        # stale early reference masking later drift
        state.ref_cost = min(state.ref_cost, cost_per_w)

    # --- 4. bookkeeping + result
    state.centers = centers.cpu().numpy()
    state.version += 1
    state.n_updates += 1
    state.uplink_points.append(int(up_rows))
    state.uplink_bytes.append(
        int(uplink_bytes(np.int64(up_rows), d, np.float32)))
    return ClusterResult(
        centers=state.centers, k=state.k, algo="stream", backend="virtual",
        rounds=state.n_reclusters,
        uplink_points=np.asarray(state.uplink_points, np.int64),
        uplink_bytes=np.asarray(state.uplink_bytes, np.int64),
        wall_time_s=obs_trace.clock() - t0,
        params=dict(k=state.k, m=state.m, t=state.t, kb=state.kb,
                    refine_iters=refine_iters, drift_tol=drift_tol,
                    recluster=recluster, device=str(dev)),
        extra={"stream": state, "version": state.version,
               "reclustered": reclustered, "cost_per_weight": cost_per_w,
               "ref_cost": state.ref_cost,
               "epsilon_bound": state.epsilon_bound,
               "resident_rows": state.resident_rows_per_machine})
