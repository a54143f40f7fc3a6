"""The stream protocol runner: one policy over one batch sequence.

The port of ``repro.streaming.protocol``, the measurement harness of the
streaming path: play a sequence of batches against an update *policy* and
score the two axes the service cares about —

* **staleness cost** — before each batch is folded in, it is served
  against the *current* (possibly stale) centers through
  ``streaming.serve``; the summed squared distances over the whole
  stream measure what users paid for center staleness;
* **recompute uplink** — every machine->coordinator byte the policy
  spent keeping centers fresh (initial fit + per-update refines +
  escalations, or one full re-cluster per step for the baseline).

Policies:

* ``full_every_step`` — the paper-faithful gold standard: a complete
  SOCCER ``fit`` over all data seen so far, every step. Freshest
  possible centers, maximal uplink. The seen-prefix is carried in a
  fixed full-stream-size buffer whose not-yet-arrived rows are weight-0
  AND dead (a callable shard policy masks them), as the reference's.
* ``fit_update`` at a cadence — fold every batch into the coreset trees,
  run the warm-start/drift-trigger update every ``cadence`` batches.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Tuple

import numpy as np

import torch

from repro_torch.api.facade import fit
from repro_torch.core.kmeans import kmeans
from repro_torch.core.metrics import centralized_cost
from repro_torch.data.sharding import _pack
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.streaming.serve import CenterSnapshot, serve_assign
from repro_torch.streaming.update import fit_update


@dataclasses.dataclass(frozen=True)
class StreamPolicy:
    """How a run keeps centers fresh while the stream flows.

    ``mode="full"`` re-clusters from scratch (cadence applies);
    ``mode="update"`` uses ``fit_update`` (fold always happens per
    update call; ``recluster`` controls escalation).
    """
    name: str
    mode: str = "update"                 # "update" | "full"
    cadence: int = 1                     # update every N batches
    recluster: str = "auto"              # fit_update escalation mode
    drift_tol: float = 2.0
    refine_iters: int = 4
    fit_params: Mapping = dataclasses.field(default_factory=dict)


def _serving_centers(result, k: int, x_live: np.ndarray,
                     device: torch.device) -> np.ndarray:
    """(k, d) serving centers from a batch ``fit`` result.

    SOCCER's ``centers`` are the UNION of every round's iteration centers
    plus the finalize block — more than k rows once removal rounds ran,
    and the trailing k alone only cluster the post-removal remainder. The
    serving set condenses the union: weight each union center by its
    assigned mass over the live prefix, then run a tiny weighted k-means
    (coordinator-local, zero uplink)."""
    c = np.asarray(result.centers, np.float32)
    if c.shape[0] == k:
        return c
    cd = torch.as_tensor(c, device=device)
    _, idx = ops.min_dist(torch.as_tensor(x_live, device=device), cd)
    masses = torch.bincount(idx, minlength=c.shape[0]).to(torch.float32)
    cond, _ = kmeans(torch.Generator(device).manual_seed(1), cd, masses, k,
                     10)
    return cond.cpu().numpy()


def _dead_weight_shards(x, w, m, rng):
    """Shard policy for the padded prefix buffer: weight-0 rows are not
    just massless but DEAD, so SOCCER's uniform sampler never wastes
    sample slots on not-yet-arrived rows."""
    n = x.shape[0]
    sizes = np.full((m,), n // m, np.int64)
    sizes[: n % m] += 1
    parts, ws, alive = _pack(x, w, rng.permutation(n), sizes)
    return parts, ws, alive & (ws > 0)


def run_stream(batches: List[np.ndarray], k: int, policy: StreamPolicy,
               *, m: int = 8, seed: int = 0, backend="virtual",
               device: DeviceLike = "cuda") -> dict:
    """Play ``batches`` against ``policy``; return one scoreboard row.

    The first batch always initializes with a full fit (both modes start
    from identical centers and pay identical uplink for it); scoring
    starts at the second batch.
    """
    dev = resolve_device(device)
    total_n = sum(b.shape[0] for b in batches)
    d = batches[0].shape[1]
    fitp = dict(policy.fit_params)

    # fixed-size seen-prefix buffer (full mode)
    buf_x = np.zeros((total_n, d), np.float32)
    buf_w = np.zeros((total_n,), np.float32)
    n_seen = batches[0].shape[0]
    buf_x[:n_seen] = batches[0]
    buf_w[:n_seen] = 1.0

    # both modes bootstrap with the identical full fit — best of three
    # seeds, because a single k-means++ finalize occasionally merges two
    # mixture components and a bad bootstrap would poison every policy's
    # reference cost identically. The scoreboard compares the bytes
    # spent KEEPING centers fresh afterwards, so the shared bootstrap
    # upload is reported separately, not in the totals.
    result, bootstrap_bytes, best = None, 0, np.inf
    for s in (seed, seed + 101, seed + 202):
        r = fit(buf_x, k, algo="soccer", backend=backend, m=m,
                w=buf_w, seed=s, shard_policy=_dead_weight_shards,
                device=dev, **fitp)
        bootstrap_bytes += int(r.uplink_bytes_total)
        c = float(r.cost(batches[0], device=dev))
        if c < best:
            result, best = r, c
    uplink_bytes: List[int] = []
    uplink_points: List[int] = []
    centers = _serving_centers(result, k, buf_x[:n_seen], dev)
    version = 0
    staleness = 0.0
    served = 0
    reclusters = 0
    pending: List[np.ndarray] = []

    for step, batch in enumerate(batches[1:], start=1):
        # serve the fresh arrivals against the current (stale) centers
        _, d2, _ = serve_assign(CenterSnapshot(centers, version), batch,
                                device=dev)
        staleness += float(np.sum(d2))
        served += batch.shape[0]

        buf_x[n_seen:n_seen + batch.shape[0]] = batch
        buf_w[n_seen:n_seen + batch.shape[0]] = 1.0
        n_seen += batch.shape[0]

        if policy.mode == "full":
            if step % policy.cadence == 0:
                result = fit(buf_x, k, algo="soccer", backend=backend,
                             m=m, w=buf_w, seed=seed + step,
                             shard_policy=_dead_weight_shards, device=dev,
                             **fitp)
                uplink_bytes.append(int(result.uplink_bytes_total))
                uplink_points.append(int(result.uplink_points_total))
                centers = _serving_centers(result, k, buf_x[:n_seen], dev)
                reclusters += 1
                version += 1
        else:
            pending.append(batch)
            if step % policy.cadence == 0:
                result = fit_update(
                    result, np.concatenate(pending), backend=backend,
                    m=m, seed=seed, refine_iters=policy.refine_iters,
                    drift_tol=policy.drift_tol,
                    recluster=policy.recluster,
                    recluster_params=fitp or None, device=dev)
                uplink_bytes.append(int(result.uplink_bytes[-1]))
                uplink_points.append(int(result.uplink_points[-1]))
                centers = np.asarray(result.centers)
                version = int(result.extra["version"])
                pending = []
    if policy.mode == "update":
        state = result.extra.get("stream")
        reclusters = state.n_reclusters if state is not None else 0

    final_cost = float(centralized_cost(
        torch.as_tensor(buf_x[:n_seen], device=dev),
        torch.as_tensor(centers, device=dev)))
    return dict(
        policy=policy.name, mode=policy.mode, cadence=policy.cadence,
        steps=len(batches), staleness_cost=staleness,
        staleness_per_point=staleness / max(served, 1),
        final_cost=final_cost,
        uplink_bytes=int(np.sum(uplink_bytes, dtype=np.int64)),
        uplink_points=int(np.sum(uplink_points, dtype=np.int64)),
        bootstrap_uplink_bytes=bootstrap_bytes,
        reclusters=int(reclusters),
        version=int(version))


def run_stream_suite(batches: List[np.ndarray], k: int,
                     policies: Tuple[StreamPolicy, ...], *, m: int = 8,
                     seed: int = 0, backend="virtual",
                     device: DeviceLike = "cuda") -> List[dict]:
    """All policies over one stream, with the cross-policy ratio columns
    the acceptance criteria read: every row gains ``cost_vs_full`` /
    ``staleness_vs_full`` / ``uplink_frac_of_full`` relative to the
    ``mode="full"``, cadence-1 row (when present)."""
    rows = [run_stream(batches, k, p, m=m, seed=seed, backend=backend,
                       device=device)
            for p in policies]
    full = next((r for r in rows
                 if r["mode"] == "full" and r["cadence"] == 1), None)
    if full is not None:
        for r in rows:
            r["cost_vs_full"] = (r["final_cost"]
                                 / max(full["final_cost"], 1e-30))
            r["staleness_vs_full"] = (r["staleness_cost"]
                                      / max(full["staleness_cost"], 1e-30))
            r["uplink_frac_of_full"] = (r["uplink_bytes"]
                                        / max(full["uplink_bytes"], 1))
    return rows
