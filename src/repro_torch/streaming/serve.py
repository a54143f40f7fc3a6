"""Batched nearest-center serving against versioned center snapshots.

The port of ``repro.streaming.serve``: the query path of the streaming
service. Queries are assigned to their nearest current center in chunks
of ``SERVE_BATCH`` rows, each padded to its ``stream_bucket`` width and
sent through the same kernel entry point the training path uses
(``kernels.ops.min_dist``), and every response is tagged with the
**version** of the center snapshot that produced it, so an assignment can
always be traced to the exact centers it was scored against even while
``fit_update`` rotates them underneath.

Snapshots are immutable; ``snapshot(result)`` captures the current
centers + version from any ``fit``/``fit_update`` result, and versions
are monotone. The ``streaming.serve.latency_ms`` histogram measures each
chunk from its start to the host holding its answer (the response is
host numpy), by the one obs clock.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.api.result import ClusterResult
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import clock
from repro_torch.streaming.tree import stream_bucket

#: Default serving batch width (rows per kernel launch).
SERVE_BATCH = 4096

# Per-chunk serving latency, in milliseconds: sub-ms steady state; the
# tail buckets catch first-call kernel builds and oversized chunks.
SERVE_LATENCY = REGISTRY.histogram(
    "streaming.serve.latency_ms",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
             250.0, 1000.0))


@dataclasses.dataclass(frozen=True)
class CenterSnapshot:
    """An immutable, versioned center set the serving path scores against."""
    centers: np.ndarray                 # (k, d) float32
    version: int                        # monotone; from StreamState.version

    @property
    def k(self) -> int:
        return self.centers.shape[0]

    @property
    def d(self) -> int:
        return self.centers.shape[1]


def snapshot(result: ClusterResult) -> CenterSnapshot:
    """Capture the serving snapshot from a ``fit``/``fit_update`` result.

    Batch ``fit`` results (no stream state) serve as version 0; every
    ``fit_update`` bumps the version with the center change.
    """
    state = result.extra.get("stream")
    if state is not None:
        return CenterSnapshot(np.asarray(state.centers, np.float32),
                              int(state.version))
    return CenterSnapshot(np.asarray(result.centers, np.float32)[-result.k:],
                          0)


def serve_assign(snap: CenterSnapshot, x, *, batch: int = SERVE_BATCH,
                 device: DeviceLike = "cuda"
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Assign a query batch to its nearest centers.

    Args:
      snap: the center snapshot to score against.
      x: (n, d) query points, any n.
      batch: rows per kernel launch; queries beyond it are chunked.
      device: where the kernel runs ("cuda" default, or "cpu").

    Returns:
      (assign, d2, version): (n,) int32 nearest-center ids, (n,) float32
      squared distances, and the snapshot version they were scored
      against.
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] != snap.d:
        raise ValueError(
            f"queries must be (n, {snap.d}), got {x.shape}")
    n = x.shape[0]
    centers = torch.as_tensor(snap.centers, device=dev)
    out_a = np.empty((n,), np.int32)
    out_d = np.empty((n,), np.float32)
    for off in range(0, n, batch):
        t0 = clock()
        rows = min(batch, n - off)
        pad = np.zeros((stream_bucket(rows), x.shape[1]), np.float32)
        pad[:rows] = x[off:off + rows]
        d2, idx = ops.min_dist(torch.from_numpy(pad).to(dev), centers)
        out_a[off:off + rows] = idx[:rows].cpu().numpy()
        out_d[off:off + rows] = d2[:rows].cpu().numpy()
        SERVE_LATENCY.observe((clock() - t0) * 1e3)
    return out_a, out_d, snap.version
