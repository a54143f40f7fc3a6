"""``coreset_kmeans`` — the one-round distributed coreset baseline.

The port of ``repro.coresets.algorithms`` (Balcan et al. 2013): every
machine compresses its shard to a small weighted sensitivity coreset, the
coordinator gathers the m coresets in one round and runs the weighted
black box on their union::

    fit(x, k, algo="coreset_kmeans", coreset_size=2048)

The uplink is exactly the coreset rows; each row's weight rides the
metadata channel at full precision, like the HT weights of the sampling
paths.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import register_algorithm
from repro_torch.api.result import ClusterResult, uplink_bytes
from repro_torch.core.comm import VirtualCluster, wire_tally
from repro_torch.core.kmeans import kmeans
from repro_torch.core.minibatch import minibatch_kmeans
from repro_torch.core.sampling import gather_weighted
from repro_torch.core.soccer import check_run_knobs
from repro_torch.coresets.sensitivity import (build_coresets,
                                              default_coreset_size,
                                              machine_data)
from repro_torch.device import DeviceLike, resolve_device


@register_algorithm("coreset_kmeans")
def fit_coreset_kmeans(x_parts, k: int, *, backend: str = "virtual",
                       generator: Optional[torch.Generator] = None, w=None,
                       alive=None, seed: int = 0, coreset_size: int = 0,
                       bicriteria: int = 0, lloyd_iters: int = 25,
                       blackbox: str = "kmeans", minibatch_size: int = 1024,
                       uplink_mode: Optional[str] = None,
                       device: DeviceLike = "cuda",
                       **run_knobs) -> ClusterResult:
    """One-round coreset clustering: compress, gather once, solve.

    Args:
      coreset_size: total coordinator-side budget in rows, split evenly
        across machines (0 = ``default_coreset_size``).
      bicriteria: machine-side bicriteria center count (0 = min(k, t)).
      blackbox: coordinator solver, "kmeans" | "minibatch".
      uplink_mode: this algorithm's uplink is a coreset, so only
        "coreset" (or None) is valid.
    """
    if blackbox not in ("kmeans", "minibatch"):
        raise ValueError(f"coreset_kmeans blackbox must be 'kmeans' or "
                         f"'minibatch', got {blackbox!r}")
    if uplink_mode not in (None, "coreset"):
        raise ValueError(
            f"coreset_kmeans always uploads coresets; uplink_mode="
            f"{uplink_mode!r} is contradictory")
    upload_dtype, wire = check_run_knobs(backend=backend, **run_knobs)
    m, p, d = x_parts.shape
    total = coreset_size or default_coreset_size(k, m * p)
    t = max(1, -(-total // m))                    # per-machine rows
    kb = bicriteria or max(1, min(k, t))

    dev = resolve_device(device)
    comm = VirtualCluster(m)
    x, w_dev = machine_data(x_parts, w, alive, dev)
    gen = (torch.Generator(dev).manual_seed(seed) if generator is None
           else generator)
    with wire_tally() as tally:
        cpts, cw = build_coresets(gen, x, w_dev, t, kb)
        g_pts, g_w = gather_weighted(comm, cpts, cw, upload_dtype, wire=wire)
        if blackbox == "minibatch":
            centers, cost = minibatch_kmeans(gen, g_pts, g_w, k,
                                             batch=minibatch_size)
        else:
            centers, cost = kmeans(gen, g_pts, g_w, k, lloyd_iters)
        # every machine with any coreset mass ships its full t-row block
        # (weight-0 padding rows ride along)
        realized = torch.sum(torch.any(g_w.reshape(m, t) > 0, dim=1)) * t
    up = np.asarray([int(realized)], np.int64)
    return ClusterResult(
        centers=centers.cpu().numpy(), k=k, algo="coreset_kmeans",
        backend="virtual", rounds=1, uplink_points=up,
        uplink_bytes=uplink_bytes(up, d, dtype=upload_dtype),
        wire_bytes=np.asarray([tally.payload], np.int64),
        wire_meta_bytes=np.asarray([tally.meta], np.int64),
        extra={"blackbox_cost": float(cost), "coreset_rows_per_machine": t,
               "bicriteria": kb})


# Its uplink is a coreset by construction, so fit(uplink_mode="coreset")
# is a validated no-op rather than an error.
fit_coreset_kmeans.supports_uplink_mode = True
