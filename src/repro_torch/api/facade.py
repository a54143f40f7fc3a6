"""``repro_torch.api.fit`` — the front end of the port.

    from repro_torch.api import fit
    res = fit(x, k=25, algo="soccer", epsilon=0.05)          # on the card
    res = fit(x, k=25, algo="soccer", device="cpu")          # plain PyTorch
    res = fit(x, k=100, algo="kmeans_parallel", rounds=5)    # the baselines
    res = fit(x, k=25, algo="eim11", epsilon=0.1)
    res = fit(x, k=25, algo="kzmeans", outlier_frac=0.02)    # robust tier
    res = fit(x, k=25, algo="coreset_kmeans", coreset_size=16_384)
    res = fit(x, k=25, uplink_mode="coreset")                 # SOCCER knob
    res.centers, res.rounds, res.uplink_points, res.cost(x)

``x`` is either flat ``(n, d)`` data (placed on ``m`` machines by
``shard_policy``, see ``repro_torch.data.sharding``) or pre-sharded
``(m, p, d)``, passed through untouched. The signature mirrors
``repro.api.fit``; the knobs the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import get_algorithm
from repro_torch.api.result import ClusterResult
from repro_torch.device import DeviceLike, resolve_device


def _as_parts(x: np.ndarray, w, m: int, seed: int, policy):
    """(n, d) -> ((m, p, d), (m, p) weights, (m, p) alive); 3-d passthrough."""
    if x.ndim == 3:
        return x, w, None
    from repro_torch.data.sharding import make_shards
    return make_shards(x, w, m, policy=policy, seed=seed)


def fit(x, k: int, algo: str = "soccer", backend="virtual", *,
        m: Optional[int] = None, w=None,
        generator: Optional[torch.Generator] = None, seed: int = 0,
        shuffle: bool = True, shard_policy=None, uplink_dtype=None,
        uplink_wire=None, uplink_mode=None, failure_plan=None, trace=None,
        device: DeviceLike = "cuda", **algo_params) -> ClusterResult:
    """Cluster ``x`` into ``k`` groups with a registered algorithm.

    Args:
      x: ``(n, d)`` points or ``(m, p, d)`` machine-sharded points.
      k: number of clusters.
      algo: registered algorithm name (``list_algorithms()``).
      backend: "virtual" (all machines on one device; "auto" is the same
        here); "mesh" is not ported yet.
      m: machine count for flat input (default 8, the paper's setup).
      w: optional per-point weights, shaped like ``x`` minus the last axis.
      generator: optional ``torch.Generator`` on ``device`` (default: one
        seeded with ``seed``).
      seed: seed for the default generator and the shard placement.
      shuffle: ``shuffle=False`` is ``shard_policy="contiguous"``.
      shard_policy: "shuffle" | "contiguous" | "sorted" | "imbalanced" or
        a callable (see ``repro_torch.data.sharding``).
      uplink_mode: "points" or "coreset" (SOCCER's machine-side coreset
        compression of each upload); algorithms registered with
        ``supports_uplink_mode`` only.
      uplink_dtype, uplink_wire, failure_plan, trace: the reference's
        run-condition knobs, passed to the algorithm; only their defaults
        run here.
      device: "cuda" (default; raises without CUDA) or "cpu", where the
        kernels' plain PyTorch versions run.
      **algo_params: algorithm-specific knobs (e.g. ``epsilon``).
    """
    dev = resolve_device(device)
    x = np.asarray(x)
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be (n, d) or (m, p, d), got {x.shape}")
    if x.ndim == 3:
        if m is not None and m != x.shape[0]:
            raise ValueError(f"m={m} conflicts with pre-sharded x of "
                             f"{x.shape[0]} machines")
        if shard_policy is not None:
            raise ValueError(
                "shard_policy only applies to flat (n, d) input; "
                "pre-sharded (m, p, d) data is passed through untouched")
        m = x.shape[0]
    else:
        m = 8 if m is None else m
    policy = shard_policy if shard_policy is not None else (
        "shuffle" if shuffle else "contiguous")
    parts, w_parts, alive_parts = _as_parts(x, w, m, seed, policy)
    driver = get_algorithm(algo)
    if uplink_mode is not None:
        if uplink_mode not in ("points", "coreset"):
            raise ValueError(
                f"unknown uplink_mode {uplink_mode!r}: expected 'points' "
                f"or 'coreset'")
        if not getattr(driver, "supports_uplink_mode", False):
            raise TypeError(
                f"fit(algo={algo!r}) does not support uplink_mode — the "
                f"algorithm has no compressible gather uplink; supported: "
                f"algorithms registered with supports_uplink_mode")
        algo_params["uplink_mode"] = uplink_mode

    t0 = time.perf_counter()
    res = driver(parts, k, backend=backend, generator=generator,
                 w=w_parts, alive=alive_parts, seed=seed, device=dev,
                 uplink_dtype=uplink_dtype, uplink_wire=uplink_wire,
                 failure_plan=failure_plan, trace=trace, **algo_params)
    res.wall_time_s = time.perf_counter() - t0
    res.params = dict(k=k, m=m, seed=seed, device=str(dev), **algo_params)
    if shard_policy is not None:
        res.params["shard_policy"] = getattr(policy, "__name__", policy)
    return res
