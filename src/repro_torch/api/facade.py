"""``repro_torch.api.fit`` — the front end of the port.

    from repro_torch.api import fit
    res = fit(x, k=25, algo="soccer", epsilon=0.05)          # on the card
    res = fit(x, k=25, algo="soccer", device="cpu")          # plain PyTorch
    res = fit(x, k=100, algo="kmeans_parallel", rounds=5)    # the baselines
    res = fit(x, k=25, algo="eim11", epsilon=0.1)
    res = fit(x, k=25, algo="kzmeans", outlier_frac=0.02)    # robust tier
    res = fit(x, k=25, algo="coreset_kmeans", coreset_size=16_384)
    res = fit(x, k=25, algo="lloyd")                         # gather all
    res = fit(x, k=25, uplink_mode="coreset")                 # SOCCER knobs
    res = fit(x, k=25, sharded_coordinator=True, blackbox="minibatch")
    res = fit(x, k=25, uplink_dtype="int8")                  # codes wire
    res = fit(x, k=25, failure_plan=FailurePlan(fail_at={1: (2,)}))
    res.centers, res.rounds, res.uplink_points, res.cost(x)

``x`` is either flat ``(n, d)`` data (placed on ``m`` machines by
``shard_policy``, see ``repro_torch.data.sharding``) or pre-sharded
``(m, p, d)``, passed through untouched. The signature mirrors
``repro.api.fit``; the knobs the port does not run yet (``trace``,
``backend="mesh"``) raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import get_algorithm
from repro_torch.api.result import ClusterResult
from repro_torch.core.sampling import check_uplink_dtype, check_uplink_wire
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ft.failures import FailurePlan


def _as_parts(x: np.ndarray, w, m: int, seed: int, policy):
    """(n, d) -> ((m, p, d), (m, p) weights, (m, p) alive); 3-d passthrough."""
    if x.ndim == 3:
        return x, w, None
    from repro_torch.data.sharding import make_shards
    return make_shards(x, w, m, policy=policy, seed=seed)


def _check_plan_machines(plan: FailurePlan, m: int) -> None:
    """Validate every fail_at machine id up front: a bad id fails here,
    not rounds into the run."""
    bad = sorted({j for ids in plan.fail_at.values() for j in ids
                  if not 0 <= j < m})
    if bad:
        raise ValueError(
            f"failure_plan names machine(s) {bad} but the data has m={m}")


def _mask_failed_machines(parts, w, alive, ids):
    """Zero out machines dead before round 1 (FailurePlan.fail_at[0])."""
    m, p, _ = parts.shape
    alive = (np.ones((m, p), bool) if alive is None
             else np.array(alive, copy=True))
    w = (np.ones((m, p), np.float32) if w is None
         else np.array(w, np.float32, copy=True))
    alive[list(ids)] = False
    w[list(ids)] = 0.0
    return w, alive


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
      uplink_dtype: machine->coordinator payload precision ("float32"
        default, "bfloat16", "float16", "int8"; a name or a torch dtype);
        uploads are quantized and ``uplink_bytes`` accounted at its width.
      uplink_wire: payload transport: "codes" moves int8 codes plus
        per-machine affine qparams, "values" the reconstructed values at
        storage width, "auto" (default) "codes" iff int8.
      uplink_mode: "points" or "coreset" (SOCCER's machine-side coreset
        compression of each upload); algorithms registered with
        ``supports_uplink_mode`` only.
      failure_plan: a ``repro_torch.ft.failures.FailurePlan``: machine
        deaths and straggler deadlines, through the host loop's
        ``on_round`` hook (algorithms registered with
        ``supports_failure_plan``, i.e. SOCCER).
      trace: not ported yet (ROADMAP Queue 1 item 14); only None/"off".
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
    ud = None if uplink_dtype is None else check_uplink_dtype(uplink_dtype)
    if uplink_wire is not None:
        check_uplink_wire(uplink_wire, ud or "float32")
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

    if failure_plan is not None:
        if not isinstance(failure_plan, FailurePlan):
            raise TypeError(f"failure_plan must be a FailurePlan, got "
                            f"{type(failure_plan).__name__}")
        if not getattr(driver, "supports_failure_plan", False):
            raise TypeError(
                f"fit(algo={algo!r}) does not support failure_plan — the "
                f"algorithm has no per-round host hook; supported: "
                f"algorithms registered with supports_failure_plan")
        _check_plan_machines(failure_plan, m)
        init_dead = failure_plan.initial_failures()
        if init_dead:
            w_parts, alive_parts = _mask_failed_machines(
                parts, w_parts, alive_parts, init_dead)
        algo_params["on_round"] = failure_plan.chain(
            algo_params.get("on_round"))
        if failure_plan.straggler_rate:
            algo_params.setdefault("straggler_rate",
                                   failure_plan.straggler_rate)

    t0 = time.perf_counter()
    res = driver(parts, k, backend=backend, generator=generator,
                 w=w_parts, alive=alive_parts, seed=seed, device=dev,
                 uplink_dtype=ud, uplink_wire=uplink_wire, trace=trace,
                 **algo_params)
    res.wall_time_s = time.perf_counter() - t0
    res.params = dict(k=k, m=m, seed=seed, device=str(dev), **algo_params)
    if shard_policy is not None:
        res.params["shard_policy"] = getattr(policy, "__name__", policy)
    if ud is not None:
        res.params["uplink_dtype"] = ud
    if uplink_wire is not None:
        res.params["uplink_wire"] = uplink_wire
    if failure_plan is not None:
        res.params["failure_plan"] = failure_plan
        res.params.pop("on_round", None)
    return res
