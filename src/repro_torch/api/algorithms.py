"""Built-in algorithm drivers for ``repro_torch.api.fit``.

The port registers SOCCER, the paper's Algorithm 1, and its two
comparison baselines, k-means‖ and EIM11 (ROADMAP Queue 1 items 9-10),
with the reference's signatures and defaults; ``coreset_kmeans`` and
``kzmeans`` register from ``repro_torch.coresets`` and
``repro_torch.robust``. Each driver adapts one core
implementation to the registry contract and reports per-round uplink in
points and bytes, the achieved wire bytes, and the raw core result under
``extra["raw"]``. The run-condition options ``fit`` passes on are checked
by the drivers' one guard, ``core.soccer.check_run_knobs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import register_algorithm
from repro_torch.api.result import ClusterResult, uplink_bytes
from repro_torch.configs.soccer_paper import SoccerParams
from repro_torch.core.eim11 import run_eim11
from repro_torch.core.kmeans_parallel import run_kmeans_parallel
from repro_torch.core.soccer import RUN_KNOBS, run_soccer
from repro_torch.device import DeviceLike

_SOCCER_FIELDS = {f.name for f in dataclasses.fields(SoccerParams)}


def _reject_unknown(algo: str, params: dict, allowed: set):
    unknown = sorted(set(params) - allowed)
    if unknown:
        raise TypeError(
            f"fit(algo={algo!r}) got unexpected parameter(s) "
            f"{', '.join(unknown)}; allowed: {', '.join(sorted(allowed))}")


def _split_run_knobs(algo: str, params: dict, allowed: set) -> dict:
    """Take the run-condition options out of ``params`` and reject any
    other name that is not one of the algorithm's own ``allowed``."""
    run_knobs = {n: params.pop(n) for n in RUN_KNOBS if n in params}
    _reject_unknown(algo, params, allowed)
    return run_knobs


@register_algorithm("soccer")
def fit_soccer(x_parts, k: int, *, backend: str = "virtual",
               generator: Optional[torch.Generator] = None, w=None,
               alive=None, seed: int = 0, eta_override: int = 0,
               device: DeviceLike = "cuda", **params) -> ClusterResult:
    """SOCCER (the paper's Algorithm 1) via the host driver."""
    run_knobs = _split_run_knobs("soccer", params,
                                 _SOCCER_FIELDS - {"k", "seed", "n_machines"})
    m, _, d = x_parts.shape
    sp = SoccerParams(k=k, seed=seed, n_machines=m, **params)
    res = run_soccer(x_parts, sp, backend=backend, generator=generator, w=w,
                     alive=alive, eta_override=eta_override, device=device,
                     **run_knobs)
    up = res.uplink[: res.rounds + 1]
    return ClusterResult(
        centers=res.centers, k=k, algo="soccer", backend="virtual",
        rounds=res.rounds, uplink_points=np.asarray(up, np.int64),
        uplink_bytes=uplink_bytes(up, d),
        n_hist=res.n_hist[: res.rounds + 1],
        v_hist=res.v_hist[: res.rounds],
        wire_bytes=res.wire_payload, wire_meta_bytes=res.wire_meta,
        extra={"const": res.const, "state": res.state, "raw": res})


# fit(uplink_mode="coreset") routes through SoccerParams.uplink_mode
fit_soccer.supports_uplink_mode = True


@register_algorithm("kmeans_parallel")
def fit_kmeans_parallel(x_parts, k: int, *, backend: str = "virtual",
                        generator: Optional[torch.Generator] = None,
                        w=None, alive=None, seed: int = 0, rounds: int = 5,
                        l: Optional[float] = None, lloyd_iters: int = 25,
                        oversample_slack: float = 3.0,
                        device: DeviceLike = "cuda",
                        **params) -> ClusterResult:
    """k-means‖ (Bahmani et al.) — fixed-round oversampling baseline."""
    run_knobs = _split_run_knobs("kmeans_parallel", params, set())
    m, p, d = x_parts.shape
    if alive is not None:   # dead/padding points are weight-0 for k-means‖
        w = np.ones((m, p), np.float32) if w is None else np.asarray(
            w, np.float32)
        w = w * np.asarray(alive, np.float32)
    res = run_kmeans_parallel(x_parts, k, rounds, l=l, w=w,
                              generator=generator, lloyd_iters=lloyd_iters,
                              oversample_slack=oversample_slack, seed=seed,
                              device=device, backend=backend, **run_knobs)
    sel = [int(s) for s in res.selected_hist]
    up = np.asarray([1 + sel[0]] + sel[1:] if sel else [1], np.int64)
    return ClusterResult(
        centers=res.centers, k=k, algo="kmeans_parallel", backend="virtual",
        rounds=res.rounds, uplink_points=up, uplink_bytes=uplink_bytes(up, d),
        wire_bytes=res.wire_payload[:len(up)],
        wire_meta_bytes=res.wire_meta[:len(up)],
        extra={"phi_hist": res.phi_hist, "oversampled": res.oversampled,
               "raw": res})


@register_algorithm("eim11")
def fit_eim11(x_parts, k: int, *, backend: str = "virtual",
              generator: Optional[torch.Generator] = None, w=None,
              alive=None, seed: int = 0, epsilon: float = 0.1,
              delta: float = 0.1, remove_frac: float = 0.5,
              max_rounds: int = 12, device: DeviceLike = "cuda",
              **params) -> ClusterResult:
    """EIM11 (Ene, Im, Moseley 2011) — sample-everything baseline."""
    run_knobs = _split_run_knobs("eim11", params, set())
    d = x_parts.shape[-1]
    res = run_eim11(x_parts, k, epsilon, delta=delta,
                    remove_frac=remove_frac, w=w, alive=alive,
                    generator=generator, max_rounds=max_rounds, seed=seed,
                    device=device, backend=backend, **run_knobs)
    return ClusterResult(
        centers=res.centers, k=k, algo="eim11", backend="virtual",
        rounds=res.rounds, uplink_points=np.asarray(res.uplink, np.int64),
        uplink_bytes=uplink_bytes(res.uplink, d), n_hist=res.n_hist,
        wire_bytes=res.wire_payload, wire_meta_bytes=res.wire_meta,
        extra={"broadcast_points": res.broadcast_points, "raw": res})
