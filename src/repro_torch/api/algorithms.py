"""Built-in algorithm drivers for ``repro_torch.api.fit``.

The port registers SOCCER, the paper's Algorithm 1; the comparison
baselines follow in later slices (ROADMAP Queue 1 items 9-10).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.api.registry import register_algorithm
from repro_torch.api.result import ClusterResult, uplink_bytes
from repro_torch.configs.soccer_paper import SoccerParams
from repro_torch.core.soccer import RUN_KNOBS, run_soccer
from repro_torch.device import DeviceLike

_SOCCER_FIELDS = {f.name for f in dataclasses.fields(SoccerParams)}


def _reject_unknown(algo: str, params: dict, allowed: set):
    unknown = sorted(set(params) - allowed)
    if unknown:
        raise TypeError(
            f"fit(algo={algo!r}) got unexpected parameter(s) "
            f"{', '.join(unknown)}; allowed: {', '.join(sorted(allowed))}")


@register_algorithm("soccer")
def fit_soccer(x_parts, k: int, *, backend: str = "virtual",
               generator: Optional[torch.Generator] = None, w=None,
               alive=None, seed: int = 0, eta_override: int = 0,
               device: DeviceLike = "cuda", **params) -> ClusterResult:
    """SOCCER (the paper's Algorithm 1) via the host driver."""
    run_knobs = {n: params.pop(n) for n in RUN_KNOBS if n in params}
    _reject_unknown("soccer", params,
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
