"""One small ``fit()`` per registered algorithm, then the telemetry screen.

The port of ``repro.api.selfcheck``:

    PYTHONPATH=src python -m repro_torch.api.selfcheck            # the card
    PYTHONPATH=src python -m repro_torch.api.selfcheck --device cpu

Runs in seconds. Each algorithm's result is checked for finite (c, d)
centers, one uplink byte count a round, a finite cost and per-round wire
bytes that sum to the total; a check that fails is printed and counted,
and the exit code is 1 if any failed. A fit that raises is not caught:
its traceback ends the run. The telemetry screen is a traced SOCCER fit
rendered by ``repro_torch.obs.report``'s formatter, with the registry's
view of the wire tallies and the kernel launches.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.api import fit, list_algorithms
from repro_torch.api.result import omega_mk_bytes
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.report import format_summary

# keep the run fast: tiny n, few rounds/steps where configurable
_SMOKE_PARAMS = {
    "soccer": dict(epsilon=0.2),
    "kmeans_parallel": dict(rounds=2, lloyd_iters=5),
    "eim11": dict(epsilon=0.2, max_rounds=3),
    "lloyd": dict(iters=5),
    "minibatch": dict(batch=128, steps=10),
    "coreset_kmeans": dict(coreset_size=256, lloyd_iters=5),
}


def _problems(res, x, d: int, device: str) -> List[str]:
    """What is wrong with one fit's result (empty when nothing is)."""
    out = []
    if not np.all(np.isfinite(res.centers)):
        out.append("non-finite centers")
    if res.centers.ndim != 2 or res.centers.shape[1] != d:
        out.append(f"centers shaped {res.centers.shape}")
    if len(res.uplink_points) != len(res.uplink_bytes):
        out.append("uplink points and bytes differ in length")
    if int(np.sum(res.wire_bytes) + np.sum(res.wire_meta_bytes)) != \
            res.wire_bytes_total:
        out.append("per-round wire bytes do not sum to the total")
    cost = res.cost(x, device=device)
    if not (np.isfinite(cost) and cost >= 0.0):
        out.append(f"cost {cost}")
    return out


def _telemetry_screen(x, k: int, m: int, device: str) -> List[str]:
    """A traced SOCCER fit rendered with the shared report formatter,
    plus the registry view; returns what failed."""
    res = fit(x, k, algo="soccer", m=m, seed=0, trace="rounds",
              device=device, **_SMOKE_PARAMS["soccer"])
    t = res.extra["trace"]
    print()
    print(format_summary(t))
    omega = omega_mk_bytes(m, k, x.shape[-1])
    wire = res.wire_bytes_total
    print(f"wire_bytes_total={wire}  Omega(mk) floor={omega}  "
          f"ratio={wire / max(omega, 1):.1f}x")
    lines = REGISTRY.summary_lines("core.comm.active_tallies",
                                   "kernels.launches",
                                   "kernels.tuning.autotune")
    print("metrics: " + "; ".join(lines))
    out = []
    if t["wire_payload_bytes"] + t["wire_meta_bytes"] != wire:
        out.append("trace wire bytes do not sum to wire_bytes_total")
    if len(t["records"]) != res.rounds + 1:
        out.append(f"{len(t['records'])} records for {res.rounds} rounds")
    if REGISTRY.read("core.comm.active_tallies")[
            "core.comm.active_tallies"]["value"] != 0:
        out.append("a wire tally leaked past the fit")
    return out


def main(n: int = 2_000, d: int = 5, k: int = 4, m: int = 4,
         device: str = "cuda") -> int:
    """Returns the number of failed checks (0: all passed)."""
    rng = np.random.default_rng(0)
    means = rng.uniform(size=(k, d)).astype(np.float32)
    x = (means[rng.integers(0, k, n)]
         + 0.02 * rng.normal(size=(n, d))).astype(np.float32)

    failures = 0
    for algo in list_algorithms():
        res = fit(x, k, algo=algo, m=m, seed=0, device=device,
                  **_SMOKE_PARAMS.get(algo, {}))
        bad = _problems(res, x, d, device)
        failures += len(bad)
        if bad:
            print(f"smoke/{algo:16s} FAILED: {'; '.join(bad)}")
            continue
        print(f"smoke/{algo:16s} ok  centers={res.centers.shape[0]:3d} "
              f"rounds={res.rounds} "
              f"uplink={res.uplink_points_total}pts"
              f"/{res.uplink_bytes_total}B "
              f"cost={res.cost(x, device=device):.4g} "
              f"t={res.wall_time_s:.2f}s")
    bad = _telemetry_screen(x, k, m, device)
    for b in bad:
        print(f"smoke/telemetry       FAILED: {b}")
    return failures + len(bad)


def cli(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api.selfcheck",
        description="one small fit per registered algorithm + telemetry")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return min(main(device=args.device), 1)


if __name__ == "__main__":
    sys.exit(cli())
