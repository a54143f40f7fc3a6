"""The virtual backend's fit walls and device time on four cells, for A/B
runs of two trees on one CUDA card.

    python3 scripts/virtual_ab.py [--src DIR] [--reps 3] [--n 10000000]
        [--cells soccer,kmeans_parallel,soccer_sharded,kzmeans] [--ops N]

Loads ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script measures two trees in one call (run it parent, change,
change, parent). Draws the paper's §8 mixture as ``chip_smoke.py`` does
(10 M points, d = 15, k = 25, σ = 0.001, Zipf 1.5, seed 17, m = 8) and
fits, on the virtual backend:

* ``soccer``: Table 2 row 1 (ε = 0.05, δ = 0.1);
* ``kmeans_parallel``: k-means‖ row 1 (its defaults, 5 rounds);
* ``soccer_sharded``: row 1 with ``sharded_coordinator=True``;
* ``kzmeans``: the mixture with 2% gross outliers (``contaminate``,
  scale 50, seed 7; 10.2 M points), ``outlier_frac`` 0.02 and a
  1,640,000-row budget.

Each cell: one warm-up fit, then ``--reps`` timed fits, each printing its
wall (``api.fit`` to the end of a ``torch.cuda.synchronize()``), the
fit's own clock (``ClusterResult.wall_time_s``, which leaves out the
shard placement) and a digest of the centers (so two trees' fits compare
bit for bit); then one fit under ``torch.profiler`` whose device events'
union is the fit's device busy time (``cuda_timing.union_us``); with
``--ops N``, also that fit's N operators with the most self device time
and the N with the most self host time (the profiler's
``key_averages``: calls, device ms, host ms). The
last line is one JSON object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from cuda_timing import union_us

CELLS = {
    "soccer": dict(algo="soccer", epsilon=0.05, delta=0.1),
    "kmeans_parallel": dict(algo="kmeans_parallel"),
    "soccer_sharded": dict(algo="soccer", epsilon=0.05, delta=0.1,
                           sharded_coordinator=True),
    "kzmeans": dict(algo="kzmeans", outlier_frac=0.02,
                    coreset_size=1_640_000),
}


def top_ops(prof, n: int, by: str = "device") -> list:
    """The ``n`` operators of a profile with the most self device time
    (``by="device"``) or self host time (``by="host"``)."""
    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def host(e):
        return e.self_cpu_time_total
    rows = sorted(prof.key_averages(), key=dev if by == "device" else host,
                  reverse=True)[:n]
    return [dict(name=e.key, calls=e.count, device_ms=dev(e) / 1e3,
                 host_ms=host(e) / 1e3) for e in rows]


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--ops", type=int, default=0)
    args = ap.parse_args()
    cells = args.cells.split(",")
    unknown = set(cells) - set(CELLS)
    if unknown:
        sys.exit(f"unknown cells {sorted(unknown)}: expected {list(CELLS)}")
    if not torch.cuda.is_available():
        sys.exit("virtual_ab.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import api
    from repro_torch.configs.soccer_paper import GaussianMixtureSpec
    from repro_torch.data.synthetic import contaminate, gaussian_mixture

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}; src {args.src}", flush=True)
    x, _, _ = gaussian_mixture(GaussianMixtureSpec(
        n=args.n, dim=15, k=25, sigma=0.001, zipf_gamma=1.5, seed=17))
    xc = (contaminate(x, frac=0.02, scale=50.0, seed=7)[0]
          if "kzmeans" in cells else None)
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name in cells:
        kw = dict(CELLS[name])
        algo = kw.pop("algo")
        data = xc if name == "kzmeans" else x

        def one():
            t0 = time.perf_counter()
            res = api.fit(data, 25, algo=algo, m=8, seed=0, **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0
        one()                                                # warm-up
        fits = []
        for rep in range(args.reps):
            res, wall = one()
            digest = hashlib.sha256(np.ascontiguousarray(
                res.centers, np.float32).tobytes()).hexdigest()[:16]
            fits.append(dict(wall_s=wall, fit_s=res.wall_time_s,
                             digest=digest))
            print(f"{name} fit {rep}: wall {wall:.3f} s, fit's own clock "
                  f"{res.wall_time_s:.4f} s, centers {digest}", flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one()
        device = [(e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if getattr(e, "device_type", None) == cuda]
        busy = union_us(device) / 1e3
        print(f"{name} profiled fit: {len(device)} device events, busy "
              f"{busy:.2f} ms as a union", flush=True)
        out[name] = dict(fits=fits, busy_ms=busy, events=len(device))
        for by in ("device", "host") if args.ops else ():
            out[name][f"ops_by_{by}"] = top_ops(prof, args.ops, by)
            print(f"  the {args.ops} operators with the most {by} time:",
                  flush=True)
            for op in out[name][f"ops_by_{by}"]:
                print(f"  {op['name'][:60]:60s} {op['calls']:6d} calls "
                      f"device {op['device_ms']:.3f} ms host "
                      f"{op['host_ms']:.3f} ms", flush=True)
    print(json.dumps({"src": args.src, "device": smi, "n": args.n,
                      "cells": out}))


if __name__ == "__main__":
    main()
