"""SOCCER's fit wall and seeding device time at k = 1000, for A/B runs of
two trees on one CUDA card.

    python3 scripts/fit_ab.py [--src DIR] [--reps 3] [--k 1000]

Loads ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
the same script measures two trees in one call (run it parent, change,
change, parent). Draws the paper's §8 mixture as ``fit_profile`` does
(10 M points, d = 15, σ = 0.001, seed 17, m = 8) and fits it with SOCCER
at ε = 0.05, δ = 0.1: one warm-up fit, then ``--reps`` timed fits, each
printing

* wall s: ``api.fit`` to the end of a ``torch.cuda.synchronize()``;
* placement s: the host's time inside that fit's own shard placement
  (``data.sharding.make_shards``, timed by wrapping it);
* the wall less the placement, which the seeding can move.

Then one more fit under ``torch.profiler``, with every k-means++ seeding
(``core.kmeans.kmeans_plusplus``) fenced by ``torch.cuda.synchronize()``
on both sides and marked by ``record_function``, so that the device
events inside a seeding's host range are that seeding's own. It prints
the seedings' device time and the fit's device busy time, each both as
the sum of event times and as the union of their time ranges (the two
differ where events overlap, as programmatic dependent launches do).
The fences add host waits, so that fit's wall is not reported. The last
line is one JSON object. ``union_us``: ``cuda_timing.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cuda_timing import union_us

MARK = "fit_ab::seeding"


def fence_seedings(kmeans, shapes: list) -> None:
    """Replace kmeans_plusplus, in every loaded module of the port that
    holds it, by a fenced and marked call that appends its (rows, k) to
    ``shapes``."""
    orig = kmeans.kmeans_plusplus

    def fenced(gen, x, w, k):
        shapes.append((x.shape[0], k))
        torch.cuda.synchronize()
        with record_function(MARK):
            out = orig(gen, x, w, k)
            torch.cuda.synchronize()
        return out
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("repro_torch")
                and getattr(mod, "kmeans_plusplus", None) is orig):
            mod.kmeans_plusplus = fenced


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--n", type=int, default=10_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fit_ab.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import api
    from repro_torch.configs.soccer_paper import GaussianMixtureSpec
    from repro_torch.core import kmeans
    from repro_torch.data import sharding
    from repro_torch.data.synthetic import gaussian_mixture

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}; src {args.src}", flush=True)
    x, _, _ = gaussian_mixture(GaussianMixtureSpec(
        n=args.n, dim=15, k=args.k, sigma=0.001, seed=17))
    placed = []
    make_shards = sharding.make_shards

    def timed_shards(*a, **kw):
        t0 = time.perf_counter()
        out = make_shards(*a, **kw)
        placed.append(time.perf_counter() - t0)
        return out
    sharding.make_shards = timed_shards
    kw = dict(algo="soccer", m=8, seed=0, epsilon=0.05, delta=0.1)
    api.fit(x, args.k, **kw)                                 # warm-up
    torch.cuda.synchronize()

    fits = []
    for rep in range(args.reps):
        placed.clear()
        t0 = time.perf_counter()
        api.fit(x, args.k, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = dict(wall_s=wall, placement_s=sum(placed),
                   rest_s=wall - sum(placed))
        fits.append(row)
        print(f"fit {rep}: wall {wall:.3f} s, placement "
              f"{row['placement_s']:.3f} s, wall less placement "
              f"{row['rest_s']:.3f} s", flush=True)

    shapes = []
    fence_seedings(kmeans, shapes)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        api.fit(x, args.k, **kw)
        torch.cuda.synchronize()
    # the mark's host ranges; the device's kernels and copies, without the
    # device-side copy of the mark that the profiler adds (it spans the
    # seeding's gaps as well)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    windows = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == MARK and getattr(e, "device_type", None) != cuda]
    device = [(e.time_range.start, e.time_range.end) for e in events
              if getattr(e, "device_type", None) == cuda and e.name != MARK]
    seeding = [(a, b) for a, b in device
               if any(lo <= (a + b) / 2 <= hi for lo, hi in windows)]
    each = []
    for (rows, k), (lo, hi) in zip(shapes, windows):
        mine = [(a, b) for a, b in device if lo <= (a + b) / 2 <= hi]
        each.append(dict(rows=rows, k=k, events=len(mine),
                         sum_ms=sum(b - a for a, b in mine) / 1e3,
                         union_ms=union_us(mine) / 1e3))
        print(f"  seeding of {k} from {rows} rows: {len(mine)} device "
              f"events, {each[-1]['sum_ms']:.1f} ms summed, "
              f"{each[-1]['union_ms']:.1f} ms as a union", flush=True)
    prof_row = dict(
        seedings=len(windows), each=each, seeding_events=len(seeding),
        seeding_sum_ms=sum(b - a for a, b in seeding) / 1e3,
        seeding_union_ms=union_us(seeding) / 1e3,
        busy_sum_ms=sum(b - a for a, b in device) / 1e3,
        busy_union_ms=union_us(device) / 1e3)
    print(f"profiled fit: {len(windows)} seedings, {len(seeding)} device "
          f"events in them: {prof_row['seeding_sum_ms']:.1f} ms summed, "
          f"{prof_row['seeding_union_ms']:.1f} ms as a union; the fit's "
          f"device busy {prof_row['busy_sum_ms']:.1f} ms summed, "
          f"{prof_row['busy_union_ms']:.1f} ms as a union", flush=True)
    print(json.dumps({"src": args.src, "device": smi, "k": args.k,
                      "n": args.n, "fits": fits, "profiled": prof_row}))


if __name__ == "__main__":
    main()
