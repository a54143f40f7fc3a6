"""Time the port's k-means++ seeding on one CUDA card.

    python3 scripts/time_seeding.py [--src DIR] [--reps 3]

Loads ``repro_torch.core.kmeans.kmeans_plusplus`` from ``DIR`` (default:
this checkout's ``src``), so the same script times two trees in one call
(the parent's and the change's, in turns). For each (n, d, k) of
SHAPES it seeds uniform random float32 points with unit weights and
prints, for the best of ``--reps`` seedings after a warm-up:

* host ms: the wall time of the ``kmeans_plusplus`` call itself, before
  any synchronize (the host's own time to run the loop and enqueue it);
* wall ms: the wall time to the end of a ``torch.cuda.synchronize()``;
* device-busy ms: the union of the time ranges of the device-side
  events that ``torch.profiler`` records in one more seeding (kernels and
  copies; a seeding step launched as a programmatic dependent of the one
  before overlaps it, so a sum would count the overlap twice);
* the first 16 hex digits of the sha256 of the chosen centers' bits, so
  two trees' seedings can be compared bit for bit.

Then, at the first shape's n and d, it times one draw-off
``ops.update_min_dist`` call against one center (the parent loop's call
a step; its mass pass included): device µs a call by CUDA events over
back-to-back calls enqueued behind a device sleep (so the host has issued
them all before the device reaches them, and the events time the device
alone), and the host's µs a call, issued to an idle device.

The last line is one JSON object with the same numbers and the card's
name and power limit. Timing: ``cuda_timing.py``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

from cuda_timing import device_busy_ms, timed_ms

# (n, d, k): SOCCER k = 1000's coordinator seeding (eta rows, k_plus
# centers), then Table 2 rows 1 and 2's, then the kimi-k2 table fit's
# (PERF.md §4)
SHAPES = ((991_418, 15, 1_111), (17_353, 15, 103), (80_585, 15, 190),
          (43_106, 7_168, 78))


def time_draw_off(ops, x: torch.Tensor, w: torch.Tensor, reps: int = 50):
    """(device µs, host µs) a call of ops.update_min_dist on one center."""
    g = torch.Generator("cuda").manual_seed(2)
    d2 = torch.rand(x.shape[0], generator=g, device="cuda") * x.shape[1]
    c = x[5:6].float()
    ms = timed_ms(lambda: ops.update_min_dist(x, w, c, d2), reps)
    return ms * 1e3, ms.host_us


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_seeding.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.kmeans import kmeans_plusplus
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    out = []
    for n, d, k in SHAPES:
        g = torch.Generator("cuda").manual_seed(0)
        x = torch.rand((n, d), generator=g, device="cuda")
        w = torch.ones(n, device="cuda")

        def seed():
            return kmeans_plusplus(torch.Generator("cuda").manual_seed(1),
                                   x, w, k)
        first = seed()
        torch.cuda.synchronize()
        # the seeding's chosen rows, to compare two trees' bits
        digest = hashlib.sha256(first.cpu().numpy().tobytes()).hexdigest()
        host, wall = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            seed()
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        busy = device_busy_ms(seed)
        row = dict(n=n, d=d, k=k, host_ms=min(host) * 1e3,
                   wall_ms=min(wall) * 1e3, device_busy_ms=busy,
                   wall_us_per_step=min(wall) * 1e6 / k,
                   device_us_per_step=busy * 1e3 / k,
                   centers_sha256=digest[:16])
        print(f"seeding n={n} d={d} k={k}: host {row['host_ms']:.1f} ms, "
              f"wall {row['wall_ms']:.1f} ms "
              f"({row['wall_us_per_step']:.1f} us a step), device busy "
              f"{busy:.1f} ms ({row['device_us_per_step']:.1f} us a step); "
              f"centers sha256 {digest[:16]}", flush=True)
        out.append(row)
        if n == SHAPES[0][0]:
            dev_us, host_us = time_draw_off(ops, x, w)
            draw_off = dict(n=n, d=d, device_us=dev_us, host_us=host_us)
            print(f"draw-off update_min_dist n={n} d={d}, one center: "
                  f"{dev_us:.2f} us a call (host {host_us:.2f} us)",
                  flush=True)
        del x, w
    print(json.dumps({"src": args.src, "device": smi, "seedings": out,
                      "draw_off": draw_off}))


if __name__ == "__main__":
    main()
