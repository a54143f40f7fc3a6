"""Time the port's lloyd_reduce, sensitivity_scores, Lloyd step and
truncated_cost on one CUDA card.

    python3 scripts/time_reduce.py [--src DIR] [--reps 20] [--only NAME]

Loads ``repro_torch.kernels.ops`` from ``DIR`` (default: this checkout's
``src``), so the same script times two trees in one call (the parent's
and the change's, in turns: parent, change, change, parent). At each
shape of SHAPES, float32 points and weights drawn from a seed, it prints:

* device ms a call, by CUDA events over ``--reps`` back-to-back calls
  enqueued behind a device sleep (so the host has issued them all before
  the device reaches them, and the events time the device alone);
* the host's µs a call (the least of three calls, each issued to an idle
  device);
* the device µs a call of each kernel and memset the call launches
  (``torch.profiler``), where the profiler sees device time.

``lloyd_reduce`` takes the assignment ``ops.min_dist`` gives to k random
centers; ``sensitivity_scores`` and the Lloyd step
(``fused_assign_reduce``, whose reduce the other two share) run against k
random centers, all valid; ``truncated_cost`` over the n points as
MACHINES shards of n / MACHINES rows, with v at the median d2. ``--only``
times the shapes of one entry point.

With ``--modes`` it times only ``sensitivity_scores`` at the widths of
MODE_KS, once with each accumulator mode of ``kernels.fused_lloyd``
(the wrapper's ``acc_mode`` replaced for the call): each warp's shared
rows against the global accumulators, where the wrapper would pick the
warp rows. Only a tree whose wrapper takes its mode from ``acc_mode``
can be timed so.

The last line is one JSON object with the same numbers and the card's
name and power limit. Timing: ``cuda_timing.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from cuda_timing import device_split, timed_ms

# (entry point, n, d, k): kzmeans' 1.64 M gathered rows at k = 25 and
# 1025 (warp and global accumulators); one machine's 1.275 M rows against
# kb = 25 bicriteria centers and SOCCER k = 1000's 1,111; the Lloyd step
# on k-means‖ row 1's 1.25 M rows at 25 and 831 centers (PERF.md §4)
SHAPES = (("lloyd_reduce", 1_640_000, 15, 25),
          ("lloyd_reduce", 1_640_000, 15, 1025),
          ("sensitivity_scores", 1_275_000, 15, 25),
          ("sensitivity_scores", 1_275_000, 15, 1_111),
          ("fused_assign_reduce", 1_250_000, 15, 25),
          ("fused_assign_reduce", 1_250_000, 15, 831),
          ("truncated_cost", 10_200_000, 15, 25),
          ("truncated_cost", 10_200_000, 15, 1),
          ("truncated_cost", 1_000_000, 15, 1_111))
# truncated_cost's shards: kzmeans' 8 machines of 1,275,000 rows (its
# scoring pass over all 10.2 M points), the same against one center (the
# walk nearly free: what the loads alone take), and 8 × 125,000 against
# SOCCER k = 1000's 1,111 centers (chip_smoke.py's REMOVE_WIDE_SHAPE)
MACHINES = 8
# --modes: sensitivity_scores on one machine's 1.275 M rows at widths
# from 256 centers to the warp rows' limit (kWarpAccEntries = 1,024)
MODE_KS = (256, 512, 1024)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--modes", action="store_true")
    ap.add_argument("--only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_reduce.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import ops, sensitivity

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi} src: {args.src}", flush=True)
    if args.modes:
        shapes = [("sensitivity_scores", 1_275_000, 15, k, mode)
                  for k in MODE_KS for mode in ("warp", "global")]
    else:
        shapes = [s + (None,) for s in SHAPES
                  if args.only in (None, s[0])]
    out = []
    for name, n, d, k, mode in shapes:
        g = torch.Generator("cuda").manual_seed(k)
        x = torch.rand((n, d), generator=g, device="cuda")
        w = torch.rand(n, generator=g, device="cuda")
        c = torch.rand((k, d), generator=g, device="cuda")
        if name == "lloyd_reduce":
            _, a = ops.min_dist(x, c)

            def fn():
                return ops.lloyd_reduce(x, w, a, k)
        elif name == "sensitivity_scores":
            def fn():
                return ops.sensitivity_scores(x, w, c)
        elif name == "truncated_cost":
            v = torch.median(ops.min_dist(x[:1_000_000], c)[0])
            xs = x.reshape(MACHINES, n // MACHINES, d)
            ws = w.reshape(MACHINES, n // MACHINES)

            def fn():
                return ops.truncated_cost(xs, ws, c, v)
        else:
            def fn():
                return ops.fused_assign_reduce(x, w, c)
        picked = getattr(sensitivity, "acc_mode", None)
        if mode is not None:
            sensitivity.acc_mode = lambda k_, d_: mode
        try:
            fn()
            ms = timed_ms(fn, args.reps)
            split = device_split(fn)
        finally:
            if mode is not None:
                sensitivity.acc_mode = picked
        tag = f" {mode} accumulators" if mode else ""
        print(f"{name} n={n} d={d} k={k}{tag} f32: {ms:.4f} ms a call, host "
              f"{ms.host_us:.1f} us; split: "
              + (", ".join(f"{nm} {us:.2f} us" for nm, us in split.items())
                 or "not measured"), flush=True)
        out.append(dict(name=name, n=n, d=d, k=k, mode=mode, ms=ms,
                        host_us=ms.host_us, split_us=split))
        del x, w, c
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "src": args.src, "calls": out}))


if __name__ == "__main__":
    main()
