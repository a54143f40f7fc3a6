"""The trace's overhead on SOCCER's host driver, on one CUDA card.

    python3 scripts/trace_overhead.py [--src DIR] [--trials 3]
        [--designs interleaved,blocked] [--groups 62] [--reps 10]

Times ``run_soccer`` at Table 2 row 1 (the paper's §8 mixture as
``chip_smoke.py`` draws it: 10 M points, d = 15, k = 25, ε = 0.05,
δ = 0.1, m = 8), the shards already on the card, untraced ("plain") and
under ``trace="rounds"``, and prints the traced-over-plain delta of each
design ``--trials`` times, so the designs' spreads compare on one card in
one call:

* ``interleaved`` (``chip_smoke.py``'s gate): ``--groups`` groups of
  ``--reps`` pairs of one plain and one traced run, the order within a
  pair alternating. Both halves of a group run under the same host
  conditions, so a shift of the host's speed between groups cancels in
  the group's delta;
* ``blocked`` (the gate's earlier design):
  ``--groups`` pairs of a plain and a traced block of ``--reps``
  back-to-back runs, the blocks' order alternating.

Each group (a pair of blocks) gives two deltas, of its fastest runs and
of its median runs; a design's reading is the median of each over the
groups. The last line is one JSON object; ``--out FILE`` also writes
every run's wall there.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Callable, Dict, List

import numpy as np

DESIGNS = ("interleaved", "blocked")


def measure(run: Callable[[bool], float], groups: int, reps: int,
            design: str = "interleaved") -> Dict[str, object]:
    """The traced-over-plain delta of ``run(traced) -> wall seconds``.

    Returns ``fastest`` and ``median`` (the median over the groups of the
    delta of the groups' fastest runs, and of their median runs), the
    plain and traced runs' fastest and median walls over every group, and
    each group's fastest-run delta, and every timed run as ``(traced,
    seconds)`` in the order it ran."""
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}: expected {DESIGNS}")
    for flag in (False, True):                # warm both paths
        for _ in range(reps):
            run(flag)
    best, mid = [], []                        # (plain, traced) a group
    walls: Dict[bool, List[float]] = {False: [], True: []}
    seq: List[tuple] = []                     # (traced, seconds) in order
    for g in range(groups):
        w: Dict[bool, List[float]] = {False: [], True: []}
        if design == "interleaved":
            for j in range(reps):
                order = (False, True) if (g + j) % 2 == 0 else (True, False)
                for flag in order:
                    w[flag].append(run(flag))
                    seq.append((flag, w[flag][-1]))
        else:
            order = (False, True) if g % 2 == 0 else (True, False)
            for flag in order:
                w[flag] = [run(flag) for _ in range(reps)]
                seq.extend((flag, s) for s in w[flag])
        best.append((min(w[False]), min(w[True])))
        mid.append((float(np.median(w[False])), float(np.median(w[True]))))
        for flag in (False, True):
            walls[flag].extend(w[flag])
    deltas = [b / a - 1.0 for a, b in best]
    return dict(
        design=design, groups=groups, reps=reps,
        fastest=float(np.median(deltas)),
        median=float(np.median([b / a - 1.0 for a, b in mid])),
        plain_fastest_s=min(walls[False]), traced_fastest_s=min(walls[True]),
        plain_median_s=float(np.median(walls[False])),
        traced_median_s=float(np.median(walls[True])),
        deltas=deltas, runs=seq)


def soccer_runner(parts, params) -> Callable[[bool], float]:
    """``run(traced)``: one ``run_soccer`` over ``parts`` (on the card),
    timed from a synchronized device to its return (its last reads bring
    the result to the host)."""
    import torch

    from repro_torch.core.soccer import run_soccer
    from repro_torch.obs import trace as obs_trace

    def run(traced: bool) -> float:
        torch.cuda.synchronize()
        t0 = obs_trace.clock()
        if traced:
            with obs_trace.run_trace(obs_trace.RunTrace("rounds")):
                run_soccer(parts, params, device=parts.device)
        else:
            run_soccer(parts, params, device=parts.device)
        return obs_trace.clock() - t0
    return run


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(root, "src"))
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--designs", default=",".join(DESIGNS))
    ap.add_argument("--groups", type=int, default=62)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    designs = args.designs.split(",")
    unknown = set(designs) - set(DESIGNS)
    if unknown:
        sys.exit(f"unknown designs {sorted(unknown)}: expected {DESIGNS}")
    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_overhead.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.configs.soccer_paper import (GaussianMixtureSpec,
                                                  SoccerParams)
    from repro_torch.data.sharding import make_shards
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}; src {args.src}; build {build.build_all():.2f} s",
          flush=True)
    x, _, _ = gaussian_mixture(GaussianMixtureSpec(
        n=10_000_000, dim=15, k=25, sigma=0.001, zipf_gamma=1.5, seed=17))
    parts, _, _ = make_shards(x, None, 8, seed=0)
    run = soccer_runner(torch.from_numpy(parts).cuda(),
                        SoccerParams(k=25, epsilon=0.05, delta=0.1, seed=0))
    out: Dict[str, list] = {d: [] for d in designs}
    for trial in range(args.trials):
        for design in designs:
            r = measure(run, args.groups, args.reps, design)
            out[design].append(r)
            print(f"trial {trial} {design}: fastest {100 * r['fastest']:+.3f}"
                  f"%, median {100 * r['median']:+.3f}%; plain fastest "
                  f"{1e3 * r['plain_fastest_s']:.3f} ms, traced fastest "
                  f"{1e3 * r['traced_fastest_s']:.3f} ms, plain median "
                  f"{1e3 * r['plain_median_s']:.3f} ms, traced median "
                  f"{1e3 * r['traced_median_s']:.3f} ms; group deltas "
                  f"{[round(100 * d, 3) for d in r['deltas']]} %", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"device": smi, "trials": out}, fh)
    for rs in out.values():
        for r in rs:
            del r["runs"]
    print(json.dumps({"device": smi, "groups": args.groups,
                      "reps": args.reps, "trials": out}))


if __name__ == "__main__":
    main()
