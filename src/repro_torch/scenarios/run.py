"""CLI: run a scenario sweep through the port and emit the comparable
report (the port of ``repro.scenarios.run``).

    PYTHONPATH=src python -m repro_torch.scenarios.run --suite paper --quick
    PYTHONPATH=src python -m repro_torch.scenarios.run --quick --device cpu

prints one table covering every registered scenario x algorithm x
condition cell (cost ratio vs. the exact-k-means baseline, rounds,
uplink points/bytes, wall time) and writes the same rows, with the
device they ran on, to ``BENCH_scenarios_torch.json``. On the card the
first fit of the process builds the kernels, so the first row's
``compile_s`` holds the ``nvcc`` build.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.scenarios import library  # noqa: F401  (registers scenarios)
from repro_torch.obs.trace import clock
from repro_torch.scenarios.registry import get_scenario, list_scenarios
from repro_torch.scenarios.report import (device_label, format_table,
                                          summarize_gap, write_bench_json)
from repro_torch.scenarios.sweep import DEFAULT_ALGOS, run_sweep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="paper-style scenario sweeps through "
                    "repro_torch.api.fit()")
    ap.add_argument("--suite", default="paper",
                    help="scenario tag (e.g. paper) or comma-separated "
                         "scenario names")
    ap.add_argument("--algos", default=",".join(DEFAULT_ALGOS),
                    help="comma-separated fit() algorithms (scenarios "
                         "with a pinned algos list — e.g. coreset_budget "
                         "— run their own list regardless)")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized data (each cell a few seconds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="virtual",
                    help="virtual | mesh | auto (mesh: one machine per "
                         "rank of the initialized process group main() "
                         "runs under, e.g. in each rank of repro_torch."
                         "launch.spawn_local; without one it raises "
                         "ValueError)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every fit runs (cpu: the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--out", default="BENCH_scenarios_torch.json",
                    help="perf-trajectory JSON path ('' to skip)")
    ap.add_argument("--trace-out", default="",
                    help="per-cell round-trace JSONL path (repro_torch.obs "
                         "format; render with `python -m "
                         "repro_torch.obs.report <path>`; '' to skip)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name in list_scenarios():
            print(f"{name:24s} {get_scenario(name).summary}")
        return 0

    names = (list_scenarios(tag=args.suite) if "," not in args.suite
             and args.suite not in list_scenarios()
             else tuple(s for s in args.suite.split(",") if s))
    if not names:
        print(f"no scenarios for suite {args.suite!r}; registered: "
              f"{', '.join(list_scenarios())}", file=sys.stderr)
        return 2
    algos = tuple(a for a in args.algos.split(",") if a)

    t0 = clock()
    rows = run_sweep(names, algos=algos, quick=args.quick, seed=args.seed,
                     backend=args.backend, device=args.device)
    print()
    print(format_table(rows))
    gap = summarize_gap(rows)
    if gap:
        print(f"\n# {gap}")
    device = device_label(args.device)
    print(f"# sweep wall time: {clock() - t0:.0f}s  "
          f"({len(names)} scenarios x {len(algos)} algos on {device})")
    from repro_torch.obs.export import writes_here
    if args.out and writes_here():
        path = write_bench_json(rows, args.out, suite=args.suite,
                                quick=args.quick, algos=algos,
                                seed=args.seed, device=device)
        print(f"# wrote {path}")
    if args.trace_out:
        from repro_torch.obs.export import write_jsonl
        traces = [r["trace"] for r in rows if r.get("trace")]
        path = write_jsonl(traces, args.trace_out)
        print(f"# wrote {path} ({len(traces)} cell trace(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
