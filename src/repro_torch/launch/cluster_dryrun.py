"""SOCCER at the production mesh's size: one machine a device, 256 or 512
machines, its round's roofline.

The port of ``repro.launch.cluster_dryrun``: n = 10.24 M points (the
paper's 10 M synthetic runs), d = 15, k = 100, ε = 0.1, in both
coordinator modes:

* gather: paper-faithful, P1 / P2 gathered on the coordinator;
* sharded: beyond the paper, the samples stay sharded
  (``core/sharded_kmeans.py``).

The reference lowers one round against 256 or 512 placeholder devices.
SOCCER's host loop reads values (the live count, the stopping rule), so
a fake process group cannot stand in for it: the port runs the fit for
real on the virtual backend with m = 256 or 512 machines (a mesh fit
equals the virtual fit bit for bit) and reports its first round, per
machine:

* FLOPs and HBM bytes from the kernels' own counts, each call's inputs
  read once and outputs written once and 2·rows·centers·d operations a
  distance product (``PERF.md`` §6's bound formulas). A call over every
  machine's points (the removal pass; the sharded coordinator's buffers)
  is split evenly over the m machines; any other call runs on the
  coordinator, which is the machine reported;
* wire bytes from the round's tally (payload and metadata), which the
  coordinator receives;
* the three roofline terms (``roofline/analysis.py``), ``const`` (η,
  k_plus, machines) and ``soccer_model_flops``.

  PYTHONPATH=src python -m repro_torch.launch.cluster_dryrun [--multipod]
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib
from typing import Dict, List

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "chiprun_out" / \
    "dryrun_torch"

# the argument that holds a call's centers: its operations are a
# distance product, 2·rows·centers·d
_CENTERS_ARG = {"min_dist": 1, "remove_below": 1, "fused_assign_reduce": 2,
                "fused_assign_reduce_fixed": 2, "sensitivity_scores": 2,
                "truncated_cost": 2, "update_min_dist": 2}


def soccer_model_flops(const, n: int, d: int) -> float:
    """Useful flops a round: removal pass (n·k_plus·d·2) + coordinator
    lloyd (eta·k_plus·d·2·iters) + seeding + threshold pass."""
    removal = 2.0 * n * const.k_plus * d
    lloyd = 2.0 * const.eta * const.k_plus * d * (const.lloyd_iters + 1)
    thresh = 2.0 * const.eta * const.k_plus * d
    return removal + lloyd + thresh


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def call_counts(name: str, args, out):
    """(flops, bytes, rows) of one entry-point call: its tensor inputs
    read once and outputs written once."""
    x = args[0]
    d = x.shape[-1]
    rows = x.numel() // d
    nbytes = sum(t.numel() * t.element_size()
                 for t in _tensors(list(args)) + _tensors(out))
    if name in _CENTERS_ARG:
        c = args[_CENTERS_ARG[name]]
        flops = 2.0 * rows * (c.shape[0] if c.dim() == 2 else 1) * d
    elif name == "kmeans_plusplus_indices":
        # k draw-on steps, each reading x, w and d2 and writing d2
        k = int(args[2])
        flops = 2.0 * rows * d * k
        nbytes = k * (x.numel() * x.element_size() + 3 * rows * 4)
    else:   # kmeans_pp_step_at (one center), lloyd_reduce, fixed_bound
        flops = 2.0 * rows * d
    return flops, nbytes, rows


class KernelCalls:
    """Records every ``kernels.ops`` entry-point call made inside the
    block: (name, flops, bytes, rows, round)."""

    def __init__(self):
        self.calls: List[Dict] = []
        self.round = 1

    def _wrap(self, ops, name):
        real = getattr(ops, name)

        @functools.wraps(real)
        def call(*args, **kw):
            out = real(*args, **kw)
            flops, nbytes, rows = call_counts(name, args, out)
            self.calls.append(dict(name=name, flops=flops, bytes=nbytes,
                                   rows=rows, round=self.round))
            return out
        return real, call

    def __enter__(self):
        from repro_torch.kernels import ops
        self._saved = {}
        for name in ops.ENTRY_POINTS + ops.PART_ENTRY_POINTS:
            self._saved[name], wrapped = self._wrap(ops, name)
            setattr(ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, real in self._saved.items():
            setattr(ops, name, real)


def run(mode: str, multi_pod: bool, n: int = 10_240_000, d: int = 15,
        k: int = 100, tag: str = "baseline", *, machines: int = 0,
        device="cuda", seed: int = 0, save: bool = True,
        results: pathlib.Path = RESULTS, x=None) -> dict:
    """One SOCCER fit at m = ``machines`` (default 256, or 512 with
    ``multi_pod``) machines on the virtual backend over the paper's
    mixture of n points (or over ``x``, (n, d)); the record of its first
    round (and the fit's per-round wire bytes)."""
    import numpy as np
    from repro_torch.api import fit
    from repro_torch.configs.soccer_paper import (GaussianMixtureSpec,
                                                  SoccerParams)
    from repro_torch.core.soccer import derive_constants
    from repro_torch.data.synthetic import gaussian_mixture
    from repro_torch.roofline.analysis import Roofline
    m = machines or (512 if multi_pod else 256)
    sharded = mode.startswith("sharded")
    knobs = dict(epsilon=0.1, sharded_coordinator=sharded)
    if mode == "sharded_kps":
        knobs["sharded_seeding"] = "kmeanspar"
    if x is None:
        x, _, _ = gaussian_mixture(GaussianMixtureSpec(n=n, dim=d, k=k,
                                                       seed=17))
    n, d = x.shape
    const = derive_constants(n, n // m, SoccerParams(k=k, **knobs), m=m)
    rec_calls = KernelCalls()

    def next_round(r, state):
        rec_calls.round = r + 1

    with rec_calls:
        res = fit(x, k, algo="soccer", m=m, seed=seed, device=device,
                  on_round=next_round, **knobs)
    machine_rows = {m * (n // m), m * const.cap_sharded}
    first = [c for c in rec_calls.calls if c["round"] == 1]
    spread = [c for c in first if c["rows"] in machine_rows]
    coord = [c for c in first if c["rows"] not in machine_rows]
    flops = sum(c["flops"] for c in spread) / m + \
        sum(c["flops"] for c in coord)
    hbm = sum(c["bytes"] for c in spread) / m + \
        sum(c["bytes"] for c in coord)
    wire = np.asarray(res.wire_bytes, np.int64) + (
        0 if res.wire_meta_bytes is None
        else np.asarray(res.wire_meta_bytes, np.int64))
    roof = Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=float(wire[0]),
                    coll_by_kind={"gather": float(wire[0])},
                    model_flops=soccer_model_flops(const, n, d), chips=m)
    by_kernel: Dict[str, int] = {}
    for c in first:
        by_kernel[c["name"]] = by_kernel.get(c["name"], 0) + 1
    rec = {
        "arch": "soccer-paper",
        "shape": (f"n10M_k{k}_{mode}" if n == 10_240_000
                  else f"n{n}_k{k}_{mode}"),
        "mesh": "multipod" if multi_pod else "single", "tag": tag,
        "status": "ok", "n": n, "d": d, "k": k,
        "const": {"eta": const.eta, "k_plus": const.k_plus, "machines": m},
        "rounds": int(res.rounds),
        "wire_bytes_by_round": [int(w) for w in wire],
        "wire_bytes_total": int(res.wire_bytes_total),
        "uplink_points_by_round": [int(u) for u in res.uplink_points],
        "memory": {"shard_bytes_per_machine": (n // m) * d * 4},
        "roofline": roof.as_dict(),
        "kernel_calls_round1": by_kernel,
        "soccer_model_flops": soccer_model_flops(const, n, d),
    }
    if save:
        results.mkdir(parents=True, exist_ok=True)
        name = f"{rec['mesh']}_soccer-paper_{mode}"
        if tag != "baseline":
            name += f"_{tag}"
        (results / f"{name}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mode", default="both",
                    choices=["gather", "sharded", "sharded_kps", "both"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    modes = ["gather", "sharded"] if args.mode == "both" else [args.mode]
    for mode in modes:
        rec = run(mode, args.multipod, tag=args.tag, device=args.device)
        r = rec["roofline"]
        print(f"soccer/{mode:8s} mesh={rec['mesh']:9s} "
              f"tc={r['t_compute_s']:.4g} tm={r['t_memory_s']:.4g} "
              f"tx={r['t_collective_s']:.4g} "
              f"bottleneck={r['bottleneck']} rounds={rec['rounds']} "
              f"wire={rec['wire_bytes_total']} "
              f"calls={rec['kernel_calls_round1']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
