"""The multi-process launch CLI (``python -m repro_torch.launch``).

Runs one ``repro_torch.api.fit`` on the mesh backend, one machine per
rank, and prints the wire telemetry as JSON (rank 0): achieved uplink
bytes per round beside the modeled bytes and the Ω(m·k) communication
frontier (Zhang et al., arXiv:1507.00026).

One host, N local ranks (the counterpart of emulating N devices)::

    python -m repro_torch.launch --devices 8 --algo soccer --k 16
    python -m repro_torch.launch --devices 4 --device cpu --algo lloyd

The ranks start by ``spawn`` and join a ``file://`` store; on the card
the kernels are built once before they start. Several hosts, one
process each, the same command on each::

    python -m repro_torch.launch --coordinator host0:29500 \\
        --num-processes 2 --process-id $RANK --algo soccer --k 16

The process-group backend is NCCL when every rank has a card of its own
and gloo when ranks share a card or run on the CPU; the choice is
printed on stderr. Every rank builds the same synthetic data from
``--seed`` and keeps its own machine's rows.
"""
from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch",
        description="Run a mesh-backend fit and print wire telemetry.")
    ap.add_argument("--devices", type=int, default=0,
                    help="spawn N local ranks, one machine each (0: join "
                         "the group --coordinator names, or run alone)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where each rank runs (cpu: the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--coordinator", default=None,
                    help="multi-host coordinator address host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--algo", default="soccer")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--n", type=int, default=1 << 14,
                    help="synthetic points (Gaussian blobs)")
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--uplink-dtype", default=None,
                    choices=[None, "float32", "bfloat16", "float16",
                             "int8"])
    ap.add_argument("--uplink-wire", default=None,
                    choices=[None, "auto", "codes", "values"])
    ap.add_argument("--param", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="extra algorithm knob, repeatable "
                         "(values parsed as JSON, falling back to str)")
    return ap


def _parse_params(pairs):
    out = {}
    for pair in pairs:
        name, _, value = pair.partition("=")
        if not _:
            raise SystemExit(f"--param expects NAME=VALUE, got {pair!r}")
        try:
            out[name] = json.loads(value)
        except json.JSONDecodeError:
            out[name] = value
    return out


def run(args) -> dict:
    """One mesh fit in an initialized group; the report (every rank)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.api import fit
    from repro_torch.api.backends import MeshBackend
    from repro_torch.api.result import omega_mk_bytes
    from repro_torch.launch.mesh import machine_mesh

    m = dist.get_world_size()
    backend = MeshBackend(machine_mesh(m))
    rng = np.random.default_rng(args.seed)
    centers = rng.normal(scale=4.0, size=(args.k, args.d))
    x = (centers[rng.integers(args.k, size=args.n)]
         + rng.normal(size=(args.n, args.d))).astype(np.float32)
    res = fit(x, args.k, algo=args.algo, backend=backend, m=m,
              seed=args.seed, uplink_dtype=args.uplink_dtype,
              uplink_wire=args.uplink_wire, device=args.device,
              **_parse_params(args.param))
    omega = omega_mk_bytes(m, args.k, args.d)
    wire_total = res.wire_bytes_total
    return {
        "algo": res.algo, "backend": res.backend,
        "m": m, "processes": m,
        "process_group": dist.get_backend(), "device": args.device,
        "k": args.k, "n": args.n, "d": args.d,
        "rounds": res.rounds,
        "uplink_points": [int(v) for v in res.uplink_points],
        "uplink_bytes_modeled": [int(v) for v in res.uplink_bytes],
        "wire_bytes": (None if res.wire_bytes is None
                       else [int(v) for v in res.wire_bytes]),
        "wire_meta_bytes": (None if res.wire_meta_bytes is None
                            else [int(v) for v in res.wire_meta_bytes]),
        "wire_bytes_total": wire_total,
        "omega_mk_bytes": omega,
        "bytes_vs_omega_mk": (None if wire_total is None
                              else round(wire_total / omega, 3)),
        "cost": res.cost(x, device=args.device),
        "wall_time_s": round(res.wall_time_s, 3),
    }


def _rank(rank: int, args) -> None:
    report = run(args)
    if rank == 0:
        print(json.dumps(report, indent=2), flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from repro_torch.launch.mesh import (initialize_multi_host,
                                         process_group_backend, spawn_local)
    if args.devices:
        if args.coordinator is not None:
            raise SystemExit("--devices spawns local ranks; it does not "
                             "take --coordinator")
        print(f"process group: {args.devices} local ranks over "
              f"{process_group_backend(args.device, args.devices)}",
              file=sys.stderr)
        spawn_local(_rank, args.devices, (args,), device=args.device)
        return 0
    world = initialize_multi_host(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        device=args.device)
    import torch.distributed as dist
    if world > 1:
        print(f"process group: rank {dist.get_rank()} of {world} over "
              f"{dist.get_backend()}", file=sys.stderr)
    else:
        raise SystemExit("no process group: pass --devices N, or "
                         "--coordinator with --num-processes and "
                         "--process-id")
    try:
        _rank(dist.get_rank(), args)
    finally:
        dist.destroy_process_group()
    return 0
