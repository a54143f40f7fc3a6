"""Multi-pod dry run: every (arch × shape × mesh) cell's step, traced on
the fake 256- or 512-rank mesh.

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each cell's step against 512 placeholder devices; the port runs the
step itself as rank 0 of the fake backend's group
(``launch/mesh.py::make_production_mesh``) under ``FakeTensorMode``:
every tensor has its local shape and no storage, and every collective
returns at once. The train cells run ``launch/train.py``'s
``MeshTrainer.step`` (parameters and optimizer state stored as the
specs' shards, each block gathered around its use and its gradients
reduced to the shards, the update on the shards, the "2d"
tensor-parallel split and the sharded MoE inside); the prefill and
decode cells store the parameters alike, gather them whole for the
step and run ``lm_prefill`` / ``serve_step`` on the rank's rows of the
batch (a decode cache holds the rank's rows and every head). Each cell records:

* ``memory``: ``argument_bytes``, the bytes a device holds of the cell's
  arguments under the specs (``launch/input_specs.py``), and
  ``peak_per_device`` from ``torch.distributed._tools.mem_tracker``
  over the step;
* ``roofline``: ``roofline/analysis.py``'s terms from the step's
  ``roofline/op_stats.py`` statistics;
* ``status`` ok / skipped / error (with ``error`` and ``traceback``): a
  cell that raises is recorded as it failed.

This is shape arithmetic on the CPU, never a device measurement.
Results go to ``chiprun_out/dryrun_torch/<mesh>_<arch>_<shape>.json``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single          # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "chiprun_out" / \
    "dryrun_torch"


def _fake_batch(cfg, shape, rows):
    import torch
    from repro_torch.launch.input_specs import batch_structs
    out = {}
    for k, st in batch_structs(cfg, shape).items():
        local = (len(range(*rows.indices(st.shape[0]))),) + \
            tuple(st.shape[1:])
        out[k] = torch.zeros(local, dtype=st.dtype)
    return out


def _serve_step(cfg, shape, mesh):
    """(state, step fn) of a prefill or decode cell: the parameters as
    this rank's shards, gathered for the step."""
    import torch
    from repro_torch.launch.input_specs import make_partitioner, tp_axis_of
    from repro_torch.launch.train import local_rows, shard, unshard_all
    from repro_torch.models.model import init_cache, init_lm, lm_prefill
    from repro_torch.serve.decode import serve_step
    from repro_torch.sharding.activations import activation_mesh
    part = make_partitioner(mesh, cfg)
    model = init_lm(cfg, device="cpu")
    specs = part.specs(model)
    shards = {n: shard(p.detach(), specs[n], mesh)
              for n, p in model.named_parameters()}
    for p in model.parameters():
        p.data = p.data.new_empty((0,))
    rows = local_rows(mesh, part, shape.global_batch)
    batch = _fake_batch(cfg, shape, rows)
    b_local = batch["tokens"].shape[0]
    cache = (init_cache(cfg, b_local, shape.seq_len, device="cpu")
             if shape.kind == "decode" else None)

    def step():
        full = unshard_all(shards, specs, mesh)
        for n, p in model.named_parameters():
            p.data = full[n]
        with activation_mesh(mesh, tp_axis=tp_axis_of(cfg)), \
                torch.no_grad():
            if shape.kind == "prefill":
                out = lm_prefill(model, cfg, batch["tokens"],
                                 frontend=batch.get("frontend"),
                                 max_len=shape.seq_len)[0]
            else:
                out = serve_step(model, cfg, batch["tokens"], cache)[0]
        for p in model.parameters():
            p.data = p.data.new_empty((0,))
        return out

    return list(shards.values()) + ([] if cache is None else
                                    _leaves(cache)), step


def _train_step(cfg, shape, mesh):
    from repro_torch.launch.train import MeshTrainer, local_rows
    trainer = MeshTrainer(cfg, mesh, device="cpu")
    batch = _fake_batch(cfg, shape,
                        local_rows(mesh, trainer.part, shape.global_batch))
    held = list(trainer.params.values()) + list(trainer.opt_state.values())
    return held, lambda: trainer.step(batch)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             tag: str = "baseline", microbatches: int = 0,
             remat: str = "") -> dict:
    from repro_torch.configs import cell_is_applicable, get_config, get_shape
    from repro_torch.launch.input_specs import cell_specs, tree_shard_bytes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.analysis import (model_flops_for,
                                               roofline_from_stats)
    from repro_torch.roofline.op_stats import op_stats
    cfg = get_config(arch)
    if microbatches:
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = get_shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
           "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    if not cell_is_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = "long_500k needs sub-quadratic attention " \
            "(DESIGN.md §Arch-applicability)"
        return rec
    t0 = time.time()
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed._tools.mem_tracker import MemTracker
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
        chips = mesh.size()
        structs, specs = cell_specs(cfg, shape, mesh)
        arg_bytes = tree_shard_bytes(structs, specs, mesh)
        p_st, p_spec = ((structs[0]["params"], specs[0]["params"])
                        if shape.kind == "train" else (structs[0], specs[0]))
        param_bytes = tree_shard_bytes(p_st, p_spec, mesh)
        with FakeTensorMode(allow_non_fake_inputs=True):
            held, step = (_train_step if shape.kind == "train"
                          else _serve_step)(cfg, shape, mesh)
            t_build = time.time() - t0
            tracker = MemTracker()
            tracker.track_external(*held)
            with tracker, op_stats() as st:
                step()
            peak = tracker.get_tracker_snapshot("peak")
        peak_total = max(int(v.get("Total", 0)) for v in peak.values())
        roof = roofline_from_stats(st, model_flops_for(cfg, shape), chips)
        rec.update({
            "status": "ok",
            "build_s": round(t_build, 1),
            "step_s": round(time.time() - t0 - t_build, 1),
            "memory": {"argument_bytes": int(arg_bytes),
                       "param_bytes": int(param_bytes),
                       "peak_per_device": peak_total},
            "roofline": roof.as_dict(),
            "collective_ops": {k: int(v) for k, v in st.coll_ops.items()},
        })
    except Exception as e:  # noqa: BLE001 - record, don't kill the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def save(rec: dict, results: pathlib.Path = RESULTS) -> pathlib.Path:
    results.mkdir(parents=True, exist_ok=True)
    name = f"{rec['mesh']}_{rec['arch']}_{rec['shape']}"
    if rec.get("tag", "baseline") != "baseline":
        name += f"_{rec['tag']}"
    path = results / f"{name}.json"
    path.write_text(json.dumps(rec, indent=1))
    return path


def main(argv=None) -> int:
    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--remat", default="")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    results = pathlib.Path(args.out)

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                suffix = "" if args.tag == "baseline" else f"_{args.tag}"
                out = results / \
                    f"{mesh_kind}_{arch}_{shape_name}{suffix}.json"
                if args.skip_done and out.exists() and \
                        json.loads(out.read_text()).get("status") in \
                        ("ok", "skipped"):
                    continue
                rec = run_cell(arch, shape_name, mesh_kind, args.tag,
                               args.microbatches, args.remat)
                save(rec, results)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" frac={r['roofline_frac']:.3f}"
                             f" mem={rec['memory']['peak_per_device']/2**30:.2f}GiB"
                             f" step={rec['step_s']}s")
                elif status == "error":
                    extra = " " + rec["error"][:160]
                    failures += 1
                print(f"[{mesh_kind:8s}] {arch:24s} {shape_name:12s} "
                      f"{status}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
