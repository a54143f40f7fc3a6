"""The mesh train driver: mesh, sharded state, checkpoint and restart.

The port of ``repro.launch.train``, the mesh-aware counterpart of
``examples/train_lm_torch.py``. One process a rank of a
``torch.distributed`` group (``launch/mesh.py``: NCCL when each rank has
a card, gloo otherwise); the CLI starts ``prod(--mesh)`` local ranks
itself when no group is running. A rank:

* builds the ``DeviceMesh`` and the ``Partitioner``'s specs
  (``launch/input_specs.py``: "fsdp" archs over every axis, "2d" archs
  FSDP × TP) and installs ``sharding.activations.activation_mesh``;
* stores the parameters and the optimizer state as its shards of those
  specs (``shard``); each step gathers them whole (``unshard``, one
  all-gather over the axes of each split dim) into the model, runs
  ``train/train_step.py::make_train_step`` on the rank's slice of the
  batch, averages the gradients and metrics over the batch ranks (its
  ``grad_hook``), updates, and keeps its shards again; between steps the
  model holds no weights. Inside the step the "2d" archs split heads
  and ``d_ff`` over "model" where the specs shard them
  (``sharding.activations``), and the MoE layers go through
  ``models/moe_sharded.py``; a leaf whose rule falls back is only
  stored split;
* saves the whole state through ``checkpoint.Checkpointer`` from rank 0
  (the reference's on-disk layout) and restores it on every rank through
  ``Checkpointer.restore``'s placement, each rank taking its shards.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 50 --mesh 2,2 --device cpu

``train(cfg, ...)`` takes any config (``chip_smoke.py`` passes a
full-width one); the CLI is the reference's, always reduced.
"""
from __future__ import annotations

import argparse
import math
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.activations import (activation_mesh, axis_group,
                                              axis_index, gather_cat,
                                              reduce_sum)
from repro_torch.sharding.partition import Spec, axes_tuple, mesh_sizes


# ------------------------------------------------------------- layout
def shard(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a copy when any dim
    splits, else ``full`` itself)."""
    sizes = mesh_sizes(mesh)
    out = full
    for dim, axes in enumerate(spec):
        n = math.prod(sizes[a] for a in axes_tuple(axes))
        if n > 1:
            size = full.shape[dim] // n
            out = out.narrow(dim, axis_index(mesh, axes) * size, size)
    return out if out is full else out.contiguous().clone()


def unshard(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``local`` block (one all-gather
    over the axes of each split dim)."""
    sizes = mesh_sizes(mesh)
    out = local
    for dim, axes in enumerate(spec):
        if math.prod(sizes[a] for a in axes_tuple(axes)) > 1:
            out = gather_cat(out, axis_group(mesh, axes), dim)
    return out.contiguous()


def unshard_all(local: Dict[Any, torch.Tensor], specs: Dict[Any, Spec],
                mesh) -> Dict[Any, torch.Tensor]:
    """``unshard`` of every tensor of ``local``, bucketed: the tensors
    split on one dim over the same axes (and of one dtype) move in one
    all-gather of their blocks laid end to end."""
    sizes = mesh_sizes(mesh)
    out, buckets = {}, {}
    for key, t in local.items():
        split = [(d, axes_tuple(ax)) for d, ax in enumerate(specs[key])
                 if math.prod(sizes[a] for a in axes_tuple(ax)) > 1]
        if not split:
            out[key] = t
        elif len(split) > 1:
            out[key] = unshard(t, specs[key], mesh)
        else:
            d, axes = split[0]
            buckets.setdefault((axes, t.dtype), []).append((key, d, t))
    for (axes, _), items in buckets.items():
        group = axis_group(mesh, axes)
        n = dist.get_world_size(group)
        blocks = [t.movedim(d, 0).contiguous() for _, d, t in items]
        full = gather_cat(torch.cat([b.reshape(-1) for b in blocks]),
                          group).reshape(n, -1)
        off = 0
        for (key, d, _), blk in zip(items, blocks):
            part = full[:, off:off + blk.numel()]
            off += blk.numel()
            out[key] = part.reshape((n * blk.shape[0],) +
                                    tuple(blk.shape[1:])).movedim(
                                        0, d).contiguous()
    return out


def _flatten(tree, prefix=()) -> Dict[tuple, Any]:
    """{path: leaf} of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flatten(sub, prefix + (key,)).items()}
    return {prefix: tree}


def _unflatten(flat: Dict[tuple, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def build_mesh(spec: str):
    """The mesh of a comma shape ("2,2", "2,16,16") over the running
    group, named as the reference names it (a "cuda" mesh under NCCL,
    else "cpu": gloo ranks stage card tensors through the host)."""
    from repro_torch.launch.mesh import build_mesh as _build
    return _build(tuple(int(s) for s in spec.split(",")))


def local_rows(mesh, part, global_batch: int) -> slice:
    """This rank's rows of a global batch: split over the largest run of
    the batch axes it divides (every row when it divides none)."""
    from repro_torch.launch.input_specs import _fit
    axes = axes_tuple(_fit(mesh, global_batch, part.batch_spec()))
    rows = global_batch // math.prod(mesh_sizes(mesh)[a] for a in axes)
    i = axis_index(mesh, axes) if axes else 0
    return slice(i * rows, (i + 1) * rows)


# ------------------------------------------------------------ trainer
class MeshTrainer:
    """A train state stored as this rank's shards, stepped whole."""

    def __init__(self, cfg, mesh, opt=None, *, seed: int = 0,
                 device="cuda"):
        from repro_torch.launch.input_specs import (make_partitioner,
                                                    opt_shardings,
                                                    tp_axis_of)
        from repro_torch.train.optimizer import OptConfig
        from repro_torch.train.train_step import (make_train_state,
                                                  make_train_step)
        self.cfg, self.mesh = cfg, mesh
        self.opt = opt or OptConfig(name=cfg.optimizer)
        self.part = make_partitioner(mesh, cfg)
        self.tp_axis = tp_axis_of(cfg)
        state = make_train_state(cfg, self.opt, seed=seed, device=device)
        self.model = state["params"]
        self.specs = self.part.specs(self.model)
        # the optimizer's state and specs by path (("m", name), ("v",
        # name, "vr"), ...), as its tree's leaves
        self.opt_specs = _flatten(opt_shardings(self.specs, state["opt"]))
        self.shapes = {n: tuple(p.shape)
                       for n, p in self.model.named_parameters()}
        self.shapes.update({k: tuple(v.shape)
                            for k, v in _flatten(state["opt"]).items()})
        self.params = self._shards(
            {n: p.detach() for n, p in self.model.named_parameters()},
            self.specs)
        self.opt_state = self._shards(_flatten(state["opt"]),
                                      self.opt_specs)
        self.step_no = 0
        del state
        self._release()
        sizes = mesh_sizes(mesh)
        self.batch_axes = axes_tuple(self.part.batch_spec())
        self.n_batch = math.prod(sizes[a] for a in self.batch_axes)
        self.batch_group = (axis_group(mesh, self.batch_axes)
                            if self.n_batch > 1 else None)
        self.step_fn = make_train_step(cfg, self.opt,
                                       grad_hook=self._average)

    def _shards(self, full, specs):
        return {k: shard(t, specs[k], self.mesh) for k, t in full.items()}

    # the model holds its weights only inside a step
    def _release(self):
        for p in self.model.parameters():
            p.data = p.data.new_empty((0,))

    def _load(self):
        full = unshard_all(self.params, self.specs, self.mesh)
        for n, p in self.model.named_parameters():
            p.data = full[n]

    def _average(self, metrics, grads):
        """The gradients (in float32, as the optimizer reads them) and
        the metrics averaged over the batch ranks, one all-reduce each."""
        if self.batch_group is None:
            return metrics, grads
        flat = reduce_sum(torch.cat([g.float().reshape(-1)
                                     for g in grads.values()]),
                          self.batch_group).div_(self.n_batch)
        parts = flat.split([g.numel() for g in grads.values()])
        grads = {n: part.view(g.shape)
                 for (n, g), part in zip(grads.items(), parts)}
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float().reshape(()) for k in keys])
        vec = reduce_sum(vec, self.batch_group) / self.n_batch
        out = dict(zip(keys, vec.unbind()))
        out["tokens"] = out["tokens"] * self.n_batch      # a sum, not a mean
        return out, grads

    def step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One train step on this rank's ``batch`` (its rows); returns
        the metrics averaged over the batch ranks."""
        self._load()
        opt_full = _unflatten(unshard_all(self.opt_state, self.opt_specs,
                                          self.mesh))
        state = {"params": self.model, "opt": opt_full,
                 "step": torch.tensor(self.step_no, dtype=torch.int32,
                                      device=self.model.device)}
        with activation_mesh(self.mesh, tp_axis=self.tp_axis):
            state, metrics = self.step_fn(state, batch)
        self.params = self._shards(
            {n: p.detach() for n, p in self.model.named_parameters()},
            self.specs)
        self.opt_state = self._shards(_flatten(state["opt"]),
                                      self.opt_specs)
        self.step_no += 1
        self._release()
        return metrics

    # ------------------------------------------------------ checkpoints
    def state_tree(self) -> Dict[str, Any]:
        """The whole state in ``train_step.state_tree``'s layout (every
        rank takes part in the gathers)."""
        return {"params": unshard_all(self.params, self.specs, self.mesh),
                "opt": _unflatten(unshard_all(self.opt_state,
                                              self.opt_specs, self.mesh)),
                "step": torch.tensor(self.step_no, dtype=torch.int32)}

    def save(self, ckpt, step: int) -> None:
        tree = self.state_tree()
        if dist.get_rank() == 0:
            ckpt.save(step, tree)

    def restore(self, ckpt) -> int:
        """Every rank reads the latest checkpoint and keeps its shards."""
        dev = self.model.device

        def whole(key, t):
            return torch.empty(self.shapes[key], dtype=t.dtype, device=dev)

        def taker(spec):
            return lambda leaf: shard(leaf, spec, self.mesh)

        template = {
            "params": {n: whole(n, t) for n, t in self.params.items()},
            "opt": _unflatten({k: whole(k, t)
                               for k, t in self.opt_state.items()}),
            "step": torch.zeros((), dtype=torch.int32)}
        places = {"params": {n: taker(s) for n, s in self.specs.items()},
                  "opt": _unflatten({k: taker(s)
                                     for k, s in self.opt_specs.items()}),
                  "step": lambda leaf: leaf}
        tree = ckpt.restore(template, shardings=places)
        self.params = tree["params"]
        self.opt_state = _flatten(tree["opt"])
        self.step_no = int(tree["step"])
        return self.step_no


# ------------------------------------------------------------ driver
def train(cfg, *, steps: int, batch: int, seq: int, mesh_shape: str,
          ckpt_every: int, ckpt_dir: Optional[str] = None,
          device="cuda", seed: int = 0, opt=None,
          log: Callable[[str], None] = print,
          on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
          batches: Optional[Sequence[Dict[str, Any]]] = None
          ) -> List[Dict[str, float]]:
    """Train ``cfg`` on the running group's mesh of ``mesh_shape`` for
    ``steps`` steps (resuming from ``ckpt_dir``'s latest checkpoint, if
    any), drawing each global batch as the reference does (or taking
    step ``i``'s from ``batches[i]``: ``tokens`` and ``targets``); rank
    0 logs. Returns each step's metrics as floats."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.train.optimizer import OptConfig
    opt = opt or OptConfig(name=cfg.optimizer, lr_peak=3e-3,
                           warmup_steps=10, decay_steps=steps)
    dev = torch.device(device)
    mesh = build_mesh(mesh_shape)
    rank0 = dist.get_rank() == 0
    say = log if rank0 else (lambda s: None)
    trainer = MeshTrainer(cfg, mesh, opt, seed=seed, device=dev)
    ckpt = Checkpointer(ckpt_dir or tempfile.mkdtemp(
        prefix=f"mesh_{cfg.name}_"))
    if ckpt_dir and ckpt.latest_step() is not None:
        say(f"resumed from step {trainer.restore(ckpt)}")
    rows = local_rows(mesh, trainer.part, batch)
    rng = np.random.default_rng(0)
    out: List[Dict[str, float]] = []
    t0 = time.time()
    for i in range(trainer.step_no, steps):
        if batches is None:
            toks = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1),
                                dtype=np.int32)[rows]
            b = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "targets": torch.as_tensor(toks[:, 1:], device=dev)}
        else:
            b = {k: torch.as_tensor(v, device=dev)[rows]
                 for k, v in batches[i].items()}
        m = {k: float(v) for k, v in trainer.step(b).items()}
        out.append(m)
        if on_step is not None:
            on_step(i + 1, m)
        if (i + 1) % ckpt_every == 0:
            trainer.save(ckpt, i + 1)
        if (i + 1) % 10 == 0 or i == 0:
            say(f"step {i+1:4d} loss={m['loss']:.4f} "
                f"gnorm={m['grad_norm']:.3f} ({(time.time()-t0):.1f}s)")
            t0 = time.time()
    ckpt.wait()
    dist.barrier()
    say(f"done; devices={dist.get_world_size()} checkpoints in {ckpt.dir}")
    return out


def _rank_train(rank: int, args: Dict[str, Any]) -> None:
    from repro_torch.configs import get_config
    cfg = get_config(args["arch"])
    if args["reduced"]:
        cfg = cfg.reduced()

    def log(s):
        print(s, flush=True)

    train(cfg, steps=args["steps"], batch=args["batch"], seq=args["seq"],
          mesh_shape=args["mesh"], ckpt_every=args["ckpt_every"],
          ckpt_dir=args["ckpt_dir"], device=args["device"], log=log)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mesh", default="1,1",
                    help="comma mesh shape, e.g. 2,2 or 2,16,16")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL when every rank has a card) or cpu")
    args = ap.parse_args(argv)
    nprocs = math.prod(int(s) for s in args.mesh.split(","))
    job = {k: getattr(args, k) for k in
           ("arch", "reduced", "steps", "batch", "seq", "mesh", "ckpt_every",
            "ckpt_dir", "device")}
    if dist.is_initialized():
        _rank_train(dist.get_rank(), job)
    else:
        from repro_torch.launch.mesh import spawn_local
        from repro_torch.launch.train import _rank_train as fn
        spawn_local(fn, nprocs, (job,), device=args.device,
                    build_kernels=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
