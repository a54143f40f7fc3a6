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
  specs (``shard``); the model itself holds no weights. A step runs
  ``train/train_step.py::make_train_step`` on the rank's slice of the
  batch with ``sharding.activations.param_gather`` installed: each block
  of the layer loops (and the embedding, final norm and head around
  their use) gathers its parameters whole from the shards (``_Whole``:
  bucketed all-gathers), and in the backward its gradients are summed
  over the batch ranks, averaged and cut to this rank's shards
  (a reduce-scatter where a leaf splits over the batch axes alone, else
  an all-reduce and a ``narrow``), so no leaf is whole outside its
  block. Under remat the gather sits inside the rematerialized step and
  runs again in the backward. The optimizer updates the shards
  (``optimizer.apply_updates``' ``shards``), and only the metrics are
  averaged after the backward (its ``grad_hook``). Inside the step the
  "2d" archs split heads and ``d_ff`` over "model" where the specs shard
  them (``sharding.activations``), and the MoE layers go through
  ``models/moe_sharded.py``, whose expert-parallel path takes the
  rank's own experts: an expert stack split over the batch axes stays
  local (only its other split dims are gathered, and its gradient needs
  no sum). A leaf whose rule falls back is only stored split;
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
import contextlib
import math
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding.activations import (activation_mesh, axis_group,
                                              axis_index, gather_cat,
                                              param_gather, reduce_scatter,
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
# the MoE expert stacks (reference leaf's last two keys), which
# moe_sharded.py's expert-parallel path uses as the rank's own experts
_EXPERT_LEAVES = {("moe", "wi_gate"), ("moe", "wi_up"), ("moe", "wo")}

# which route each backward's gradient sums took ("reduce_scatter",
# "all_reduce": an all-reduce then a narrow), counted per executed call
SCATTER_ROUTES: Dict[str, int] = {}


def _cat(parts, dim: int) -> torch.Tensor:
    """``torch.cat``, with no copy of a single part."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


class _Whole(torch.autograd.Function):
    """Parameters ``names`` whole from this rank's ``shards``; the
    backward returns their gradients summed over the batch ranks,
    averaged and cut to the shards (``MeshTrainer._scatter``)."""
    gathers_parameters = True       # a weight operand (models/model.py)

    @staticmethod
    def forward(ctx, trainer, names, *shards):
        ctx.trainer, ctx.names = trainer, names
        full = unshard_all(dict(zip(names, shards)),
                           {n: trainer.gather_specs[n] for n in names},
                           trainer.mesh)
        return tuple(full[n] for n in names)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + ctx.trainer._scatter(ctx.names, grads)


class MeshTrainer:
    """A train state stored as this rank's shards; a step gathers each
    block whole around its use and updates the shards."""

    def __init__(self, cfg, mesh, opt=None, *, seed: int = 0,
                 device="cuda"):
        from repro_torch.launch.input_specs import (make_partitioner,
                                                    opt_shardings,
                                                    tp_axis_of)
        from repro_torch.models.model import reference_leaf_path
        from repro_torch.train.optimizer import OptConfig
        from repro_torch.train.train_step import (make_train_state,
                                                  make_train_step)
        self.cfg, self.mesh = cfg, mesh
        self.opt = opt or OptConfig(name=cfg.optimizer)
        self.part = make_partitioner(mesh, cfg)
        self.tp_axis = tp_axis_of(cfg)
        sizes = mesh_sizes(mesh)
        self.batch_axes = axes_tuple(self.part.batch_spec())
        self.n_batch = math.prod(sizes[a] for a in self.batch_axes)
        self.batch_group = (axis_group(mesh, self.batch_axes)
                            if self.n_batch > 1 else None)
        self.world = math.prod(sizes.values())
        self.world_group = (axis_group(mesh, tuple(sizes))
                            if self.world > 1 else None)
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
        # a leaf is gathered over its split dims but an expert stack's
        # batch-axes split; its gradient is summed over the batch axes
        # it is not kept local on
        self.gather_specs, self.reduce_axes = {}, {}
        for n, spec in self.specs.items():
            keys, _ = reference_leaf_path(cfg, n)
            local = (tuple(k for k in keys if isinstance(k, str))[-2:]
                     in _EXPERT_LEAVES
                     and axes_tuple(spec[0]) == self.batch_axes)
            self.gather_specs[n] = (None,) + tuple(spec[1:]) if local \
                else tuple(spec)
            self.reduce_axes[n] = () if local else self.batch_axes
        with torch.no_grad():
            self.params = self._shards(
                {n: p.detach() for n, p in self.model.named_parameters()},
                self.specs)
            self.opt_state = self._shards(_flatten(state["opt"]),
                                          self.opt_specs)
        for t in self.params.values():
            t.requires_grad_(True)
        self.step_no = 0
        del state
        for p in self.model.parameters():
            p.data = p.data.new_empty((0,))
        # "qualified name." of every module, for _whole
        self._prefix = {id(m): (f"{name}." if name else "")
                        for name, m in self.model.named_modules()}
        self.scatter_route = self._probe_reduce_scatter()
        self.step_fn = make_train_step(cfg, self.opt,
                                       grad_hook=self._average, shards=self)

    def _shards(self, full, specs):
        return {k: shard(t, specs[k], self.mesh) for k, t in full.items()}

    def _probe_reduce_scatter(self) -> str:
        """"reduce_scatter" when the batch group's backend has it, else
        "all_reduce" (an all-reduce then a ``narrow``: the same sums)."""
        if self.batch_group is None:
            return "all_reduce"
        try:
            reduce_scatter(torch.zeros((self.n_batch, 1),
                                       device=self.model.device),
                           self.batch_group)
        except (RuntimeError, NotImplementedError):
            return "all_reduce"
        return "reduce_scatter"

    # ------------------------------------------------ the per-block gather
    @contextlib.contextmanager
    def _whole(self, *items):
        """``sharding.activations.param_gather``'s function: the
        parameters of ``items`` (modules, or (module, name) pairs) whole
        inside, as ``_Whole``'s outputs, and empty again after."""
        slots = []
        for it in items:
            if isinstance(it, tuple):
                mod, attr = it
                if mod._parameters.get(attr) is not None:
                    slots.append((mod, attr, self._prefix[id(mod)] + attr))
                continue
            for sub in it.modules():
                for attr, p in sub._parameters.items():
                    if p is not None:
                        slots.append((sub, attr, self._prefix[id(sub)] + attr))
        names = tuple(q for _, _, q in slots)
        fulls = _Whole.apply(self, names, *(self.params[n] for n in names))
        kept = [m._parameters[a] for m, a, _ in slots]
        for (m, a, _), t in zip(slots, fulls):
            m._parameters[a] = t
        try:
            yield
        finally:
            for (m, a, _), p in zip(slots, kept):
                m._parameters[a] = p

    def _scatter(self, names, grads) -> tuple:
        """Each gradient (of a gathered leaf, whole) in float32, summed
        over its reduce axes (one reduce-scatter of the leaves split over
        the batch axes alone, one all-reduce of the rest), cut to this
        rank's shard, divided by the batch ranks and cast to the shard's
        dtype, each a tensor of its own."""
        sizes = mesh_sizes(self.mesh)
        out: Dict[str, torch.Tensor] = {}
        scatter, summed = [], []
        for n, g in zip(names, grads):
            g = g.float()
            axes = self.reduce_axes[n]
            split = [(d, axes_tuple(a)) for d, a in
                     enumerate(self.gather_specs[n])
                     if math.prod(sizes[x] for x in axes_tuple(a)) > 1]
            if self.batch_group is None or not axes:
                out[n] = shard(g, self.gather_specs[n], self.mesh)
            elif self.scatter_route == "reduce_scatter" and \
                    [a for _, a in split] == [axes]:
                scatter.append((n, split[0][0], g))
            else:
                summed.append((n, g))
        if scatter:
            blocks = [g.movedim(d, 0) for _, d, g in scatter]
            flat = _cat([b.reshape(self.n_batch, -1) for b in blocks], 1)
            part = reduce_scatter(flat, self.batch_group)
            SCATTER_ROUTES["reduce_scatter"] = \
                SCATTER_ROUTES.get("reduce_scatter", 0) + 1
            off = 0
            for (n, d, _), b in zip(scatter, blocks):
                size = b.numel() // self.n_batch
                out[n] = part[off:off + size].view(
                    (b.shape[0] // self.n_batch,) + tuple(b.shape[1:])
                ).movedim(0, d).contiguous()
                off += size
        if summed:
            flat = reduce_sum(_cat([g.reshape(-1) for _, g in summed], 0),
                              self.batch_group)
            SCATTER_ROUTES["all_reduce"] = \
                SCATTER_ROUTES.get("all_reduce", 0) + 1
            for (n, g), part in zip(summed, flat.split(
                    [g.numel() for _, g in summed])):
                out[n] = shard(part.view(g.shape), self.gather_specs[n],
                               self.mesh)
        # fresh tensors: a view would keep the whole bucket (or the
        # engine's gradient) alive until the update
        return tuple((out[n] / self.n_batch if self.n_batch > 1
                      else out[n].clone()).to(self.params[n].dtype)
                     for n in names)

    # ------------------------------------------ what the optimizer reads
    def shape(self, name: str) -> Tuple[int, ...]:
        return self.shapes[name]

    def split(self, name: str, dim: int) -> bool:
        spec = self.specs[name]
        axes = axes_tuple(spec[dim % len(spec)])
        return math.prod(mesh_sizes(self.mesh)[a] for a in axes) > 1

    def sum(self, name: str, dim: int, t: torch.Tensor) -> torch.Tensor:
        spec = self.specs[name]
        return reduce_sum(t, axis_group(self.mesh, spec[dim % len(spec)]))

    def replicas(self, name: str) -> int:
        sizes = mesh_sizes(self.mesh)
        return self.world // math.prod(sizes[a] for ax in self.specs[name]
                                       for a in axes_tuple(ax))

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.world_group is None else \
            reduce_sum(t, self.world_group)

    def _average(self, metrics, grads):
        """The metrics averaged over the batch ranks, one all-reduce (the
        gradients were averaged in the backward)."""
        if self.batch_group is None:
            return metrics, grads
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].float().reshape(()) for k in keys])
        vec = reduce_sum(vec, self.batch_group) / self.n_batch
        out = dict(zip(keys, vec.unbind()))
        out["tokens"] = out["tokens"] * self.n_batch      # a sum, not a mean
        return out, grads

    def step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One train step on this rank's ``batch`` (its rows); returns
        the metrics averaged over the batch ranks. The shards and the
        moments are updated in place."""
        state = {"params": self.model, "opt": _unflatten(self.opt_state),
                 "step": torch.tensor(self.step_no, dtype=torch.int32,
                                      device=self.model.device)}
        with activation_mesh(self.mesh, tp_axis=self.tp_axis), \
                param_gather(self._whole):
            _, metrics = self.step_fn(state, batch)
        self.step_no += 1
        return metrics

    # ------------------------------------------------------ checkpoints
    @torch.no_grad()
    def state_tree(self) -> Dict[str, Any]:
        """The whole state in ``train_step.state_tree``'s layout (every
        rank takes part in the gathers; a save, not a step)."""
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
        self.params = {n: t.requires_grad_(True)
                       for n, t in tree["params"].items()}
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
