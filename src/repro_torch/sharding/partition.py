"""Parameter partitioning rules (DP / FSDP / TP / EP).

The port of ``repro.sharding.partition``. Mesh contract
(``launch/mesh.py``): axes ("data", "model") on one pod or ("pod",
"data", "model") on two. The batch shards over every axis but "model";
"model" carries tensor parallelism.

Rules are keyed on the reference's (parent, leaf) names with a base rank,
so the stacked layer axes of the reference's leaves stay unsharded. The
port's parameters are one layer each (``blocks.7.attn.wq``); ``specs``
finds each one's reference leaf by ``models.model.reference_leaf_path``
and applies the rule to the parameter's own trailing dims, so a port
parameter's spec is its reference leaf's spec less the leading stack
axes. Every rule keeps the reference's divisibility fallbacks: the
preferred parallel dim (heads, ff, experts, vocab) shards over "model"
when divisible, else stays unsharded there, and experts that do not
divide the FSDP axes move the FSDP split to the first free dim.

A spec is a tuple with one entry a dim: None, an axis name or a tuple of
axis names (split over their product, the first the major one), as a
``jax.sharding.PartitionSpec`` holds them. ``placements`` gives the same
layout as ``torch.distributed.tensor`` placements over a ``DeviceMesh``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple, Union

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# (parent, leaf) -> rule; tokens: 'F' fsdp, 'T' tp, 'T2'/'T2b' heads -> tp,
# 'E2' experts over the fsdp axes (else FSDP on the first free dim), '.'
# none
_RULES = {
    ("embed", "embedding"):  "T F",
    ("head", "w"):           "F T",
    ("attn", "wq"):          "F T2 .",     # (d, H, hd): heads->tp
    ("attn", "wk"):          "F T2 .",
    ("attn", "wv"):          "F T2 .",
    ("attn", "wo"):          "T2 . F",     # (H, hd, d)
    ("attn", "bq"):          "T2b .",
    ("attn", "bk"):          "T2b .",
    ("attn", "bv"):          "T2b .",
    ("mlp", "wi_gate"):      "F T",
    ("mlp", "wi_up"):        "F T",
    ("mlp", "wo"):           "T F",
    ("moe", "router"):       ". .",
    ("moe", "wi_gate"):      "E2 . T",     # (E, d, ff): EP else FSDP on d
    ("moe", "wi_up"):        "E2 . T",
    ("moe", "wo"):           "E2 T .",     # (E, ff, d): EP else FSDP on d
    ("shared", "wi_gate"):   "F T",
    ("shared", "wi_up"):     "F T",
    ("shared", "wo"):        "T F",
    ("m", "in_proj"):        "F T",
    ("m", "out_proj"):       "T F",
    ("m", "conv_w"):         ". .",
    ("mlstm", "up"):         "F T",
    ("mlstm", "wq"):         "F T",
    ("mlstm", "wk"):         "F T",
    ("mlstm", "wv"):         "F T",
    ("mlstm", "down"):       "T F",
    ("mlstm", "conv_w"):     ". .",
    ("mlstm", "w_i"):        "F .",
    ("mlstm", "w_f"):        "F .",
    ("slstm", "w"):          "F . T2 .",   # (d, 4, H, hd)
    ("slstm", "r"):          "T2 . . .",   # (H, hd, 4, hd)
    ("slstm", "b"):          ". . .",
    ("slstm", "ffn_gate"):   "F T",
    ("slstm", "ffn_up"):     "F T",
    ("slstm", "ffn_down"):   "T F",
}


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with
    ``axis_names`` and ``devices.shape``, as the reference's tests'
    stand-in mesh has)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {a: int(s) for a, s in zip(names, tuple(mesh.shape))}
    return {a: int(s) for a, s in zip(mesh.axis_names, mesh.devices.shape)}


def axes_tuple(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_size(sizes: Dict[str, int], axes) -> int:
    return math.prod(sizes[a] for a in axes_tuple(axes))


class Partitioner:
    """Builds the spec of every parameter given the mesh layout."""

    def __init__(self, mesh, fsdp_axes=None, tp_axis: str = "model"):
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        names = tuple(self.sizes)
        if fsdp_axes is None:
            fsdp_axes = tuple(a for a in names if a != tp_axis)
        self.fsdp = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
        self.tp = tp_axis if tp_axis in names else None

    def _fit(self, dim: int, axes):
        if axes is None:
            return None
        return axes if dim % axes_size(self.sizes, axes) == 0 else None

    def batch_spec(self):
        return self.fsdp

    def _apply_rule(self, rule: str, shape: Tuple[int, ...]) -> Spec:
        toks = rule.split()
        assert len(toks) == len(shape), (rule, shape)
        out = [None] * len(shape)
        for i, tok in enumerate(toks):
            if tok == ".":
                continue  # never overwrites an E2 fallback assignment
            if tok == "F":
                out[i] = self._fit(shape[i], self.fsdp)
            elif tok == "E2":
                e_ax = self._fit(shape[i], self.fsdp)
                out[i] = e_ax
                if e_ax is None:
                    for j, t2 in enumerate(toks):
                        if t2 == "." and self._fit(shape[j],
                                                   self.fsdp) is not None:
                            out[j] = self._fit(shape[j], self.fsdp)
                            break
            elif tok == "T":
                out[i] = self._fit(shape[i], self.tp)
            elif tok in ("T2", "T2b"):
                # heads -> tp when divisible; no head_dim fallback (it
                # would put every attention product's contraction on
                # "model"), so indivisible heads are stored FSDP-only
                out[i] = self._fit(shape[i], self.tp)
            else:
                raise ValueError(tok)
        return tuple(out)

    def spec_for(self, cfg, name: str, shape: Tuple[int, ...]) -> Spec:
        """The spec of port parameter ``name`` of ``shape``."""
        from repro_torch.models.model import reference_leaf_path
        keys, _ = reference_leaf_path(cfg, name)
        keys = [k for k in keys if isinstance(k, str)]
        leaf = keys[-1] if keys else ""
        parent = keys[-2] if len(keys) >= 2 else ""
        rule = _RULES.get((parent, leaf))
        if rule is None:
            return (None,) * len(shape)     # norms / scalars: replicate
        base_rank = len(rule.split())
        extra = len(shape) - base_rank
        assert extra >= 0, (name, shape, rule)
        return (None,) * extra + self._apply_rule(rule,
                                                  tuple(shape[extra:]))

    def specs(self, model_or_shapes, cfg=None) -> Dict[str, Spec]:
        """{name: spec} for an ``LM`` or for (name, shape) pairs (then
        ``cfg`` is needed)."""
        if cfg is None:
            cfg = model_or_shapes.cfg
            pairs = ((n, tuple(p.shape))
                     for n, p in model_or_shapes.named_parameters())
        else:
            pairs = model_or_shapes
        return {n: self.spec_for(cfg, n, tuple(s)) for n, s in pairs}

    def placements(self, spec: Spec):
        return placements(self.mesh, spec)


def placements(mesh, spec: Spec):
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(i)``
    on each mesh dim that splits tensor dim ``i``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    out = [Replicate()] * len(names)
    for i, axes in enumerate(spec):
        for a in axes_tuple(axes):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def local_shape(shape: Iterable[int], spec: Spec,
                sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape one device holds of a tensor of ``shape`` under
    ``spec``."""
    shape = tuple(shape)
    return tuple(d // axes_size(sizes, ax) if ax is not None else d
                 for d, ax in zip(shape, tuple(spec) + (None,) *
                                  (len(shape) - len(spec))))


def shard_bytes(shape: Iterable[int], itemsize: int, spec: Spec,
                sizes: Dict[str, int]) -> int:
    """Bytes one device holds of a tensor under ``spec``."""
    return math.prod(local_shape(shape, spec, sizes)) * int(itemsize)
