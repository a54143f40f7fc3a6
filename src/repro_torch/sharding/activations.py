"""The activation mesh: what the model code reads when it runs on a mesh.

The port of ``repro.sharding.activations``. The reference installs a mesh
so that XLA's sharding propagation keeps activations split
(``shard_bsd``, ``shard_logits``, ``shard_moe_grouped`` are
``with_sharding_constraint`` anchors). The port runs eagerly on local
tensors: each rank holds its own slice of the batch over the FSDP axes,
so the (B, S, d) residual stream and the (B, S, V) logits are already
split by batch and those two anchors have no counterpart (the model
code does not call them); ``shard_moe_grouped`` is the identity for the
same reason, since ``models/moe_sharded.py`` groups its own tokens. With
no mesh installed every function here is the identity and no collective
runs, so a single-card path keeps its bits.

What the port adds is the tensor-parallel split that XLA derived from the
specs: under the "2d" policy with a "model" axis of n > 1 ranks,
``tp_attention`` gives a self-attention block's weights as this rank's
heads and ``tp_mlp`` a gated MLP's as its ``d_ff`` columns, each a slice
of the full weight (``take``); the block's input enters through
``to_model`` and its partial output leaves through ``from_model``, one
all-reduce after ``out_project`` and one after the MLP's ``wo``. The
split is taken wherever the ``Partitioner`` shards the dim (heads,
``d_ff``); where it does not, the block runs whole on every model rank.
When the query heads split but the KV heads do not (GQA with fewer KV
heads than model ranks), each rank takes the one KV head its query
heads read.

Gradients follow one convention, which ``launch/train.py`` completes:
activations and parameters outside a split region are replicated over
"model" and their gradients are equal on every model rank; a rank's
gradient sums over its own batch slice, and the driver averages them
over the batch axes (in each block's backward, into its shards). The
autograd collectives below are written to it:
``to_model`` (identity, all-reduce of the gradient over "model"),
``from_model`` (all-reduce, identity), ``gather_model`` (all-gather,
the rank's own slice of the gradient), ``pmean`` (a mean over the batch
axes or over "model"), ``all_to_all`` (its reverse in the backward) and
``take`` (a slice, the gradient padded to the full shape and summed over
"model").

The parameters themselves are stored split (``launch/train.py``): the
model code asks for a block's weights whole through ``whole(...)``
around each block of its layer loops (and around the embedding, the
final norm and the head), and the driver installs what that does with
``param_gather``. With nothing installed ``whole`` does nothing.
"""
from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.partition import mesh_sizes

_CTX: dict = {"mesh": None, "fsdp": None, "tp": None, "whole": None}


@contextlib.contextmanager
def activation_mesh(mesh, tp_axis: str = "model"):
    """Install a ``DeviceMesh`` so model code runs on it. Pass
    ``tp_axis="__none__"`` for the pure-FSDP policy (batch over all
    axes)."""
    prev = dict(_CTX)
    names = tuple(mesh.mesh_dim_names)
    fsdp = tuple(a for a in names if a != tp_axis)
    _CTX.update(mesh=mesh, fsdp=fsdp if len(fsdp) > 1 else fsdp[0],
                tp=tp_axis if tp_axis in names else None)
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(prev)


@contextlib.contextmanager
def param_gather(fn):
    """Install ``fn(*items)``, a context manager in which the parameters
    of ``items`` (modules, or (module, parameter name) pairs) are whole;
    ``whole`` calls it."""
    prev = _CTX["whole"]
    _CTX["whole"] = fn
    try:
        yield
    finally:
        _CTX["whole"] = prev


def whole(*items):
    """A context in which the parameters of ``items`` are whole: the
    installed ``param_gather`` function's, else a no-op."""
    fn = _CTX["whole"]
    return contextlib.nullcontext() if fn is None else fn(*items)


def _names(axes) -> Tuple[str, ...]:
    if not axes:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _size(mesh, axes) -> int:
    shape = mesh_sizes(mesh)
    return math.prod(shape[a] for a in _names(axes))


def _fit(mesh, dim, axes):
    """Cascading fit: the largest contiguous sub-tuple of the axes whose
    size divides ``dim`` (multi-pod batch 256 takes ("data", "model")
    after "pod" is dropped; decode batch 128 takes ("pod", "data"))."""
    if not axes:
        return None
    names = _names(axes)
    shape = mesh_sizes(mesh)
    cands = []
    for i in range(len(names)):
        for j in range(i + 1, len(names) + 1):
            sub = names[i:j]
            cands.append((math.prod(shape[a] for a in sub), sub))
    for size, sub in sorted(cands, key=lambda t: -t[0]):
        if dim % size == 0:
            return sub if len(sub) > 1 else sub[0]
    return None


def shard_moe_grouped(x: torch.Tensor) -> torch.Tensor:
    """The identity: the (E, C, d) grouped buffer is already local
    (``models/moe_sharded.py`` ships the groups to their experts)."""
    return x


def current_mesh():
    """(mesh, fsdp_axes_tuple, tp_axis) or (None, None, None)."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return None, None, None
    return mesh, _names(_CTX["fsdp"]), _CTX["tp"]


# ------------------------------------------------------------ groups
def axis_group(mesh, axes):
    """The process group over ``axes`` of ``mesh`` (a tuple is flattened,
    its first axis the major one), kept on the mesh once made; made
    outside any fake tensor mode, since the mesh's own bookkeeping runs
    tensor ops."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    names = _names(axes)
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if names not in groups:
        with unset_fake_temporarily():
            if len(names) == 1:
                groups[names] = mesh.get_group(names[0])
            else:
                groups[names] = mesh[names]._flatten(
                    "_".join(names)).get_group()
    return groups[names]


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along ``axes`` (row-major over a tuple)."""
    idx = 0
    shape = mesh_sizes(mesh)
    for a in _names(axes):
        idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def _model():
    """(group, size, index) of the "model" axis when it splits, else
    None."""
    mesh, tp = _CTX["mesh"], _CTX["tp"]
    if mesh is None or tp is None or _size(mesh, tp) == 1:
        return None
    return axis_group(mesh, tp), _size(mesh, tp), axis_index(mesh, tp)


# --------------------------------------------------------- collectives
# gloo moves host memory: a CUDA tensor under gloo is staged through the
# host (as core/comm.py stages its gathers); NCCL moves it on the card
def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks (a new tensor)."""
    if _staged(x, group):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    if _staged(src, group):
        src = src.cpu()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(x.device).movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Row ``i`` of the sum over ``group``'s ranks of ``x`` (n, L), on
    rank ``i`` of the group."""
    src = x.contiguous()
    if _staged(src, group):
        src = src.cpu()
    out = src.new_empty(src.shape[1:])
    dist.reduce_scatter_tensor(out, src.reshape(-1), group=group)
    return out.to(x.device)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single``: equal splits of ``x`` along dim 0, split
    ``i`` to rank ``i``."""
    src = x.contiguous()
    if _staged(src, group):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]
        return gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group), None


class _Mean(torch.autograd.Function):
    """The mean over ``group``; ``replicated``: the output's downstream
    is equal on every rank of the group ("model"), so each rank's
    gradient is its own share, else (the batch axes) the ranks' gradients
    are averaged as the mean's transpose."""

    @staticmethod
    def forward(ctx, x, group, replicated):
        ctx.group, ctx.replicated = group, replicated
        ctx.n = dist.get_world_size(group)
        return reduce_sum(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return g / ctx.n, None, None
        return reduce_sum(g, ctx.group) / ctx.n, None, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, full, dim, start, length, group):
        ctx.shape, ctx.dim, ctx.start, ctx.group = full.shape, dim, start, \
            group
        return full.narrow(dim, start, length)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return reduce_sum(full, ctx.group), None, None, None, None


def to_model(x, group):
    return _ToModel.apply(x, group)


def from_model(x, group):
    return _FromModel.apply(x, group)


def gather_model(x, group, index: int, dim: int = 0):
    return _GatherModel.apply(x, group, index, dim)


def all_to_all(x, group):
    """Equal splits of ``x`` along dim 0, split ``i`` to rank ``i``."""
    return _AllToAll.apply(x, group)


def pmean(x, group, replicated: bool = False):
    return _Mean.apply(x, group, replicated)


def take(full, dim: int, start: int, length: int, group):
    return _Take.apply(full, dim, start, length, group)


# ----------------------------------------------------- tensor parallel
def tp_attention(p, cfg) -> Optional[SimpleNamespace]:
    """This model rank's heads of self-attention block ``p`` (an
    ``Attention``) as a stand-in with its attributes, or None when the
    heads do not split (no mesh, no "model" axis, or indivisible
    heads)."""
    tp = _model()
    if tp is None:
        return None
    group, n, r = tp
    h, kv = p.wq.shape[1], p.wk.shape[1]
    if h % n:
        return None
    hl = h // n
    if kv % n == 0:
        k0, kl = r * (kv // n), kv // n
    elif (h // kv) % hl == 0:
        k0, kl = (r * hl) // (h // kv), 1
    else:
        return None
    out = SimpleNamespace(
        wq=take(p.wq, 1, r * hl, hl, group),
        wk=take(p.wk, 1, k0, kl, group), wv=take(p.wv, 1, k0, kl, group),
        wo=take(p.wo, 0, r * hl, hl, group), has_bias=p.has_bias,
        group=group)
    if p.has_bias:
        out.bq = take(p.bq, 0, r * hl, hl, group)
        out.bk = take(p.bk, 0, k0, kl, group)
        out.bv = take(p.bv, 0, k0, kl, group)
    return out


def tp_mlp(p) -> Optional[SimpleNamespace]:
    """This model rank's ``d_ff`` columns of gated MLP ``p``, or None
    when they do not split."""
    tp = _model()
    if tp is None:
        return None
    group, n, r = tp
    ff = p.wi_gate.shape[1]
    if ff % n:
        return None
    fl = ff // n
    return SimpleNamespace(
        wi_gate=take(p.wi_gate, 1, r * fl, fl, group),
        wi_up=take(p.wi_up, 1, r * fl, fl, group),
        wo=take(p.wo, 0, r * fl, fl, group), group=group)
