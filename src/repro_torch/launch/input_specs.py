"""Shape stand-ins and specs for every (arch × shape) cell.

The port of ``repro.launch.input_specs``. Nothing here allocates:
parameters, optimizer state and caches are built under
``FakeTensorMode`` (``param_structs``, ``cache_structs``), the batch as
meta tensors (``batch_structs``); a struct is a tensor that has a shape
and a dtype and no storage. A sharding is a spec tuple, one entry a dim
(None, an axis name or a tuple of names), as the ``Partitioner`` gives
it; ``partition.placements`` turns one into ``DTensor`` placements.
``[audio]`` and ``[vlm]`` cells get stub-frontend embeddings.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.sharding.activations import _fit
from repro_torch.sharding.partition import Partitioner, Spec, mesh_sizes


def make_partitioner(mesh, cfg) -> Partitioner:
    """Per-arch policy: "2d" = FSDP × TP; "fsdp" = batch and storage over
    ALL axes, no tensor parallelism (qwen2's 12 heads, whisper's 51,865
    vocab, xlstm's 4 heads)."""
    if cfg.sharding_policy == "fsdp":
        return Partitioner(mesh, fsdp_axes=tuple(mesh_sizes(mesh)),
                           tp_axis="__none__")
    return Partitioner(mesh)


def tp_axis_of(cfg) -> str:
    """The ``activation_mesh`` tp axis of the arch's policy."""
    return "__none__" if cfg.sharding_policy == "fsdp" else "model"


# ----------------------------------------------------------- structs
def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def param_structs(cfg) -> Dict[str, torch.Tensor]:
    """{name: fake tensor} of the arch's parameters."""
    from repro_torch.models.model import init_lm
    with _fake():
        model = init_lm(cfg, device="cpu")
    return {n: p for n, p in model.named_parameters()}


def cache_structs(cfg, batch: int, max_len: int):
    """The cache tree of ``init_cache`` as fake tensors."""
    from repro_torch.models.model import init_cache
    with _fake():
        return init_cache(cfg, batch, max_len, device="cpu")


def batch_structs(cfg, shape) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len

    def st(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["tokens"] = st((b, s), torch.int32)
        out["targets"] = st((b, s), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = st((b, s), torch.int32)
    else:   # decode: one new token against a seq_len cache
        out["tokens"] = st((b, 1), torch.int32)
    if cfg.n_frontend_tokens:
        from repro_torch.models.layers import torch_dtype
        out["frontend"] = st((b, cfg.n_frontend_tokens, cfg.d_model),
                             torch_dtype(cfg.compute_dtype))
    return out


# ----------------------------------------------------------- specs
def batch_shardings(mesh, part: Partitioner,
                    structs: Dict[str, Any]) -> Dict[str, Spec]:
    bspec = part.batch_spec()
    return {k: (_fit(mesh, st.shape[0], bspec),) + (None,) * (st.ndim - 1)
            for k, st in structs.items()}


_TRAILING = {"k": 3, "v": 3, "ssd": 3, "conv": 2, "c": 3, "n": 2, "m": 1,
             "h": 2, "t": 0}


def _cache_leaf(mesh, bspec, tp, name: str, st) -> Spec:
    nd = st.ndim
    trail = _TRAILING.get(name)
    if trail is None or nd < trail + (0 if name == "t" else 1):
        return (None,) * nd
    if name == "t":
        return (None,)
    bdim = nd - trail - 1
    spec = [None] * nd
    spec[bdim] = _fit(mesh, st.shape[bdim], bspec)
    if name in ("k", "v"):           # (..., B, W, KV, hd)
        kv_ax = _fit(mesh, st.shape[nd - 2], tp)
        spec[nd - 2] = kv_ax
        if kv_ax is None:
            spec[nd - 1] = _fit(mesh, st.shape[nd - 1], tp)
    elif name == "ssd":              # (..., B, H, P, N)
        spec[nd - 3] = _fit(mesh, st.shape[nd - 3], tp)
    elif name == "conv":             # (..., B, w, C)
        spec[nd - 1] = _fit(mesh, st.shape[nd - 1], tp)
    elif name == "c" and nd >= 3:    # mlstm (..., B, H, hd, hd)
        h_ax = _fit(mesh, st.shape[nd - 3], tp)
        spec[nd - 3] = h_ax
        if h_ax is None:
            spec[nd - 1] = _fit(mesh, st.shape[nd - 1], tp)
    elif name in ("n", "h"):         # (..., B, H, hd)
        h_ax = _fit(mesh, st.shape[nd - 2], tp)
        spec[nd - 2] = h_ax
        if h_ax is None:
            spec[nd - 1] = _fit(mesh, st.shape[nd - 1], tp)
    elif name == "m":                # (..., B, H)
        spec[nd - 1] = _fit(mesh, st.shape[nd - 1], tp)
    return tuple(spec)


def cache_shardings(mesh, part: Partitioner, cache_st) -> Any:
    """Batch dim -> fsdp axes; heads/head_dim -> "model" when divisible.
    The tree of ``cache_st`` (dicts and xLSTM's list) with a spec a
    leaf, named by its last dict key."""
    bspec, tp = part.batch_spec(), part.tp

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return _cache_leaf(mesh, bspec, tp, name, node)

    return walk(cache_st, "")


def opt_shardings(param_specs: Dict[str, Spec], opt_state) -> Dict:
    """Optimizer-state specs, the tree of ``opt_state``, mirroring the
    parameter specs: AdamW's ``m`` / ``v`` share the parameter's;
    Adafactor's ``vr`` drops the last dim's entry and ``vc`` the
    second-to-last where ``train/optimizer.py`` factors the leaf (its
    state holds ``vr``), else its dense ``v`` shares the parameter's."""
    if "m" in opt_state:
        return {"m": dict(param_specs), "v": dict(param_specs)}
    out = {}
    for name, spec in param_specs.items():
        parts = tuple(spec)
        if "vr" in opt_state["v"][name]:
            out[name] = {"vr": parts[:-1], "vc": parts[:-2] + parts[-1:]}
        else:
            out[name] = {"v": parts}
    return {"v": out}


def opt_structs(cfg, opt=None):
    """(params {name: fake tensor}, the optimizer's state of fakes)."""
    from repro_torch.models.model import init_lm
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    opt = opt or OptConfig(name=cfg.optimizer)
    with _fake():
        model = init_lm(cfg, device="cpu")
        state = init_opt_state(model, opt)
    return {n: p for n, p in model.named_parameters()}, state


# ------------------------------------------------------------ assembly
def cell_specs(cfg, shape, mesh, opt=None):
    """(arg_structs, arg_specs) of the cell's step function:

    train  -> (state, batch), state = {"params", "opt", "step"}
    prefill-> (params, batch)
    decode -> (params, batch, cache)
    """
    from repro_torch.train.optimizer import OptConfig
    part = make_partitioner(mesh, cfg)
    b_st = batch_structs(cfg, shape)
    b_spec = batch_shardings(mesh, part, b_st)
    if shape.kind == "train":
        opt = opt or OptConfig(name=cfg.optimizer)
        params_st, opt_st = opt_structs(cfg, opt)
        p_spec = part.specs(((n, p.shape) for n, p in params_st.items()),
                            cfg)
        state_st = {"params": params_st, "opt": opt_st,
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}
        state_spec = {"params": p_spec,
                      "opt": opt_shardings(p_spec, opt_st),
                      "step": ()}
        return (state_st, b_st), (state_spec, b_spec)
    params_st = param_structs(cfg)
    p_spec = part.specs(((n, p.shape) for n, p in params_st.items()), cfg)
    if shape.kind == "prefill":
        return (params_st, b_st), (p_spec, b_spec)
    cache_st = cache_structs(cfg, shape.global_batch, shape.seq_len)
    c_spec = cache_shardings(mesh, part, cache_st)
    return (params_st, b_st, cache_st), (p_spec, b_spec, c_spec)


def tree_shard_bytes(structs, specs, mesh) -> int:
    """Bytes one device holds of a tree of structs under its specs."""
    sizes = mesh_sizes(mesh)

    def walk(st, sp):
        if isinstance(st, dict):
            return sum(walk(st[k], sp[k]) for k in st)
        if isinstance(st, (list, tuple)):
            return sum(walk(a, b) for a, b in zip(st, sp))
        n = st.numel() * st.element_size()
        for dim, ax in zip(st.shape, tuple(sp)):
            if ax is not None:
                n //= math.prod(sizes[a] for a in
                                ((ax,) if isinstance(ax, str) else ax))
        return n

    return int(walk(structs, specs))
