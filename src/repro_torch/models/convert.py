"""Carry weights across from the reference's parameter pytree.

The reference (``repro.models.model.init_lm``) keeps parameters in nested
dicts whose homogeneous layers are stacked along a leading layer axis
(``_vmap_init``): ``blocks/attn/wq`` is (L, d, H, hd), the MoE family's
leading dense layers are a stack of their own (``dense_blocks``) and its
experts add an axis (``blocks/moe/wi_gate`` is (L, E, d, ff)), the VLM's
and the hybrid's ``blocks`` are grouped (n_super, per, ...) and
(n_groups, per, ...) beside the hybrid's ``shared_blocks`` (n_shared,
...), whisper's decoder layer carries its cross block as
``blocks/cross``, and xLSTM's ``blocks`` is a list of unstacked
per-layer dicts. ``params_from_reference``
unstacks such a pytree, given as numpy arrays (or anything ``np.asarray``
takes), into the port's ``LM`` without changing a value; bfloat16 leaves
(``ml_dtypes``) go through float32, which holds them exactly.
``flat_arrays`` flattens either package's cache or parameters into
``{"path/to/leaf": ndarray}`` for comparison: the two caches share one
layout. ``train_state_from_reference`` carries a reference train state
(``repro.train.train_step.make_train_state``'s) across the same way:
its params, each optimizer moment unstacked by the parameter's leaf and
index, and the step.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import LM, reference_leaf_path


def _reference_leaf(params, cfg, name: str):
    """The reference leaf (stacked) and its layer index for port
    parameter ``name``."""
    keys, idx = reference_leaf_path(cfg, name)
    tree = params
    for key in keys:
        tree = tree[key]
    return tree, idx


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_reference(params, cfg, *, device: DeviceLike = "cuda") -> LM:
    """The port's LM holding the reference pytree ``params``' values."""
    dev = resolve_device(device)
    model = LM(cfg, torch.Generator(dev).manual_seed(0))
    used = set()
    for name, p in model.named_parameters():
        leaf, idx = _reference_leaf(params, cfg, name)
        used.add(id(leaf))
        val = _to_torch(np.asarray(leaf)[idx] if idx else leaf)
        if tuple(val.shape) != tuple(p.shape) or val.dtype != p.dtype:
            raise ValueError(f"{name}: reference {tuple(val.shape)} "
                             f"{val.dtype}, port {tuple(p.shape)} {p.dtype}")
        p.copy_(val)
    n_ref = len(flat_arrays(params))
    if len(used) != n_ref:
        raise ValueError(f"{cfg.name}: the port took {len(used)} of the "
                         f"reference's {n_ref} leaves")
    return model


def flat_arrays(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a/b/c": ndarray}`` of a nested dict (or list) of arrays or
    tensors; bfloat16 leaves widened to float32."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for key, val in tree.items():
            out.update(flat_arrays(val, f"{prefix}{key}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, val in enumerate(tree):
            out.update(flat_arrays(val, f"{prefix}{i}/"))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    else:
        arr = np.asarray(tree)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
    return {prefix.rstrip("/"): arr}


def _moment(tree, keys, idx, what: str) -> torch.Tensor:
    for key in keys:
        tree = tree[key]
    a = np.asarray(tree[what] if what else tree)
    return _to_torch(a[idx] if idx else a)


def train_state_from_reference(state, cfg, opt=None, *,
                               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The port's train state (``train.train_step.make_train_state``'s
    layout) holding a reference train state's values: params through
    ``params_from_reference`` (with gradients on), AdamW's ``m``/``v`` or
    Adafactor's ``vr``/``vc``/``v`` per parameter, each the slice of its
    reference leaf's moment at the parameter's stack index, and the
    step. ``opt`` names the optimizer (default ``cfg.optimizer``)."""
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    dev = resolve_device(device)
    opt = opt or OptConfig(name=cfg.optimizer)
    model = params_from_reference(state["params"], cfg, device=dev)
    model.requires_grad_(True)
    ours = init_opt_state(model, opt)
    ref = state["opt"]
    for name, _ in model.named_parameters():
        keys, idx = reference_leaf_path(cfg, name)
        if opt.name == "adamw":
            for what in ("m", "v"):
                val = _moment(ref[what], keys, idx, None)
                ours[what][name] = _checked(val, ours[what][name], name)
        else:
            for what, buf in ours["v"][name].items():
                val = _moment(ref["v"], keys, idx, what)
                ours["v"][name][what] = _checked(val, buf, name)
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=dev)
    return {"params": model, "opt": ours, "step": step}


def _checked(val: torch.Tensor, like: torch.Tensor, name: str):
    if tuple(val.shape) != tuple(like.shape) or val.dtype != like.dtype:
        raise ValueError(f"{name}: reference moment {tuple(val.shape)} "
                         f"{val.dtype}, port {tuple(like.shape)} "
                         f"{like.dtype}")
    return val.to(like.device)
