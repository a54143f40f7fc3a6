"""Optimizers: AdamW and Adafactor (factored second moments).

The port of ``repro.train.optimizer``. Adafactor keeps O(n + m) second
moments for an (n, m) matrix instead of O(n·m) and no first moment. Both
keep their state in float32 whatever the parameters' dtype, and neither
keeps a float32 master copy: an update is computed in float32 from the
parameter and cast back to its dtype, in place. Weight decay goes on
every parameter, norms and biases included (this is not
``torch.optim.AdamW``). The state is a plain tree of tensors keyed by
parameter name (``state_tree`` in ``train_step`` checkpoints it).

The reference's leaf is a whole stack of layers (``blocks/attn/wq`` of
(L, d, H, hd)); the port's parameters are one layer each. Adafactor
decides per reference leaf whether a leaf is factored (its last two
dims) and clips the update by its RMS over the whole stack, so the
port's parameters are grouped by their reference leaf
(``models.model.reference_leaf_path``); every other step of both
optimizers is elementwise or reduces over a parameter's last two dims
only, so it runs per parameter.

On a mesh (``launch/train.py::MeshTrainer``) ``apply_updates`` runs on
this rank's blocks of the parameters, their gradients and moments
(``shards``): every elementwise step is the same, and the sums that
cross blocks (the global norm, Adafactor's row and column means over a
split dim, its RMS per reference leaf) add the blocks' partial sums
over the ranks that hold them, one all-reduce each.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.models.model import reference_leaf_path


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    adafactor_min_dim: int = 128  # factor only dims >= this


def schedule(opt: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 10% (float32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - opt.warmup_steps) /
                       max(opt.decay_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return opt.lr_peak * warm * cos


def _factored(shape, min_dim: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def leaf_groups(model) -> Dict[str, List[Tuple[str, torch.Tensor]]]:
    """The model's (name, parameter) pairs grouped by reference leaf
    ("blocks/attn/wq"), each group in the model's parameter order."""
    groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {}
    for name, p in model.named_parameters():
        keys, _ = reference_leaf_path(model.cfg, name)
        groups.setdefault("/".join(map(str, keys)), []).append((name, p))
    return groups


def leaf_shape(model, group) -> Tuple[int, ...]:
    """The reference leaf's shape: the stack axes its parameters index,
    then a parameter's own shape."""
    idxs = [reference_leaf_path(model.cfg, name)[1] for name, _ in group]
    lead = tuple(max(i[a] for i in idxs) + 1 for a in range(len(idxs[0])))
    return lead + tuple(group[0][1].shape)


def _leaf_factored(model, group, opt: OptConfig) -> bool:
    shape = leaf_shape(model, group)
    factored = _factored(shape, opt.adafactor_min_dim)
    if factored and group[0][1].ndim < 2:
        raise ValueError(f"{group[0][0]}: the reference factors its leaf "
                         f"{shape} over a stack axis, which a per-layer "
                         f"parameter cannot hold")
    return factored


def init_opt_state(model, opt: OptConfig) -> Dict[str, dict]:
    """Zero float32 moments for every parameter of ``model``: AdamW's
    ``m`` and ``v``; Adafactor's ``vr`` (shape[:-1]) and ``vc``
    (shape[:-2] + shape[-1:]) where the reference leaf is factored, else
    ``v``."""
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    if opt.name == "adamw":
        return {key: {name: zeros(p.shape, p)
                      for name, p in model.named_parameters()}
                for key in ("m", "v")}
    if opt.name != "adafactor":
        raise ValueError(f"unknown optimizer {opt.name!r}")
    v = {}
    for group in leaf_groups(model).values():
        factored = _leaf_factored(model, group, opt)
        for name, p in group:
            s = tuple(p.shape)
            v[name] = ({"vr": zeros(s[:-1], p),
                        "vc": zeros(s[:-2] + s[-1:], p)} if factored
                       else {"v": zeros(s, p)})
    return {"v": v}


def _global_norm(grads: Dict[str, torch.Tensor], shards=None) -> torch.Tensor:
    if shards is None:
        sq = sum(g.float().square().sum() for g in grads.values())
    else:
        sq = shards.total(sum(g.float().square().sum() / shards.replicas(n)
                              for n, g in grads.items()))
    return torch.sqrt(sq)


def _mean(t: torch.Tensor, dim: int, name: str, pdim: int, shards,
          keepdim: bool = False) -> torch.Tensor:
    """``t.mean(dim)``, where ``t``'s ``dim`` is parameter ``name``'s
    dim ``pdim``: over the whole dim when ``shards`` splits it."""
    if shards is None or not shards.split(name, pdim):
        return t.mean(dim, keepdim=keepdim)
    return shards.sum(name, pdim, t.sum(dim, keepdim=keepdim)) / \
        shards.shape(name)[pdim]


@torch.no_grad()
def apply_updates(model, grads: Dict[str, torch.Tensor], state, opt,
                  step: torch.Tensor, shards=None):
    """Clip ``grads`` ({name: gradient}) by their global norm, then update
    ``model``'s parameters and ``state``'s moments in place (the
    reference's donated buffers: no second copy of the moments is ever
    held) by AdamW or Adafactor at ``schedule(opt, step)``. Returns
    (state, {"grad_norm", "lr"}).

    ``shards`` (the mesh driver's) holds this rank's blocks instead:
    ``shards.params`` {name: block} are updated, and ``grads`` and
    ``state`` hold the same blocks; ``shards.shape(name)`` is the whole
    shape, ``shards.split(name, dim)`` whether a dim is split,
    ``shards.sum(name, dim, t)`` the sum of ``t`` over the ranks holding
    that dim's other blocks, ``shards.replicas(name)`` the ranks holding
    each block and ``shards.total(t)`` the sum over every rank."""
    params = dict(model.named_parameters()) if shards is None \
        else shards.params
    gnorm = _global_norm(grads, shards)
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(opt, step.to(gnorm.device))
    t = step.to(gnorm.device).float() + 1.0

    def clipped(name):
        return grads[name].float() * scale

    def write(p, delta):
        p.copy_((p.float() - lr * delta).to(p.dtype))

    if opt.name == "adamw":
        for name, p in params.items():
            g = clipped(name)
            # b·m + (1 - b)·g, each product rounded, as out of place
            m = state["m"][name].mul_(opt.b1).add_((1 - opt.b1) * g)
            v = state["v"][name].mul_(opt.b2).add_((1 - opt.b2) * g.square())
            m_hat = m / (1 - opt.b1 ** t)
            v_hat = v / (1 - opt.b2 ** t)
            write(p, m_hat / (torch.sqrt(v_hat) + opt.eps) +
                  opt.weight_decay * p.float())
        return state, {"grad_norm": gnorm, "lr": lr}

    # ---------------- adafactor
    decay = 1.0 - t ** -0.8
    for group in leaf_groups(model).values():
        updates, sq, count = [], 0.0, 0
        for name, _ in group:
            g = clipped(name)
            g2 = g.square() + 1e-30
            st = state["v"][name]
            if "vr" in st:
                vr = st["vr"].mul_(decay).add_(
                    (1 - decay) * _mean(g2, -1, name, -1, shards))
                vc = st["vc"].mul_(decay).add_(
                    (1 - decay) * _mean(g2, -2, name, -2, shards))
                r_factor = vr / torch.clamp(
                    _mean(vr, -1, name, -2, shards, keepdim=True), min=1e-30)
                precond = torch.rsqrt(torch.clamp(
                    r_factor[..., None] * vc[..., None, :], min=1e-30))
            else:
                vf = st["v"].mul_(decay).add_((1 - decay) * g2)
                precond = torch.rsqrt(torch.clamp(vf, min=1e-30))
            update = g * precond
            updates.append(update)
            if shards is None:
                sq = sq + update.square().sum()
                count += update.numel()
            else:
                sq = sq + update.square().sum() / shards.replicas(name)
                count += math.prod(shards.shape(name))
        if shards is not None:
            sq = shards.total(sq)
        # update clipping (Shazeer & Stern): RMS <= 1 over the whole leaf
        rms = torch.sqrt(sq / count + 1e-30)
        for (name, _), update in zip(group, updates):
            p = params[name]
            update = update / torch.clamp(rms, min=1.0)
            write(p, update + opt.weight_decay * p.float())
    return state, {"grad_norm": gnorm, "lr": lr}
