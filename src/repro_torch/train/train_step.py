"""The train step: microbatched gradients -> global-norm clip -> update.

The port of ``repro.train.train_step``. A train state is ``{"params":
LM (gradients on), "opt": the optimizer's tree, "step": int32}``;
``make_train_step(cfg)`` returns ``train_step(state, batch) -> (state,
metrics)``, which updates the parameters in place (the reference
donates them). ``cfg.microbatches`` splits the batch along axis 0 and
runs the forward and backward once a split: activation memory divided
by the splits, composed with ``cfg.remat``.
``state_tree`` / ``load_state_tree`` give a state as nested dicts of
tensors for ``checkpoint.Checkpointer`` and put one back.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import init_lm, lm_forward
from repro_torch.train.loss import lm_loss
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)

METRICS = ("nll", "z_loss", "accuracy", "tokens", "aux", "loss")


def make_train_state(cfg, opt: Optional[OptConfig] = None, *,
                     seed: int = 0,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A randomly initialized model (``init_lm``'s draws) with gradients
    on, zero optimizer moments and step 0, on ``device`` (default the
    card)."""
    opt = opt or OptConfig(name=cfg.optimizer)
    dev = resolve_device(device)
    model = init_lm(cfg, generator=generator, seed=seed, device=dev)
    model.requires_grad_(True)
    return {"params": model, "opt": init_opt_state(model, opt),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _loss_fn(model, cfg, tokens, targets, frontend):
    logits, aux = lm_forward(model, cfg, tokens, frontend=frontend)
    loss, metrics = lm_loss(logits, targets)
    total = loss + cfg.router_aux_weight * aux
    return total, dict(metrics, aux=aux, loss=total)


def _grads(model, cfg, tokens, targets, frontend):
    """(metrics, {name: gradient}) of the total loss; a parameter the
    loss does not reach gets zeros."""
    names, params = zip(*model.named_parameters())
    total, metrics = _loss_fn(model, cfg, tokens, targets, frontend)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, params, grads)}
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, opt: Optional[OptConfig] = None):
    """``train_step(state, batch)``; ``batch`` holds ``tokens`` and
    ``targets`` (B, S) and, for the vlm and audio families, ``frontend``
    (B, T, d). Metrics: the loss's (``nll``, ``z_loss``, ``accuracy``,
    ``tokens``), ``aux``, the total ``loss``, ``grad_norm`` and ``lr``,
    0-d tensors on the model's device."""
    opt = opt or OptConfig(name=cfg.optimizer)
    nmb = max(cfg.microbatches, 1)

    def train_step(state, batch):
        model = state["params"]
        dev = model.device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        targets = torch.as_tensor(batch["targets"], device=dev)
        frontend = batch.get("frontend")
        if frontend is not None:
            frontend = torch.as_tensor(frontend, device=dev)
        if nmb == 1:
            metrics, grads = _grads(model, cfg, tokens, targets, frontend)
        else:
            b = tokens.shape[0]
            if b % nmb:
                raise ValueError(f"batch {b} does not split into {nmb} "
                                 f"microbatches")
            mb = b // nmb
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=dev)
                     for n, p in model.named_parameters()}
            metrics = {k: torch.zeros((), device=dev) for k in METRICS}
            for i in range(nmb):
                rows = slice(i * mb, (i + 1) * mb)
                m, g = _grads(model, cfg, tokens[rows], targets[rows],
                              None if frontend is None else frontend[rows])
                for n, gi in g.items():
                    grads[n] = grads[n] + gi.float() / nmb
                for k in METRICS:
                    metrics[k] = metrics[k] + m[k] / nmb
                del g
        new_opt, opt_metrics = apply_updates(model, grads, state["opt"], opt,
                                             state["step"])
        metrics = dict(metrics, **opt_metrics)
        return ({"params": model, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step


def state_tree(state) -> Dict[str, Any]:
    """The state as nested dicts of tensors: ``params`` {name: tensor},
    ``opt`` and ``step`` (what ``Checkpointer.save`` takes, and the
    template ``Checkpointer.restore`` fills)."""
    return {"params": {n: p.detach()
                       for n, p in state["params"].named_parameters()},
            "opt": state["opt"], "step": state["step"]}


def load_state_tree(state, tree) -> Dict[str, Any]:
    """``state`` with the values of ``tree`` (``state_tree``'s layout, e.g.
    ``Checkpointer.restore(state_tree(state))``): the parameters copied
    in place, the optimizer's tree and the step taken as they are."""
    model = state["params"]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(tree["params"][n])
    return {"params": model, "opt": tree["opt"],
            "step": torch.as_tensor(tree["step"], dtype=torch.int32,
                                    device=model.device)}
