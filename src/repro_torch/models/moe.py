"""Mixture-of-Experts layer: top-k routing with capacity-grouped dispatch.

The port of ``repro.models.moe``'s one-device path (``_moe_apply_dense``).
Dispatch is sort-based (no (T, E, C) one-hot): flatten the (T, k)
assignments, stable-sort them by expert, rank each slot within its
expert's group, and scatter the tokens into an (E, C, d) buffer; the
expert FFNs run as grouped products over that buffer. A slot ranked at
or past the capacity C is dropped: its destination is the sentinel row
``E·C``, appended to the buffer and sliced off afterwards, as the
reference's ``mode="drop"`` scatter and its appended zero row do, so its
contribution is zero. The sort is stable, so the same slots drop as in
the reference.

The reference dispatches through ``moe_sharded.moe_apply_sharded`` (a
manual ``shard_map`` with two ``all_to_all``s) only when an activation
mesh is installed (``sharding.activations.current_mesh()``), and its
``shard_moe_grouped`` constrains the grouped buffer only under such a
mesh; both come with ``sharding/`` (ROADMAP Queue 1 item 19d).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import _act, dense_init, torch_dtype


class SharedExpert(nn.Module):
    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, sff = cfg.d_model, cfg.d_ff_expert * cfg.n_shared_experts
        dt = torch_dtype(cfg.param_dtype)
        self.wi_gate = dense_init(gen, (d, sff), dt)
        self.wi_up = dense_init(gen, (d, sff), dt)
        self.wo = dense_init(gen, (sff, d), dt)


class MoE(nn.Module):
    """float32 router (d, E); experts stacked: ``wi_gate`` / ``wi_up``
    (E, d, ff), ``wo`` (E, ff, d); ``shared`` when ``n_shared_experts``.
    The constructor is the reference's ``init_moe``."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
        dt = torch_dtype(cfg.param_dtype)
        self.router = dense_init(gen, (d, e), torch.float32)
        self.wi_gate = dense_init(gen, (e, d, ff), dt)
        self.wi_up = dense_init(gen, (e, d, ff), dt)
        self.wo = dense_init(gen, (e, ff, d), dt)
        self.shared = SharedExpert(cfg, gen) if cfg.n_shared_experts else None


def route(p: MoE, cfg, xf: torch.Tensor):
    """float32 router softmax over (T, d) tokens, its top-k and the
    renormalized gates: (probs (T, E), gates (T, k), experts (T, k))."""
    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, eidx


def capacity(cfg, tokens: int, capacity_factor: float) -> int:
    """Slots an expert takes in a call over ``tokens`` tokens."""
    return max(int(capacity_factor * tokens * cfg.experts_per_token
                   / cfg.n_experts), 1)


def dispatch(eidx: torch.Tensor, n_experts: int, cap: int):
    """The flat (T·k) slots sorted by expert, stably (``order``), and
    each sorted slot's row in the (E·C) buffer (``dest``): its expert's
    base plus its rank in the expert's group, or the sentinel row E·C
    when the rank reaches the capacity C (the slot drops)."""
    eflat = eidx.reshape(-1)                                   # (T*k,)
    order = torch.argsort(eflat, stable=True)
    es = eflat[order]
    starts = torch.searchsorted(es, torch.arange(n_experts,
                                                 device=eidx.device))
    rank = torch.arange(eflat.numel(), device=eidx.device) - starts[es]
    dest = torch.where(rank < cap, es * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    return order, dest


def moe_apply(p: MoE, cfg, x: torch.Tensor, *,
              capacity_factor: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux load-balancing loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    cf = cfg.moe_capacity_factor if capacity_factor is None \
        else capacity_factor
    xf = x.reshape(t, d)
    probs, gates, eidx = route(p, cfg, xf)

    # aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(0)
    disp = torch.zeros((t, e), device=x.device).scatter_(1, eidx, 1.0)
    aux = e * torch.sum(disp.mean(0) * me)

    # sort-based capacity-grouped dispatch
    cap = capacity(cfg, t, cf)
    order, dest = dispatch(eidx, e, cap)
    src_tok = torch.div(order, k, rounding_mode="floor")
    grouped = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    grouped[dest] = xf[src_tok]
    grouped = grouped[:e * cap].reshape(e, cap, d)

    h = _act(cfg, torch.bmm(grouped, p.wi_gate.to(x.dtype))).to(x.dtype)
    h = h * torch.bmm(grouped, p.wi_up.to(x.dtype))
    yg = torch.bmm(h, p.wo.to(x.dtype)).reshape(e * cap, d)

    # combine: each flat slot's expert output (zero if dropped), weighted
    # by its gate
    dest_by_flat = torch.empty_like(dest)
    dest_by_flat[order] = dest
    contrib = torch.cat([yg, yg.new_zeros((1, d))])[dest_by_flat]
    out = torch.sum(contrib.reshape(t, k, d) * gates.to(x.dtype)[..., None],
                    dim=1)

    if p.shared is not None:
        sp = p.shared
        hs = _act(cfg, xf @ sp.wi_gate.to(x.dtype)).to(x.dtype) * (
            xf @ sp.wi_up.to(x.dtype))
        out = out + hs @ sp.wo.to(x.dtype)
    return out.reshape(b, s, d), aux
