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

``moe_apply`` dispatches, as the reference does, to
``moe_sharded.moe_apply_sharded`` (collectives on local tensors, two
``all_to_all``s) when an activation mesh is installed
(``sharding.activations.current_mesh()``), else to ``_moe_apply_dense``,
the one-device path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import _act, dense_init, torch_dtype
from repro_torch.sharding.activations import current_mesh


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
    cf = cfg.moe_capacity_factor if capacity_factor is None \
        else capacity_factor
    if current_mesh()[0] is not None:
        from repro_torch.models.moe_sharded import moe_apply_sharded
        return moe_apply_sharded(p, cfg, x, capacity_factor=cf)
    return _moe_apply_dense(p, cfg, x, cf)


def group_tokens(xf: torch.Tensor, eidx: torch.Tensor, n_experts: int,
                 cap: int):
    """The (T, d) tokens in the (E, C, d) capacity buffer by their (T, k)
    experts (``dispatch``), and each flat slot's row there
    (``dest_by_flat``: E·C for a dropped slot)."""
    d, k = xf.shape[1], eidx.shape[1]
    order, dest = dispatch(eidx, n_experts, cap)
    src_tok = torch.div(order, k, rounding_mode="floor")
    grouped = torch.zeros((n_experts * cap + 1, d), dtype=xf.dtype,
                          device=xf.device)
    grouped[dest] = xf[src_tok]
    dest_by_flat = torch.empty_like(dest)
    dest_by_flat[order] = dest
    return grouped[:n_experts * cap].reshape(n_experts, cap, d), dest_by_flat


def combine(yg: torch.Tensor, dest_by_flat: torch.Tensor,
            gates: torch.Tensor) -> torch.Tensor:
    """Each flat slot's expert output from the (E·C, d) outputs (zero if
    dropped), weighted by its gate and summed over the k slots of a
    token: (T, d)."""
    (t, k), d = gates.shape, yg.shape[1]
    contrib = torch.cat([yg, yg.new_zeros((1, d))])[dest_by_flat]
    return torch.sum(contrib.reshape(t, k, d) *
                     gates.to(yg.dtype)[..., None], dim=1)


def expert_ffn(p, cfg, grouped: torch.Tensor) -> torch.Tensor:
    """The experts' gated FFNs over an (E, C, d) grouped buffer."""
    dt = grouped.dtype
    h = _act(cfg, torch.bmm(grouped, p.wi_gate.to(dt))).to(dt)
    h = h * torch.bmm(grouped, p.wi_up.to(dt))
    return torch.bmm(h, p.wo.to(dt))


def shared_ffn(sp, cfg, xf: torch.Tensor) -> torch.Tensor:
    """The shared expert over (T, d) tokens."""
    dt = xf.dtype
    hs = _act(cfg, xf @ sp.wi_gate.to(dt)).to(dt) * (xf @ sp.wi_up.to(dt))
    return hs @ sp.wo.to(dt)


def _moe_apply_dense(p: MoE, cfg, x: torch.Tensor, capacity_factor: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e = cfg.n_experts
    t = b * s
    xf = x.reshape(t, d)
    probs, gates, eidx = route(p, cfg, xf)

    # aux loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(0)
    disp = torch.zeros((t, e), device=x.device).scatter_(1, eidx, 1.0)
    aux = e * torch.sum(disp.mean(0) * me)

    # sort-based capacity-grouped dispatch
    cap = capacity(cfg, t, capacity_factor)
    grouped, dest_by_flat = group_tokens(xf, eidx, e, cap)
    yg = expert_ffn(p, cfg, grouped).reshape(e * cap, d)
    out = combine(yg, dest_by_flat, gates)

    if p.shared is not None:
        out = out + shared_ffn(p.shared, cfg, xf)
    return out.reshape(b, s, d), aux
