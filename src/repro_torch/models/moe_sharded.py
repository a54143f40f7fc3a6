"""Expert-parallel MoE dispatch with explicit collectives.

The port of ``repro.models.moe_sharded``: the reference's fully manual
``shard_map`` body (``local_fn``), written on local tensors with
``torch.distributed`` collectives (``sharding.activations``). On a rank
of the installed activation mesh:

* tokens: ``x`` is the rank's slice of the batch over the FSDP axes
  (replicated over "model"); each "model" rank takes a contiguous
  1/n_model slice of those tokens, so capacity is split over "model"
  and no expert computes a token twice;
* routing: ``moe.route`` / ``moe.group_tokens`` per source rank, with the
  capacity of the slice (``moe.capacity``);
* experts: owned by the FSDP ranks when ``E % n_data == 0`` and
  ``E >= n_data`` (kimi-k2: 384 over 16): one ``all_to_all`` over the
  FSDP group ships each source's (expert, capacity) groups to their
  owner and the reverse one returns the outputs. Otherwise the tokens
  stay put and every rank computes all experts on its slice. The expert
  stacks are either whole (``E`` experts, of which the rank takes its
  own) or the rank's own ``E / n_data`` (expert-parallel storage);
* outputs: the shared expert is added and one ``all_gather`` over
  "model" puts the slices back together;
* ``aux``: from the means of ``fe`` / ``me`` over every axis, as the
  reference's ``pmean``s.

Each rank holds ``b_local`` rows of the batch, a split over every FSDP
axis by construction, so of the reference's two fallbacks to
``moe._moe_apply_dense`` only the second can fire: when the rank's
tokens do not divide over "model". Per-source capacity differs from the
global capacity of ``_moe_apply_dense`` only in what drops; at a
drop-free capacity factor the two agree.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Tuple

import torch

from repro_torch.models import moe
from repro_torch.sharding.activations import (all_to_all, axis_group,
                                              axis_index, current_mesh,
                                              gather_model, pmean, to_model)
from repro_torch.sharding.partition import mesh_sizes


def moe_apply_sharded(p, cfg, x: torch.Tensor, *, capacity_factor: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe.moe_apply`` under an activation mesh: x (b_local, S, d) ->
    (out (b_local, S, d), aux)."""
    mesh, fsdp, tp = current_mesh()
    shape = mesh_sizes(mesh)
    b, s, d = x.shape
    e = cfg.n_experts
    n_data = math.prod(shape[a] for a in fsdp)
    n_model = shape[tp] if tp else 1
    t_loc_all = b * s
    if t_loc_all % n_model:
        if p.wi_gate.shape[0] != e:
            raise ValueError(f"{t_loc_all} tokens do not split over "
                             f"{n_model} model ranks, and the dense "
                             f"fallback needs all {e} experts, not this "
                             f"rank's {p.wi_gate.shape[0]}")
        return moe._moe_apply_dense(p, cfg, x, capacity_factor)
    ep = e % n_data == 0 and e >= n_data
    e_loc = e // n_data if ep else e
    t_slice = t_loc_all // n_model
    cap = moe.capacity(cfg, t_slice, capacity_factor)
    dg = axis_group(mesh, fsdp) if n_data > 1 else None
    mg = axis_group(mesh, tp) if n_model > 1 else None
    d_idx = axis_index(mesh, fsdp)

    # the weights enter replicated over "model": their gradients sum
    # over its ranks' token slices
    def rep(w):
        return w if mg is None else to_model(w, mg)

    def own(w):
        if ep and w.shape[0] == e:
            w = w[d_idx * e_loc:(d_idx + 1) * e_loc]
        if w.shape[0] != e_loc:
            raise ValueError(f"expert stack of {w.shape[0]}: expected {e} "
                             f"or this rank's {e_loc}")
        return rep(w)

    experts = SimpleNamespace(wi_gate=own(p.wi_gate), wi_up=own(p.wi_up),
                              wo=own(p.wo))
    xf = x.reshape(t_loc_all, d)
    if mg is not None:
        m_idx = axis_index(mesh, tp)
        xf = to_model(xf, mg)[m_idx * t_slice:(m_idx + 1) * t_slice]
    probs, gates, eidx = moe.route(SimpleNamespace(router=rep(p.router)),
                                   cfg, xf)
    me = probs.mean(0)
    fe = torch.zeros((t_slice, e), device=x.device).scatter_(
        1, eidx, 1.0).mean(0)
    if dg is not None:
        me, fe = pmean(me, dg), pmean(fe, dg)
    if mg is not None:
        me, fe = pmean(me, mg, True), pmean(fe, mg, True)
    aux = e * torch.sum(fe * me)

    grouped, dest_by_flat = moe.group_tokens(xf, eidx, e, cap)
    if ep and dg is not None:
        # (n_data, e_loc, cap, d): split j to the owner of experts j
        recv = all_to_all(grouped.reshape(n_data, e_loc, cap, d), dg)
        merged = recv.movedim(0, 1).reshape(e_loc, n_data * cap, d)
        yg = moe.expert_ffn(experts, cfg, merged)
        yg = yg.reshape(e_loc, n_data, cap, d).movedim(1, 0).contiguous()
        yg = all_to_all(yg, dg).reshape(e * cap, d)
    else:
        yg = moe.expert_ffn(experts, cfg, grouped).reshape(e * cap, d)

    out = moe.combine(yg, dest_by_flat, gates)
    if p.shared is not None:
        sp = p.shared
        out = out + moe.shared_ffn(
            SimpleNamespace(wi_gate=rep(sp.wi_gate), wi_up=rep(sp.wi_up),
                            wo=rep(sp.wo)), cfg, xf)
    if mg is not None:
        out = gather_model(out, mg, m_idx, 0)
    return out.reshape(b, s, d), aux
