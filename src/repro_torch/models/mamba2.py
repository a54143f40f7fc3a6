"""Mamba2 (SSD) block: chunked-parallel prefill and recurrent decode.

The port of ``repro.models.mamba2``. The state-space duality form:
h_t = a_t ⊙ h_{t-1} + dt_t·(B_t ⊗ x_t), y_t = C_t·h_t + D·x_t, with
a_t = exp(A·dt_t) and a (P, N) state per head. A full pass walks
``CHUNK``-step chunks (a Python loop where the reference scans): the
intra-chunk part is quadratic and attention-like, the inter-chunk part
carries the state. Decode carries (conv_state, ssd_state), constant in
the sequence's length. ``_ssd_sequential`` is the step-by-step oracle.

The intra-chunk product ``"bij,bijh,bjhp->bihp"`` is taken as the
(B, L, L, H) weights ``scores·decay`` times the (B, L, H, P) inputs, one
batched product a head, so no (B, L, L, H, P) tensor is ever formed (at
zamba2's width it would be 5.4 GB at batch 4).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, param, torch_dtype

CHUNK = 256


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_head_dim, cfg.ssm_state


class Mamba2(nn.Module):
    """The reference's ``init_mamba2``: ``in_proj`` (d, 2·d_in + 2·N + H),
    the depthwise conv over (x, B, C), float32 ``a_log`` (A = -1),
    ``dt_bias`` (softplus(-2) ≈ 0.13), ``d_skip``, ``norm_scale`` and
    ``out_proj`` (d_in, d)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, n = _dims(cfg)
        conv_ch = d_in + 2 * n
        dt = torch_dtype(cfg.param_dtype)
        dev = gen.device
        self.in_proj = dense_init(gen, (d, 2 * d_in + 2 * n + h), dt)
        conv = torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                           device=dev) * 0.1
        self.conv_w = param(conv.to(dt))
        self.conv_b = param(torch.zeros(conv_ch, dtype=dt, device=dev))
        self.a_log = param(torch.zeros(h, device=dev))
        self.dt_bias = param(torch.full((h,), -2.0, device=dev))
        self.d_skip = param(torch.ones(h, device=dev))
        self.norm_scale = param(torch.ones(d_in, device=dev))
        self.out_proj = dense_init(gen, (d_in, d), dt)


def _split_proj(cfg, proj):
    d_in, _, _, n = _dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in: 2 * d_in + 2 * n]
    dt_raw = proj[..., 2 * d_in + 2 * n:]
    return z, xbc, dt_raw


def _conv_full(p: Mamba2, xbc):
    """Causal depthwise conv over time. xbc: (B, S, C)."""
    width = p.conv_w.shape[0]
    s = xbc.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(width):
        shift = width - 1 - i
        shifted = F.pad(xbc, (0, 0, shift, 0))[:, :s]
        out = out + shifted * p.conv_w[i].to(xbc.dtype)
    return F.silu(out + p.conv_b.to(xbc.dtype))


def _conv_step(p: Mamba2, conv_state, xbc_t):
    """conv_state: (B, width-1, C) float32 past inputs; xbc_t: (B, C)."""
    window = torch.cat([conv_state, xbc_t[:, None, :].to(conv_state.dtype)],
                       dim=1)
    out = torch.einsum("bwc,wc->bc", window.float(), p.conv_w.float())
    return F.silu(out + p.conv_b.float()), window[:, 1:]


def _gate_out(p: Mamba2, cfg, y, z):
    """RMSNorm(y * silu(z)) @ out_proj."""
    g = y * F.silu(z.float())
    ms = g.square().mean(-1, keepdim=True)
    g = g * torch.rsqrt(ms + cfg.norm_eps) * p.norm_scale
    return g.to(z.dtype) @ p.out_proj.to(z.dtype)


def _outer_update(xt, bt, dtt):
    """einsum("bhp,bn,bh->bhpn"): dt-scaled input times B."""
    return (xt * dtt[..., None])[..., None] * bt[:, None, None, :]


def _ssd_chunked(x, b_in, c_in, log_a, dt, h0):
    """x: (B,S,H,P); b_in, c_in: (B,S,N); log_a, dt: (B,S,H);
    h0: (B,H,P,N)."""
    bsz, s, h, p_dim = x.shape
    pad = -s % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b_in, c_in, log_a, dt = (F.pad(a, (0, 0, 0, pad))
                                 for a in (b_in, c_in, log_a, dt))
    nc = x.shape[1] // CHUNK
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    h_prev, ys = h0, []
    for c in range(nc):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        xc, bc, cc, lac, dtc = (a[:, sl] for a in (x, b_in, c_in, log_a, dt))
        cums = torch.cumsum(lac, dim=1)                   # (B,L,H) inclusive
        # inter-chunk: y_i += C_i · (decay_to_i · h_prev)
        y_inter = torch.einsum("bin,bhpn->bihp", cc, h_prev) * \
            torch.exp(cums)[..., None]
        # intra-chunk quadratic. The upper triangle's exponent cums_i -
        # cums_j (i < j) is positive and passes ~88 once a chunk's
        # dt·exp(a_log) sums past it: masked before the exp (to -inf, so
        # exp gives the reference's 0), its gradient stays finite where
        # the reference's exp-then-where gives 0·inf = NaN (ROADMAP
        # Queue 3); the forward's bits are the reference's
        scores = torch.einsum("bin,bjn->bij", cc, bc)     # (B,L,L)
        diff = cums[:, :, None, :] - cums[:, None, :, :]
        decay = torch.exp(torch.where(tri, diff, float("-inf")))  # (B,L,L,H)
        dtx = xc * dtc[..., None]                         # (B,L,H,P)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores[..., None] * decay,
                               dtx)
        # state update to the chunk's end
        tot = cums[:, -1]                                 # (B,H)
        decay_end = torch.exp(tot[:, None] - cums)        # (B,L,H)
        h_prev = h_prev * torch.exp(tot)[..., None, None] + torch.einsum(
            "bjhp,bjn->bhpn", dtx * decay_end[..., None], bc)
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1)[:, :s], h_prev


def _ssd_sequential(x, b_in, c_in, log_a, dt, h0):
    """Step-by-step oracle (and the decode recurrence's body)."""
    h, ys = h0, []
    for i in range(x.shape[1]):
        h = h * torch.exp(log_a[:, i])[..., None, None] + _outer_update(
            x[:, i], b_in[:, i], dt[:, i])
        ys.append(torch.einsum("bn,bhpn->bhp", c_in[:, i], h))
    return torch.stack(ys, dim=1), h


def init_ssm_state(cfg, batch: int, device=None):
    d_in, h, p_dim, n = _dims(cfg)
    conv_ch = d_in + 2 * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            device=device),
        "ssd": torch.zeros((batch, h, p_dim, n), device=device),
    }


def mamba2_apply(p: Mamba2, cfg, x, *, state: Optional[dict] = None,
                 decode: bool = False, sequential: bool = False):
    """x: (B, S, d) -> (y (B, S, d), new state or None). ``decode=True``
    takes one step (S == 1) from ``state``."""
    bsz, s, _ = x.shape
    d_in, h, p_dim, n = _dims(cfg)
    proj = x @ p.in_proj.to(x.dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    log_a = -torch.exp(p.a_log)[None, None, :] * dt          # (B,S,H)

    if decode:
        assert state is not None and s == 1
        conv_out, conv_state = _conv_step(p, state["conv"], xbc[:, 0])
        xs = conv_out[:, :d_in].reshape(bsz, h, p_dim)
        b_in = conv_out[:, d_in: d_in + n]
        c_in = conv_out[:, d_in + n:]
        h_new = state["ssd"] * torch.exp(log_a[:, 0])[..., None, None] + \
            _outer_update(xs, b_in, dt[:, 0])
        y = torch.einsum("bn,bhpn->bhp", c_in, h_new)
        y = y + xs * p.d_skip[None, :, None]
        out = _gate_out(p, cfg, y.reshape(bsz, 1, d_in), z)
        return out, {"conv": conv_state, "ssd": h_new}

    conv_out = _conv_full(p, xbc).float()
    xs = conv_out[..., :d_in].reshape(bsz, s, h, p_dim)
    b_in = conv_out[..., d_in: d_in + n]
    c_in = conv_out[..., d_in + n:]
    h0 = (torch.zeros((bsz, h, p_dim, n), device=x.device)
          if state is None else state["ssd"])
    runner = _ssd_sequential if sequential else _ssd_chunked
    y, h_fin = runner(xs, b_in, c_in, log_a, dt, h0)
    y = y + xs * p.d_skip[None, None, :, None]
    out = _gate_out(p, cfg, y.reshape(bsz, s, d_in), z)

    new_state = None
    if state is not None:
        tail = _conv_tail(xbc, cfg.ssm_conv - 1)
        new_state = {"conv": tail.float(), "ssd": h_fin}
    return out, new_state


def _conv_tail(xbc, width: int):
    """The last ``width`` conv inputs, zero-padded in front."""
    s = xbc.shape[1]
    if s >= width:
        return xbc[:, s - width:]
    return F.pad(xbc, (0, 0, width - s, 0))
