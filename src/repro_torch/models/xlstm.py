"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, a strictly sequential recurrence).

The port of ``repro.models.xlstm``. mLSTM runs in three modes that agree
to rounding (the tests hold them to each other and to the reference):
``sequential`` (the oracle recurrence), ``chunked`` (prefill: quadratic
inside a ``CHUNK``-step chunk, the (C, n, m) carry between chunks with
log-space stabilizers; a Python loop over chunks where the reference
scans) and one-step ``decode``. sLSTM feeds its hidden state back into
its gates, so it walks time step by step in every mode. Both states are
constant in the sequence's length.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, param, torch_dtype

CHUNK = 256
_EXPAND = 2          # mLSTM pre-up-projection factor
_FFN_FACTOR = 4.0 / 3.0
_NEG = -1e30         # log-space "minus infinity" of the stabilizers


def _mdims(cfg):
    d_in = _EXPAND * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


# =============================================================== mLSTM
class MLSTM(nn.Module):
    """The reference's ``init_mlstm``: up-projection to (x_m, z), a 4-tap
    causal conv, q/k/v (d_in, d_in), float32 input/forget gates (forget
    bias 3: open at init), the groupnorm scale and the down-projection."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        d_in, h, _ = _mdims(cfg)
        dt = torch_dtype(cfg.param_dtype)
        dev = gen.device
        self.up = dense_init(gen, (d, 2 * d_in), dt)
        conv = torch.randn((4, d_in), generator=gen, device=dev) * 0.1
        self.conv_w = param(conv.to(dt))
        self.conv_b = param(torch.zeros(d_in, dtype=dt, device=dev))
        self.wq = dense_init(gen, (d_in, d_in), dt)
        self.wk = dense_init(gen, (d_in, d_in), dt)
        self.wv = dense_init(gen, (d_in, d_in), dt)
        self.w_i = dense_init(gen, (d_in, h), torch.float32, scale=0.01)
        self.b_i = param(torch.zeros(h, device=dev))
        self.w_f = dense_init(gen, (d_in, h), torch.float32, scale=0.01)
        self.b_f = param(torch.full((h,), 3.0, device=dev))
        self.gn_scale = param(torch.ones(d_in, device=dev))
        self.down = dense_init(gen, (d_in, d), dt)


def init_mlstm_state(cfg, batch: int, device=None):
    d_in, h, hd = _mdims(cfg)
    return {
        "conv": torch.zeros((batch, 3, d_in), device=device),
        "c": torch.zeros((batch, h, hd, hd), device=device),
        "n": torch.zeros((batch, h, hd), device=device),
        "m": torch.full((batch, h), _NEG, device=device),
    }


def _conv4(p: MLSTM, x):
    s = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(4):
        shifted = F.pad(x, (0, 0, 3 - i, 0))[:, :s]
        out = out + shifted * p.conv_w[i].to(x.dtype)
    return F.silu(out + p.conv_b.to(x.dtype))


def _mlstm_qkvif(p: MLSTM, cfg, x_m, conv_x):
    b, s, _ = x_m.shape
    _, h, hd = _mdims(cfg)
    q = (conv_x @ p.wq.to(x_m.dtype)).reshape(b, s, h, hd)
    k = (conv_x @ p.wk.to(x_m.dtype)).reshape(b, s, h, hd)
    v = (x_m @ p.wv.to(x_m.dtype)).reshape(b, s, h, hd)
    xf = x_m.float()
    log_i = xf @ p.w_i + p.b_i                              # (B,S,H)
    log_f = F.logsigmoid(xf @ p.w_f + p.b_f)                # (B,S,H)
    k = k * (hd ** -0.5)
    return q.float(), k.float(), v.float(), log_i, log_f


def _mlstm_sequential(q, k, v, log_i, log_f, state):
    """Oracle recurrence. q/k/v: (B,S,H,hd); state: {'c', 'n', 'm'}."""
    c, n, m = state["c"], state["n"], state["m"]
    ys = []
    for t in range(q.shape[1]):
        qt, kt, vt, lit, lft = (a[:, t] for a in (q, k, v, log_i, log_f))
        m_new = torch.maximum(lft + m, lit)
        fp = torch.exp(lft + m - m_new)[..., None, None]
        ip = torch.exp(lit - m_new)[..., None, None]
        c = fp * c + ip * (vt[..., :, None] * kt[..., None, :])  # (B,H,hd,hd)
        n = fp[..., 0] * n + ip[..., 0] * kt
        num = torch.einsum("bhvk,bhk->bhv", c, qt)
        den = torch.einsum("bhk,bhk->bh", n, qt).abs()
        den = torch.maximum(den, torch.exp(-m_new))[..., None]
        ys.append(num / den)
        m = m_new
    return torch.stack(ys, dim=1), {"c": c, "n": n, "m": m}


def _mlstm_chunked(q, k, v, log_i, log_f, state):
    """Chunkwise-parallel mLSTM with the (C, n, m) carry."""
    b, s, h, hd = q.shape
    pad = -s % CHUNK
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        # padded steps must not enter the state: their input gate is -inf
        log_i = F.pad(log_i, (0, 0, 0, pad), value=_NEG)
    nc = q.shape[1] // CHUNK
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    c_prev, n_prev, m_prev = state["c"], state["n"], state["m"]
    ys = []
    for ci in range(nc):
        sl = slice(ci * CHUNK, (ci + 1) * CHUNK)
        qc, kc, vc, lic, lfc = (a[:, sl] for a in (q, k, v, log_i, log_f))
        bcum = torch.cumsum(lfc, dim=1)                  # (B,L,H) inclusive
        # log weights: intra a_ij = b_i - b_j + log i_j (j <= i); inter g_i
        a = bcum[:, :, None, :] - bcum[:, None, :, :] + lic[:, None, :, :]
        a = torch.where(tri, a, _NEG)                    # (B,i,j,H)
        g = bcum + m_prev[:, None, :]                    # (B,L,H)
        m_row = torch.maximum(a.amax(dim=2), g)          # (B,L,H)
        w_intra = torch.exp(a - m_row[:, :, None, :])
        w_inter = torch.exp(g - m_row)

        scores = torch.einsum("bihk,bjhk->bijh", qc, kc) * w_intra
        num = torch.einsum("bijh,bjhv->bihv", scores, vc) + \
            w_inter[..., None] * torch.einsum("bhvk,bihk->bihv", c_prev, qc)
        den = scores.sum(dim=2) + \
            w_inter * torch.einsum("bhk,bihk->bih", n_prev, qc)
        den = torch.maximum(den.abs(), torch.exp(-m_row))
        ys.append(num / den[..., None])

        # state update to the chunk's end
        b_l = bcum[:, -1]                                # (B,H)
        m_new = torch.maximum(b_l + m_prev,
                              (b_l[:, None] - bcum + lic).amax(dim=1))
        wj = torch.exp(b_l[:, None] - bcum + lic - m_new[:, None])  # (B,L,H)
        decay = torch.exp(b_l + m_prev - m_new)
        c_prev = decay[..., None, None] * c_prev + torch.einsum(
            "bjhv,bjhk->bhvk", wj[..., None] * vc, kc)
        n_prev = decay[..., None] * n_prev + torch.einsum(
            "bjh,bjhk->bhk", wj, kc)
        m_prev = m_new
    y = torch.cat(ys, dim=1)[:, :s]
    return y, {"c": c_prev, "n": n_prev, "m": m_prev}


def _groupnorm(x, scale, h: int, eps: float):
    """Per-head groupnorm over the head dim. x: (B,S,d_in)."""
    b, s, d_in = x.shape
    xg = x.reshape(b, s, h, d_in // h).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, unbiased=False, keepdim=True)
    y = (xg - mu) * torch.rsqrt(var + eps)
    return y.reshape(b, s, d_in) * scale


def mlstm_apply(p: MLSTM, cfg, x, *, state: Optional[dict] = None,
                decode: bool = False, sequential: bool = False):
    """x: (B, S, d) -> (y, new state or None)."""
    b, s, _ = x.shape
    d_in, h, _ = _mdims(cfg)
    up = x @ p.up.to(x.dtype)
    x_m, z = up[..., :d_in], up[..., d_in:]

    if decode:
        assert state is not None and s == 1
        window = torch.cat([state["conv"], x_m.float()], dim=1)  # (B,4,d_in)
        conv_x = F.silu(
            torch.einsum("bwc,wc->bc", window, p.conv_w.float())
            + p.conv_b.float())[:, None, :]
        q, k, v, li, lf = _mlstm_qkvif(p, cfg, x_m, conv_x.to(x.dtype))
        y, st = _mlstm_sequential(q, k, v, li, lf, state)
        new_state = dict(st, conv=window[:, 1:])
    else:
        conv_x = _conv4(p, x_m)
        q, k, v, li, lf = _mlstm_qkvif(p, cfg, x_m, conv_x)
        cell = state if state is not None else \
            init_mlstm_state(cfg, b, device=x.device)
        runner = _mlstm_sequential if sequential else _mlstm_chunked
        y, st = runner(q, k, v, li, lf, cell)
        new_state = None
        if state is not None:
            tail = F.pad(x_m.float(), (0, 0, max(0, 3 - s), 0))
            new_state = dict(st, conv=tail[:, -3:])

    y = _groupnorm(y.reshape(b, s, d_in), p.gn_scale, h, cfg.norm_eps)
    y = y.to(x.dtype) * F.silu(z)
    return y @ p.down.to(x.dtype), new_state


# =============================================================== sLSTM
class SLSTM(nn.Module):
    """The reference's ``init_slstm``: float32 input weights ``w`` (d, 4,
    H, hd) and block-diagonal recurrent weights ``r`` (H, hd, 4, hd) for
    the (z, i, f, o) gates, their bias (forget 3: open at init), the
    groupnorm scale and the gated post-up FFN (4/3 · d)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        hd = d // h
        f = int(_FFN_FACTOR * d)
        dt = torch_dtype(cfg.param_dtype)
        dev = gen.device
        self.w = dense_init(gen, (d, 4, h, hd), torch.float32)
        self.r = dense_init(gen, (h, hd, 4, hd), torch.float32, scale=0.02)
        bias = torch.zeros((4, h, hd), device=dev)
        bias[2] = 3.0
        self.b = param(bias)
        self.gn_scale = param(torch.ones(d, device=dev))
        self.ffn_gate = dense_init(gen, (d, f), dt)
        self.ffn_up = dense_init(gen, (d, f), dt)
        self.ffn_down = dense_init(gen, (f, d), dt)


def init_slstm_state(cfg, batch: int, device=None):
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = torch.zeros((batch, h, hd), device=device)
    return {"h": z, "c": z.clone(), "n": z + 1e-6,
            "m": torch.full_like(z, _NEG)}


def slstm_apply(p: SLSTM, cfg, x, *, state: Optional[dict] = None,
                decode: bool = False):
    """x: (B, S, d) -> (y, new state or None). Sequential over time by
    nature."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, d // cfg.n_heads
    wx = torch.einsum("bsd,dghk->bsghk", x.float(), p.w)
    st = state if state is not None else \
        init_slstm_state(cfg, b, device=x.device)
    h_t, c, n, m = st["h"], st["c"], st["n"], st["m"]
    ys = []
    for t in range(s):
        rec = torch.einsum("bhk,hkgv->bghv", h_t, p.r)
        pre = wx[:, t] + rec + p.b[None]
        z_t = torch.tanh(pre[:, 0])
        log_i = pre[:, 1]
        log_f = F.logsigmoid(pre[:, 2])
        o = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(log_f + m, log_i)
        fp = torch.exp(log_f + m - m_new)
        ip = torch.exp(log_i - m_new)
        c = fp * c + ip * z_t
        n = fp * n + ip
        h_t = o * c / n.clamp_min(1e-6)
        m = m_new
        ys.append(h_t)
    y = torch.stack(ys, dim=1).reshape(b, s, h, hd)

    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + cfg.norm_eps)).reshape(b, s, d) * \
        p.gn_scale
    y = y.to(x.dtype)

    ff = F.gelu(y @ p.ffn_gate.to(x.dtype), approximate="tanh").to(
        x.dtype) * (y @ p.ffn_up.to(x.dtype))
    out = (ff @ p.ffn_down.to(x.dtype)).to(x.dtype)
    new_state = {"h": h_t, "c": c, "n": n, "m": m} \
        if (state is not None or decode) else None
    return out, new_state
