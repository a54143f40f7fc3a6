"""GQA attention: dense and chunked (flash) paths, sliding window, cross
attention, and the KV ring cache.

The port of ``repro.models.attention``. Two numerically equivalent
paths, held against each other by the tests:

* ``_dense_attention`` materializes the (Sq, Skv) float32 scores; used up
  to ``_DENSE_MAX_KV`` keys; its gradient is plain autograd's, as the
  reference's is ``jax.grad``'s.
* ``_flash_attention`` walks the keys in ``_FLASH_CHUNK``-key chunks with an
  online softmax (running max, denominator, accumulator), so memory is
  O(Sq·chunk); a Python loop over chunks where the reference scans. It
  is a ``torch.autograd.Function`` (``_FlashAttention``) whose forward
  also returns the logsumexp and saves the reference's residuals (q, k,
  v, positions, validity, out, lse) and whose backward is the
  reference's ``_flash_bwd_rule``: per chunk it recomputes the
  probabilities from the logsumexp, carries dq and emits dk, dv, so the
  backward too keeps O(Sq·chunk) memory.

Both are plain PyTorch ops that mirror the reference's arithmetic (float32
scores, the ``_NEG`` fill, probabilities cast to the values' dtype before
the second product), not ``scaled_dot_product_attention``: the masks
(window, ``kv_valid`` on a ring) and float32 scores are what the tests
hold against the reference. Masks are built per chunk from (q_pos,
kv_pos, kv_valid, causal, window), so ring-buffer (sliding-window) decode
caches go through the same code: slot positions are reconstructed
arithmetically, never stored.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models.layers import (apply_rope, dense_init, param,
                                       torch_dtype)

_NEG = -0.7 * float(torch.finfo(torch.float32).max)
_DENSE_MAX_KV = 2048
_FLASH_CHUNK = 1024


class Attention(nn.Module):
    """wq (d, H, hd), wk / wv (d, KV, hd), wo (H, hd, d); q/k/v biases
    when ``cfg.qkv_bias`` (never on cross attention). The constructor is
    the reference's ``init_attention``."""

    def __init__(self, cfg, gen: torch.Generator, cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        dt = torch_dtype(cfg.param_dtype)
        self.wq = dense_init(gen, (d, h, hd), dt)
        self.wk = dense_init(gen, (d, kv, hd), dt)
        self.wv = dense_init(gen, (d, kv, hd), dt)
        self.wo = dense_init(gen, (h, hd, d), dt)
        self.has_bias = bool(cfg.qkv_bias and not cross)
        if self.has_bias:
            dev = gen.device
            self.bq = param(torch.zeros((h, hd), dtype=dt, device=dev))
            self.bk = param(torch.zeros((kv, hd), dtype=dt, device=dev))
            self.bv = param(torch.zeros((kv, hd), dtype=dt, device=dev))


def qkv_project(p: Attention, cfg, x, kv_x=None, q_positions=None,
                kv_positions=None, rope: bool = True):
    """Returns q (B,Sq,H,hd), k,v (B,Skv,KV,hd), RoPE already applied."""
    kv_x = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", kv_x, p.wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", kv_x, p.wv.to(x.dtype))
    if p.has_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if rope and cfg.pos == "rope":
        q = apply_rope(q, q_positions, cfg)
        k = apply_rope(k, kv_positions, cfg)
    return q, k, v


def out_project(p: Attention, x_heads: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", x_heads, p.wo.to(x_heads.dtype))


def _mask(q_pos, kv_pos, kv_valid, causal: bool, window: int):
    """(B, Sq, Skv) boolean."""
    m = kv_valid[:, None, :]
    if causal:
        m = m & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        m = m & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return m


def _dense_attention(q, k, v, q_pos, kv_pos, kv_valid, causal, window):
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    s = s * (hd ** -0.5)
    m = _mask(q_pos, kv_pos, kv_valid, causal, window)
    s = torch.where(m[:, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v)
    return o.reshape(b, sq, h, hd)


def _chunk(a: torch.Tensor, j: int, chunk: int, fill=0) -> torch.Tensor:
    """Keys [j·chunk, (j+1)·chunk) of ``a`` along axis 1; a last, short
    chunk is padded with ``fill`` as the reference pads the whole axis."""
    c = a[:, j * chunk:(j + 1) * chunk]
    short = chunk - c.shape[1]
    if short:
        pad = torch.full((c.shape[0], short) + tuple(c.shape[2:]), fill,
                         dtype=c.dtype, device=c.device)
        c = torch.cat([c, pad], dim=1)
    return c


def _chunk_mask(q_pos, kv_pos, kv_valid, j, chunk, skv, causal, window,
                contiguous):
    """Chunk ``j``'s (B, Sq, chunk) mask: contiguous keys are at
    j·chunk + iota and valid below skv; otherwise the chunk's positions
    and validity (a padded slot is invalid)."""
    if contiguous:
        pos = (j * chunk + torch.arange(chunk, device=q_pos.device)
               ).expand(q_pos.shape[0], chunk)
        return _mask(q_pos, pos, pos < skv, causal, window)
    return _mask(q_pos, _chunk(kv_pos, j, chunk),
                 _chunk(kv_valid, j, chunk, False), causal, window)


def _flash_fwd_scan(qg, k, v, kv_pos, kv_valid, q_pos, causal, window,
                    chunk, contiguous):
    """Online-softmax forward over (B, Sq, KV, G, hd) float32 queries
    (already scaled). Returns (o, the logsumexp lse): a fully masked row's
    lse is the reference's 0.7·3e38, so its probabilities recompute to 0
    in the backward."""
    b, sq, kvh, g, hd = qg.shape
    skv = k.shape[1]
    nc = -(-skv // chunk)
    # the products take their inputs in the storage dtype and sum in
    # float32 (the reference's preferred_element_type): a bfloat16 pair's
    # product is exact in float32, so widening the operands is the same
    qg_lo = qg.to(k.dtype).float()
    m_run = torch.full((b, sq, kvh, g), _NEG, device=qg.device)
    l_run = torch.zeros((b, sq, kvh, g), device=qg.device)
    acc = torch.zeros((b, sq, kvh, g, hd), device=qg.device)
    for j in range(nc):
        kj = _chunk(k, j, chunk).float()
        vj = _chunk(v, j, chunk)
        s = torch.einsum("bskgh,btkh->bskgt", qg_lo, kj)
        msk = _chunk_mask(q_pos, kv_pos, kv_valid, j, chunk, skv, causal,
                          window, contiguous)
        s = torch.where(msk[:, :, None, None, :], s, _NEG)
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m_run - m_new)
        l_run = l_run * scale + p.sum(-1)
        # probabilities cast to the values' dtype before the second
        # product, which sums in float32
        acc = acc * scale[..., None] + torch.einsum(
            "bskgt,btkh->bskgh", p.to(vj.dtype).float(), vj.float())
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    lse = torch.where(l_run > 0,
                      m_run + torch.log(torch.clamp(l_run, min=1e-30)),
                      0.7 * 3.0e38)
    return o, lse


def _flash_bwd(q, k, v, q_pos, kv_pos, kv_valid, out, lse, do, causal,
               window, chunk, contiguous):
    """The reference's ``_flash_bwd_rule``, chunk by chunk: delta =
    Σ(dO·O) in float32; each chunk's probabilities recomputed as
    exp(s - lse) from the same masks; p and ds cast to k's dtype before
    their products, which sum in float32; dq carried across chunks, dk
    and dv emitted a chunk at a time and unpadded."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kvh, g, hd).float() * scale
    dog = do.reshape(b, sq, kvh, g, hd).float()
    og = out.reshape(b, sq, kvh, g, hd).float()
    delta = (dog * og).sum(-1)                           # (b,sq,kv,g)
    dogc = dog.to(k.dtype).float()
    qg_lo = qg.to(k.dtype).float()
    dq = torch.zeros((b, sq, kvh, g, hd), device=q.device)
    dks, dvs = [], []
    for j in range(-(-skv // chunk)):
        kj = _chunk(k, j, chunk).float()
        vj = _chunk(v, j, chunk).float()
        s = torch.einsum("bskgh,btkh->bskgt", qg_lo, kj)
        msk = _chunk_mask(q_pos, kv_pos, kv_valid, j, chunk, skv, causal,
                          window, contiguous)
        s = torch.where(msk[:, :, None, None, :], s, _NEG)
        p = torch.exp(s - lse[..., None])                # true probs
        pb = p.to(k.dtype).float()
        dvs.append(torch.einsum("bskgt,bskgh->btkh", pb, dogc))
        dp = torch.einsum("bskgh,btkh->bskgt", dogc, vj)
        dsb = (p * (dp - delta[..., None])).to(k.dtype).float()
        dq = dq + torch.einsum("bskgt,btkh->bskgh", dsb, kj)
        dks.append(torch.einsum("bskgt,bskgh->btkh", dsb, qg_lo))
    dq = (dq * scale).reshape(b, sq, h, hd).to(q.dtype)
    dk = torch.cat(dks, 1)[:, :skv].to(k.dtype)
    dv = torch.cat(dvs, 1)[:, :skv].to(v.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The chunked forward and the reference's custom backward; positions
    and validity get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, kv_valid, causal, window,
                chunk, contiguous):
        b, sq, h, hd = q.shape
        kvh = k.shape[2]
        qg = (q.reshape(b, sq, kvh, h // kvh, hd) * (hd ** -0.5)).float()
        o, lse = _flash_fwd_scan(qg, k, v, kv_pos, kv_valid, q_pos, causal,
                                 window, chunk, contiguous)
        out = o.reshape(b, sq, h, hd).to(q.dtype)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, kv_valid, out, lse)
        ctx.args = (causal, window, chunk, contiguous)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def _flash_attention(q, k, v, q_pos, kv_pos, kv_valid, causal, window,
                     chunk: int = _FLASH_CHUNK, contiguous: bool = False):
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, kv_valid, causal,
                                 window, chunk, contiguous)


def attention_core(q, k, v, *, q_pos, kv_pos, kv_valid=None,
                   causal: bool = True, window: int = 0,
                   force: Optional[str] = None,
                   contiguous_kv: bool = False):
    """Dense or flash by kv length (or ``force`` in {'dense', 'flash'}).
    ``contiguous_kv=True`` asserts kv positions are 0..skv-1 and all valid
    (self-attention over a full sequence); the flash path then derives
    each chunk's mask from its offset instead of position arrays."""
    if kv_valid is None:
        kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    use_flash = (k.shape[1] > _DENSE_MAX_KV if force is None
                 else force == "flash")
    if not use_flash:
        return _dense_attention(q, k, v, q_pos, kv_pos, kv_valid, causal,
                               window)
    return _flash_attention(q, k, v, q_pos, kv_pos, kv_valid, causal,
                            window, _FLASH_CHUNK, bool(contiguous_kv))


# ------------------------------------------------------------- KV caches
#
# A layer's cache is {"k", "v"} of (B, width, KV, hd); the model keeps all
# layers' caches stacked along leading layer axes (``model.init_cache``),
# the reference's layout, and hands each layer views into them. The
# writes below go into those buffers in place (the reference returns new
# arrays) and return the layer's cache.
def cache_width(cfg, max_len: int) -> int:
    """Sliding-window layers keep only a ``window`` ring."""
    return min(max_len, cfg.window) if cfg.window else max_len


def init_kv_cache(cfg, batch: int, max_len: int, dtype=None,
                  device=None) -> Dict[str, torch.Tensor]:
    """One layer's (empty) cache."""
    dtype = dtype or torch_dtype(cfg.compute_dtype)
    shp = (batch, cache_width(cfg, max_len), cfg.n_kv_heads,
           cfg.resolved_head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def cache_positions(t: torch.Tensor, width: int, batch: int):
    """Slot positions and validity of a ring written at pos % width, after
    tokens 0..t have been written (t: (B,) current decode position)."""
    slots = torch.arange(width, dtype=torch.int32, device=t.device)[None, :]
    tt = t.reshape(-1, 1).expand(batch, width).to(torch.int32)
    pos = tt - torch.remainder(tt - slots, width)
    return pos, pos >= 0


def cache_write_decode(cache, k_new, v_new, t: torch.Tensor):
    """Write one token's k/v (B, 1, KV, hd; rope applied) at slot
    t % width of each row."""
    width = cache["k"].shape[1]
    rows = torch.arange(t.shape[0], device=t.device)
    slot = torch.remainder(t.long(), width)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    return cache


def cache_write_prefill(cache, k_all, v_all):
    """Fill a cache from a full prefill pass (keeps the last ``width``)."""
    width = cache["k"].shape[1]
    s = k_all.shape[1]
    if s >= width:
        # ring layout: row i holds position (s-width+i) and must land at
        # slot (s-width+i) % width, i.e. rotate right by (s % width)
        roll = s % width
        cache["k"].copy_(torch.roll(k_all[:, s - width:], roll, dims=1))
        cache["v"].copy_(torch.roll(v_all[:, s - width:], roll, dims=1))
    else:
        cache["k"][:, :s] = k_all
        cache["v"][:, :s] = v_all
    return cache
