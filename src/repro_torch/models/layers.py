"""Shared layers: norms, RoPE, sinusoidal positions, the gated MLP,
embeddings.

The port of ``repro.models.layers``. The reference keeps parameters in
nested dicts; here each block is an ``nn.Module`` whose parameters keep
the reference's names and shapes (``wi_gate`` is ``(d, d_ff)``, not
``nn.Linear``'s transposed weight), so ``models/convert.py`` carries a
reference pytree across without touching a value and the arithmetic
below mirrors the reference's expression by expression: norms in
float32 and cast back, weights cast to the compute dtype before each
product, logits in float32.

Parameters are made with ``requires_grad=False``, so a served model
builds no autograd graph; ``train.train_step.make_train_state`` (and
``convert.train_state_from_reference``) turn gradients on for the model
they train.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.activations import from_model, to_model, tp_mlp


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: Optional[float] = None) -> nn.Parameter:
    """N(0, 1) * fan_in^-0.5 drawn in float32 on the generator's device,
    then cast (the reference's ``_dense_init``); scaled in place, so a
    draw holds one float32 copy beside its cast (kimi-k2's expert stacks
    are 22.5 GB each in float32)."""
    scale = scale if scale is not None else shape[0] ** -0.5
    x = torch.randn(shape, generator=gen, device=gen.device).mul_(scale)
    return param(x.to(dtype))


# ----------------------------------------------------------------- norms
class Norm(nn.Module):
    """RMSNorm or LayerNorm (``cfg.norm``), float32 scale (and bias);
    applied by ``norm_apply``."""

    def __init__(self, cfg, device, d: Optional[int] = None):
        super().__init__()
        d = d or cfg.d_model
        self.scale = param(torch.ones(d, device=device))
        self.bias = (param(torch.zeros(d, device=device))
                     if cfg.norm == "layernorm" else None)


def norm_apply(p: Norm, cfg, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p.scale + p.bias
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p.scale
    return y.to(x.dtype)


# ----------------------------------------------------------------- RoPE
def rope_frequencies(cfg, rot_dim: int, device=None) -> torch.Tensor:
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (cfg.rope_theta ** exponent)                 # (rot_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """Rotate the first ``rotary_pct`` of head dims (ChatGLM's 2d-RoPE
    uses 0.5; others 1.0). x: (..., seq, heads, head_dim); positions:
    (..., seq)."""
    hd = x.shape[-1]
    rot = int(hd * cfg.rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = rope_frequencies(cfg, rot, x.device)
    ang = positions[..., None].float() * inv                # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1.to(x.dtype), o2.to(x.dtype), x_pass], dim=-1)


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings at positions (..., S) -> (..., S, d)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    ang = positions[..., None].float() / (10000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------- MLP
class MLP(nn.Module):
    """Gated MLP: act(x @ wi_gate) * (x @ wi_up) @ wo (``mlp_apply``)."""

    def __init__(self, cfg, gen: torch.Generator,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        dt = torch_dtype(cfg.param_dtype)
        self.wi_gate = dense_init(gen, (d, ff), dt)
        self.wi_up = dense_init(gen, (d, ff), dt)
        self.wo = dense_init(gen, (ff, d), dt)


def _act(cfg, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def _mlp(p, cfg, x: torch.Tensor) -> torch.Tensor:
    # weights cast to the compute dtype; the activation's dtype pinned
    # after ``act``, as the reference pins jax.nn.gelu's float32 promotion
    h = _act(cfg, x @ p.wi_gate.to(x.dtype)).to(x.dtype) * \
        (x @ p.wi_up.to(x.dtype))
    return (h @ p.wo.to(x.dtype)).to(x.dtype)


def mlp_apply(p: MLP, cfg, x: torch.Tensor) -> torch.Tensor:
    """The gated MLP; on a mesh whose "model" axis splits ``d_ff``, this
    rank's columns and one all-reduce (``sharding.activations``)."""
    tp = tp_mlp(p)
    if tp is None:
        return _mlp(p, cfg, x)
    return from_model(_mlp(tp, cfg, to_model(x, tp.group)), tp.group)


# ----------------------------------------------------------------- embeddings
def init_embedding(gen: torch.Generator, cfg) -> nn.Parameter:
    x = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                    device=gen.device) * 0.02
    return param(x.to(torch_dtype(cfg.param_dtype)))


def embed_apply(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens]


def unembed_apply(head: Optional[torch.Tensor], embedding: torch.Tensor, cfg,
                  x: torch.Tensor) -> torch.Tensor:
    """float32 logits; tied embeddings reuse the embedding matrix."""
    w = embedding.T if cfg.tie_embeddings else head
    return (x @ w.to(x.dtype)).float()


def init_lm_head(gen: torch.Generator, cfg) -> Optional[nn.Parameter]:
    if cfg.tie_embeddings:
        return None
    return dense_init(gen, (cfg.d_model, cfg.vocab_size),
                      torch_dtype(cfg.param_dtype))
