"""Model assembly for the ten assigned architectures.

The port of ``repro.models.model``'s serving path: dense GQA decoders
(qwen2, chatglm3, mistral-nemo, h2o-danube with its sliding window), MoE
decoders (kimi-k2 with its leading dense layer and shared expert,
mixtral), the VLM's cross-attention superblocks (llama-3.2-vision), the
encoder-decoder (whisper), the hybrid Mamba2 trunk with shared attention
blocks (zamba2) and xLSTM's mLSTM/sLSTM stack. The blocks and the LM are
``nn.Module``s with an ``nn.ModuleList`` of layers, walked by a Python
loop where the reference scans a stacked layer axis;
``reference_leaf_path`` maps a parameter to its place in the reference's
stacks, by which ``models/convert.py`` unstacks a reference pytree into
them and the optimizer groups Adafactor's leaves. Three entry
points, as in the reference:

  lm_forward(model, cfg, tokens, frontend=...)   no-cache forward
  lm_prefill(model, cfg, tokens, ..., max_len)   fills the KV/SSM caches
  lm_decode_step(model, cfg, token, cache)       one token (serve_step)

Layouts: the MoE family's ``dense_blocks`` (``first_k_dense`` of them)
come before its MoE ``blocks``; the VLM's decoder layers are
``blocks[s·per + i]`` for superblock ``s`` and self-attention layer
``i < per = cross_attn_every - 1``, each superblock closed by
``cross_blocks[s]``; whisper's decoder layer ``l`` is ``blocks[l]`` then
``cross_blocks[l]`` over the encoder's output; zamba2's group ``g`` is
the Mamba2 layers ``blocks[g·per + i]`` (``per = attn_every``) followed
by ``shared_blocks[g % n_shared_blocks]``; xLSTM's ``blocks[i]`` holds an
sLSTM cell where ``i`` is in ``slstm_at``, else an mLSTM cell. The cache
keeps the reference's stacked layout (``init_cache``), written in place.

Training (``train/``) differentiates ``lm_forward``, which takes the
reference's ``remat`` (``cfg.remat`` by default): ``_remat`` wraps what
the reference scans, one step at a time (a layer for dense and moe, a
superblock for the vlm, a decoder layer with its cross block for
whisper, a group with its shared block for the hybrid; xLSTM's loop
is not rematerialized, as in the reference), and whisper's encoder
layers by ``cfg.remat``. ``lm_prefill`` and ``lm_decode_step`` run
under ``torch.no_grad()``: serving builds no graph.

On a device mesh (``sharding.activations.activation_mesh``) each rank
runs these functions on its own slice of the batch, so the reference's
``shard_bsd`` / ``shard_logits`` anchors have no counterpart here; the
training forward's self-attention (``self_block_fwd`` without
``return_kv``) and every gated MLP take their tensor-parallel split
from ``sharding.activations`` (``tp_attention``, ``layers.mlp_apply``),
and the MoE layer dispatches to ``models/moe_sharded.py``. Prefill and
decode keep every KV head in their caches, so their attention runs
whole on every model rank. The loops ask for each step's weights whole
(``sharding.activations.whole``) inside what ``_remat`` wraps, and for
the embedding, final norm and head around their use: the mesh driver
gathers them there and nowhere else. Without a mesh nothing changes.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe, xlstm
from repro_torch.models.layers import (MLP, Norm, embed_apply,
                                       init_embedding, init_lm_head,
                                       mlp_apply, norm_apply, sinusoid,
                                       torch_dtype, unembed_apply)
from repro_torch.sharding.activations import (from_model, to_model,
                                              tp_attention, whole)

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


# ------------------------------------------------------------ blocks
# (the constructors are the reference's init_self_block, init_cross_block
# and init_mamba_layer, and the xLSTM stack's per-layer dicts)
class SelfBlock(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, *, use_moe: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg, gen.device)
        self.attn = attn.Attention(cfg, gen)
        self.ln2 = Norm(cfg, gen.device)
        if use_moe:
            self.moe = moe.MoE(cfg, gen)
        else:
            self.mlp = MLP(cfg, gen)


class CrossBlock(nn.Module):
    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        self.ln1 = Norm(cfg, gen.device)
        self.attn = attn.Attention(cfg, gen, cross=True)
        self.ln2 = Norm(cfg, gen.device)
        self.mlp = MLP(cfg, gen)


class MambaLayer(nn.Module):
    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        self.ln = Norm(cfg, gen.device)
        self.m = mamba2.Mamba2(cfg, gen)


class XLSTMLayer(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, *, slstm: bool):
        super().__init__()
        self.ln = Norm(cfg, gen.device)
        if slstm:
            self.slstm = xlstm.SLSTM(cfg, gen)
        else:
            self.mlstm = xlstm.MLSTM(cfg, gen)


def _ffn_part(p, cfg, x):
    h = norm_apply(p.ln2, cfg, x)
    if hasattr(p, "moe"):
        h, aux = moe.moe_apply(p.moe, cfg, h)
        return x + h, aux
    return x + mlp_apply(p.mlp, cfg, h), torch.zeros((), device=x.device)


def self_block_fwd(p: SelfBlock, cfg, x, positions, *, causal=True,
                   window=None, return_kv=False):
    h = norm_apply(p.ln1, cfg, x)
    # this model rank's heads on a mesh that splits them (never when the
    # caller keeps the k/v: a cache holds every head)
    tp = None if return_kv else tp_attention(p.attn, cfg)
    pa = p.attn if tp is None else tp
    if tp is not None:
        h = to_model(h, tp.group)
    q, k, v = attn.qkv_project(pa, cfg, h, q_positions=positions,
                               kv_positions=positions)
    o = attn.attention_core(q, k, v, q_pos=positions, kv_pos=positions,
                            causal=causal,
                            window=cfg.window if window is None else window,
                            contiguous_kv=True)
    o = attn.out_project(pa, o)
    if tp is not None:
        o = from_model(o, tp.group)
    x = x + o
    x, aux = _ffn_part(p, cfg, x)
    if return_kv:
        return x, aux, (k, v)
    return x, aux


def self_block_decode(p: SelfBlock, cfg, x, cache, t):
    """x: (B,1,d); cache: one layer's {'k','v'} (written in place);
    t: (B,) current position."""
    h = norm_apply(p.ln1, cfg, x)
    pos = t.reshape(-1, 1)
    q, k_new, v_new = attn.qkv_project(p.attn, cfg, h, q_positions=pos,
                                       kv_positions=pos)
    cache = attn.cache_write_decode(cache, k_new, v_new, t)
    width = cache["k"].shape[1]
    kv_pos, kv_valid = attn.cache_positions(t, width, x.shape[0])
    o = attn.attention_core(q, cache["k"], cache["v"], q_pos=pos,
                            kv_pos=kv_pos, kv_valid=kv_valid, causal=True,
                            window=cfg.window)
    x = x + attn.out_project(p.attn, o)
    x, _ = _ffn_part(p, cfg, x)
    return x, cache


def cross_block_kv(p: CrossBlock, cfg, kv_src):
    """Cross-attention k/v from encoder or frontend states (no RoPE)."""
    _, k, v = attn.qkv_project(p.attn, cfg, kv_src, kv_x=kv_src, rope=False)
    return {"k": k, "v": v}


def cross_block_core(p: CrossBlock, cfg, x, ck, cv):
    b, skv = ck.shape[0], ck.shape[1]
    h = norm_apply(p.ln1, cfg, x)
    q = torch.einsum("bsd,dhk->bshk", h, p.attn.wq.to(h.dtype))
    zeros = torch.zeros((), dtype=torch.int32, device=x.device)
    o = attn.attention_core(q, ck, cv, q_pos=zeros.expand(b, x.shape[1]),
                            kv_pos=zeros.expand(b, skv), causal=False,
                            window=0, contiguous_kv=True)
    x = x + attn.out_project(p.attn, o)
    return _ffn_part(p, cfg, x)


def cross_block_fwd(p: CrossBlock, cfg, x, kv_src):
    kv = cross_block_kv(p, cfg, kv_src)
    return cross_block_core(p, cfg, x, kv["k"], kv["v"])


def mamba_layer(p: MambaLayer, cfg, x, **kw):
    """Pre-norm Mamba2 with its residual: (x + y, new state or None)."""
    y, st = mamba2.mamba2_apply(p.m, cfg, norm_apply(p.ln, cfg, x), **kw)
    return x + y, st


def xlstm_layer(p: XLSTMLayer, cfg, x, **kw):
    """Pre-norm sLSTM or mLSTM with its residual: (x + y, new state)."""
    h = norm_apply(p.ln, cfg, x)
    if hasattr(p, "slstm"):
        y, st = xlstm.slstm_apply(p.slstm, cfg, h, **kw)
    else:
        y, st = xlstm.mlstm_apply(p.mlstm, cfg, h, **kw)
    return x + y, st


def _groups_of(cfg, what: str, every: int) -> int:
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of {what} {every}")
    return cfg.n_layers // every


# ---------------------------------------------------------------- remat
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default)


def _from_parameter(t) -> bool:
    """Whether ``t`` is a parameter, or reaches one or a gathered whole
    parameter (an autograd function that sets ``gathers_parameters``)
    through single-input autograd nodes only (views, reshapes, casts): a
    weight operand."""
    if not isinstance(t, torch.Tensor):
        return False
    if isinstance(t, nn.Parameter):
        return True
    fn = t.grad_fn
    while fn is not None:
        if getattr(type(fn), "_forward_cls", None) is not None and \
                getattr(type(fn)._forward_cls, "gathers_parameters", False):
            return True
        if type(fn).__name__ == "AccumulateGrad":
            return isinstance(fn.variable, nn.Parameter)
        nxt = [f for f, _ in fn.next_functions if f is not None]
        if len(nxt) != 1:
            return False
        fn = nxt[0]
    return False


def _selective_policy(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: save the
    output of a product with no batch dimension, recompute the rest.
    ``einsum`` lowers a weight projection to ``mm``/``addmm`` or to a
    ``bmm`` with a batch of 1, attention's and the SSMs' batched products
    to ``bmm``s of activations, and the MoE's grouped products to ``bmm``s
    over E experts: so a product is saved when one operand is a weight
    and it has no batch (a ``bmm``'s batch of 1)."""
    save = (op in _PRODUCTS
            and (op is not torch.ops.aten.bmm.default
                 or args[0].shape[0] == 1)
            and any(_from_parameter(a) for a in args))
    return (ckpt.CheckpointPolicy.MUST_SAVE if save
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, mode: str) -> Callable:
    """``fn`` rematerialized as the reference's ``_remat``: "none" saves
    every activation, "full" recomputes the whole step in the backward
    (``nothing_saveable``), "selective" saves only the weight products'
    outputs. With no graph to build (grad mode off, or a hidden state that
    needs no gradient: a frozen model served) the step runs as it is."""
    if mode not in ("none", "full", "selective"):
        raise ValueError(f"unknown remat mode {mode!r}")
    if mode == "none":
        return fn

    @functools.wraps(fn)
    def step(*args):
        if not (torch.is_grad_enabled() and args[0].requires_grad):
            return fn(*args)
        if mode == "full":
            return ckpt.checkpoint(fn, *args, use_reentrant=False)
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts,
                _selective_policy))
    return step


# ---------------------------------------------------------------- the LM
class LM(nn.Module):
    """Embedding, the family's layers, final norm and (untied) head;
    whisper adds its encoder (``enc_blocks``, ``enc_norm``)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        fam = cfg.family
        if fam not in FAMILIES:
            raise ValueError(f"unknown family {fam}")
        self.cfg = cfg
        dev = gen.device
        self.embed = init_embedding(gen, cfg)
        self.final_norm = Norm(cfg, dev)
        self.register_parameter("head", init_lm_head(gen, cfg))
        n_self, n_cross = 0, 0
        if fam == "dense":
            n_self = cfg.n_layers
        elif fam == "moe":
            nd = cfg.first_k_dense
            self.dense_blocks = nn.ModuleList(
                SelfBlock(cfg, gen) for _ in range(nd))
            self.blocks = nn.ModuleList(
                SelfBlock(cfg, gen, use_moe=True)
                for _ in range(cfg.n_layers - nd))
        elif fam == "vlm":
            n_super = _groups_of(cfg, "cross_attn_every",
                                 cfg.cross_attn_every)
            n_self, n_cross = n_super * (cfg.cross_attn_every - 1), n_super
        elif fam == "audio":
            self.enc_blocks = nn.ModuleList(
                SelfBlock(cfg, gen) for _ in range(cfg.encoder_layers))
            self.enc_norm = Norm(cfg, dev)
            n_self = n_cross = cfg.n_layers
        elif fam == "hybrid":
            n_groups = _groups_of(cfg, "attn_every", cfg.attn_every)
            self.blocks = nn.ModuleList(
                MambaLayer(cfg, gen)
                for _ in range(n_groups * cfg.attn_every))
            self.shared_blocks = nn.ModuleList(
                SelfBlock(cfg, gen) for _ in range(cfg.n_shared_blocks))
        else:   # ssm
            self.blocks = nn.ModuleList(
                XLSTMLayer(cfg, gen, slstm=i in cfg.slstm_at)
                for i in range(cfg.n_layers))
        if fam in ("dense", "vlm", "audio"):
            self.blocks = nn.ModuleList(
                SelfBlock(cfg, gen) for _ in range(n_self))
            self.cross_blocks = nn.ModuleList(
                CrossBlock(cfg, gen) for _ in range(n_cross))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, frontend=None):
        return lm_forward(self, self.cfg, tokens, frontend=frontend)


def init_lm(cfg, *, generator: Optional[torch.Generator] = None,
            seed: int = 0, device: DeviceLike = "cuda") -> LM:
    """A randomly initialized LM on ``device`` (default the card; raises
    without CUDA), drawn from ``generator`` (default one seeded with
    ``seed`` on ``device``). The embedding table is the first draw, so
    ``layers.init_embedding`` on a generator seeded alike gives the same
    table without the rest of the model."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(dev).manual_seed(seed)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, device {dev}")
    return LM(cfg, gen)


def _superblocks(params: LM, cfg):
    """VLM: (self-attention blocks, cross block) of each superblock."""
    per = cfg.cross_attn_every - 1
    for s, cross in enumerate(params.cross_blocks):
        yield s, params.blocks[s * per:(s + 1) * per], cross


def _hybrid_groups(params: LM, cfg):
    """Hybrid: (group, its Mamba2 layers, its shared block)."""
    per = cfg.attn_every
    for g in range(len(params.blocks) // per):
        yield (g, params.blocks[g * per:(g + 1) * per],
               params.shared_blocks[g % cfg.n_shared_blocks])


def _self_stacks(params: LM, cfg):
    """Dense and MoE: (cache key, blocks) in order."""
    if cfg.family == "moe" and cfg.first_k_dense:
        yield "dense_layers", params.dense_blocks
    yield "layers", params.blocks


def reference_leaf_path(cfg, name: str):
    """How the reference stacks port parameter ``name`` (e.g.
    ``blocks.7.attn.wq``): (keys, idx), the path of its reference leaf in
    the reference pytree (dict keys, and xLSTM's list index) and its index
    along the leaf's leading stack axes (``()`` for an unstacked leaf)."""
    parts = name.split(".")
    if parts[0] == "embed":
        return ("embed", "embedding"), ()
    if parts[0] == "head":
        return ("head", "w"), ()
    if parts[0] in ("final_norm", "enc_norm"):
        return (parts[0], parts[1]), ()
    group, i, path = parts[0], int(parts[1]), tuple(parts[2:])
    if group == "cross_blocks" and cfg.family == "audio":
        return ("blocks", "cross") + path, (i,)
    if cfg.family == "ssm":
        return (group, i) + path, ()
    if group == "blocks" and cfg.family in ("vlm", "hybrid"):
        per = (cfg.cross_attn_every - 1 if cfg.family == "vlm"
               else cfg.attn_every)
        return (group,) + path, (i // per, i % per)
    return (group,) + path, (i,)


# -------------------------------------------------------------- forward
def _as_tokens(params: LM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.device).long()


def _frontend(params: LM, cfg, frontend):
    if frontend is None:
        raise ValueError(f"the {cfg.family} family needs stub frontend "
                         f"embeddings")
    return torch.as_tensor(frontend, device=params.device)


def _embed_tokens(params: LM, cfg, tokens, positions):
    with whole((params, "embed")):
        x = embed_apply(params.embed, tokens)
    x = x.to(torch_dtype(cfg.compute_dtype))
    if cfg.pos == "abs":
        x = x + sinusoid(positions, cfg.d_model).to(x.dtype)
    return x


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encoder_forward(params: LM, cfg, frames):
    """Whisper's encoder over stub-frontend frame embeddings (B, T, d)."""
    x = frames.to(torch_dtype(cfg.compute_dtype))
    pos = _positions(frames.shape[0], frames.shape[1], frames.device)
    x = x + sinusoid(pos, cfg.d_model).to(x.dtype)
    # the reference remats the encoder by cfg.remat whatever lm_forward's
    def body(x, p_l):
        with whole(p_l):
            return self_block_fwd(p_l, cfg, x, pos, causal=False, window=0)

    body = _remat(body, cfg.remat)
    for p_l in params.enc_blocks:
        x, _ = body(x, p_l)
    with whole(params.enc_norm):
        return norm_apply(params.enc_norm, cfg, x)


def _logits(params: LM, cfg, x):
    w = (params, "embed") if cfg.tie_embeddings else (params, "head")
    with whole(params.final_norm, w):
        x = norm_apply(params.final_norm, cfg, x)
        return unembed_apply(params.head, params.embed, cfg, x)


def lm_forward(params: LM, cfg, tokens, *, frontend=None,
               remat: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V) float32, aux loss:
    the MoE layers' load-balancing losses summed, else 0). ``remat``
    (default ``cfg.remat``) rematerializes each scanned step in the
    backward; it changes no value."""
    remat = cfg.remat if remat is None else remat
    tokens = _as_tokens(params, tokens)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed_tokens(params, cfg, tokens, positions)
    aux = torch.zeros((), device=x.device)
    fam = cfg.family
    if fam in ("dense", "moe"):
        def layer(x, p_l):
            with whole(p_l):
                return self_block_fwd(p_l, cfg, x, positions)

        layer = _remat(layer, remat)
        for _, blocks in _self_stacks(params, cfg):
            for p_l in blocks:
                x, a = layer(x, p_l)
                aux = aux + a
    elif fam == "vlm":
        kv_src = _frontend(params, cfg, frontend).to(x.dtype)

        def superblock(x, selfs, cross):
            a_sum = torch.zeros((), device=x.device)
            with whole(*selfs, cross):
                for p_i in selfs:
                    x, a = self_block_fwd(p_i, cfg, x, positions)
                    a_sum = a_sum + a
                x, a = cross_block_fwd(cross, cfg, x, kv_src)
            return x, a_sum + a

        superblock = _remat(superblock, remat)
        for _, selfs, cross in _superblocks(params, cfg):
            x, a = superblock(x, selfs, cross)
            aux = aux + a
    elif fam == "audio":
        enc = encoder_forward(params, cfg, _frontend(params, cfg, frontend))

        def decoder_layer(x, p_l, cross):
            with whole(p_l, cross):
                x, a = self_block_fwd(p_l, cfg, x, positions)
                x, a2 = cross_block_fwd(cross, cfg, x, enc)
            return x, a + a2

        decoder_layer = _remat(decoder_layer, remat)
        for p_l, cross in zip(params.blocks, params.cross_blocks):
            x, a = decoder_layer(x, p_l, cross)
            aux = aux + a
    elif fam == "hybrid":
        def group(x, layers, shared):
            with whole(*layers, shared):
                for p_i in layers:
                    x, _ = mamba_layer(p_i, cfg, x)
                return self_block_fwd(shared, cfg, x, positions)

        group = _remat(group, remat)
        for _, layers, shared in _hybrid_groups(params, cfg):
            x, a = group(x, layers, shared)
            aux = aux + a
    else:   # ssm: a Python loop the reference does not remat
        for p_l in params.blocks:
            with whole(p_l):
                x, _ = xlstm_layer(p_l, cfg, x)
    return _logits(params, cfg, x), aux


# ----------------------------------------------------------- caches
def _layer(stack: Dict[str, torch.Tensor], *idx) -> Dict[str, torch.Tensor]:
    """One layer's views into a stacked cache ({'k', 'v'} or an SSM
    state's {'conv', 'ssd'})."""
    return {key: buf[idx] for key, buf in stack.items()}


def _write_state(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    """A recurrent layer's new state into its cache buffers, in place."""
    for key, buf in dst.items():
        buf.copy_(src[key])


def init_cache(cfg, batch: int, max_len: int, *,
               n_frontend: Optional[int] = None,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """An (empty) cache with exactly the structure ``lm_prefill`` returns,
    the reference's: ``t`` (B,) int32; ``layers`` {'k', 'v'} of
    (L, B, width, KV, hd), the VLM's (n_super, per, B, width, KV, hd),
    the MoE family's ``dense_layers`` for its leading dense layers
    beside it, the hybrid's for its n_groups shared-block applications;
    ``cross`` (vlm, audio) of (n_cross, B, n_frontend, KV, hd); the
    hybrid's float32 ``ssm`` {'conv', 'ssd'} of (n_groups, per, B, ...);
    xLSTM's ``xlstm``, a list of each layer's float32 state. width is
    min(max_len, window) for sliding-window archs, else max_len;
    n_frontend defaults to ``cfg.n_frontend_tokens``."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.compute_dtype)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    width = attn.cache_width(cfg, max_len)
    n_fe = cfg.n_frontend_tokens if n_frontend is None else n_frontend
    cache: Dict[str, Any] = {
        "t": torch.zeros(batch, dtype=torch.int32, device=dev)}

    def stack(lead, length):
        shp = tuple(lead) + (batch, length, kv, hd)
        return {"k": torch.zeros(shp, dtype=dt, device=dev),
                "v": torch.zeros(shp, dtype=dt, device=dev)}

    fam = cfg.family
    if fam in ("dense", "moe"):
        nd = cfg.first_k_dense if fam == "moe" else 0
        if nd:
            cache["dense_layers"] = stack((nd,), width)
        cache["layers"] = stack((cfg.n_layers - nd,), width)
    elif fam == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        cache["layers"] = stack((n_super, cfg.cross_attn_every - 1), width)
        cache["cross"] = stack((n_super,), n_fe)
    elif fam == "audio":
        cache["layers"] = stack((cfg.n_layers,), width)
        cache["cross"] = stack((cfg.n_layers,), n_fe)
    elif fam == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        cache["ssm"] = {
            key: buf.new_zeros((n_groups, cfg.attn_every) + buf.shape)
            for key, buf in mamba2.init_ssm_state(cfg, batch,
                                                  device=dev).items()}
        cache["layers"] = stack((n_groups,), width)
    else:   # ssm
        cache["xlstm"] = [
            (xlstm.init_slstm_state if i in cfg.slstm_at
             else xlstm.init_mlstm_state)(cfg, batch, device=dev)
            for i in range(cfg.n_layers)]
    return cache


# ----------------------------------------------------------- prefill
@torch.no_grad()
def lm_prefill(params: LM, cfg, tokens, *, frontend=None, max_len: int
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward pass that fills the caches. Returns (last-token logits
    (B, 1, V) float32, cache)."""
    tokens = _as_tokens(params, tokens)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = _embed_tokens(params, cfg, tokens, positions)
    src = None
    if cfg.family == "vlm":
        src = _frontend(params, cfg, frontend).to(x.dtype)
    elif cfg.family == "audio":
        src = encoder_forward(params, cfg, _frontend(params, cfg, frontend))
    cache = init_cache(cfg, b, max_len, device=x.device,
                       n_frontend=None if src is None else src.shape[1])
    cache["t"].fill_(s)

    def self_layer(p_l, x, key, *idx):
        x, _, (k, v) = self_block_fwd(p_l, cfg, x, positions, return_kv=True)
        attn.cache_write_prefill(_layer(cache[key], *idx), k, v)
        return x

    def cross_layer(p_c, x, i):
        ckv = cross_block_kv(p_c, cfg, src)
        cache["cross"]["k"][i] = ckv["k"]
        cache["cross"]["v"][i] = ckv["v"]
        return cross_block_core(p_c, cfg, x, ckv["k"], ckv["v"])[0]

    fam = cfg.family
    if fam in ("dense", "moe"):
        for key, blocks in _self_stacks(params, cfg):
            for i, p_l in enumerate(blocks):
                x = self_layer(p_l, x, key, i)
    elif fam == "vlm":
        for si, selfs, cross in _superblocks(params, cfg):
            for i, p_i in enumerate(selfs):
                x = self_layer(p_i, x, "layers", si, i)
            x = cross_layer(cross, x, si)
    elif fam == "audio":
        for i, (p_l, cross) in enumerate(zip(params.blocks,
                                             params.cross_blocks)):
            x = cross_layer(cross, self_layer(p_l, x, "layers", i), i)
    elif fam == "hybrid":
        for g, layers, shared in _hybrid_groups(params, cfg):
            for i, p_i in enumerate(layers):
                st_i = _layer(cache["ssm"], g, i)
                x, st = mamba_layer(p_i, cfg, x, state=st_i)
                _write_state(st_i, st)
            x = self_layer(shared, x, "layers", g)
    else:   # ssm
        for p_l, st_l in zip(params.blocks, cache["xlstm"]):
            x, st = xlstm_layer(p_l, cfg, x, state=st_l)
            _write_state(st_l, st)
    return _logits(params, cfg, x[:, -1:]), cache


# -------------------------------------------------------------- decode
@torch.no_grad()
def lm_decode_step(params: LM, cfg, token, cache
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serve step: token (B, 1) -> (logits (B, 1, V) float32, cache).
    The new token's k/v and the recurrent layers' new states go into the
    cache's buffers in place; the returned cache holds the same buffers
    and ``t + 1``."""
    token = _as_tokens(params, token)
    t = cache["t"]
    x = _embed_tokens(params, cfg, token, t.reshape(-1, 1))

    def self_layer(p_l, x, key, *idx):
        return self_block_decode(p_l, cfg, x, _layer(cache[key], *idx), t)[0]

    def cross_layer(p_c, x, i):
        return cross_block_core(p_c, cfg, x, cache["cross"]["k"][i],
                                cache["cross"]["v"][i])[0]

    fam = cfg.family
    if fam in ("dense", "moe"):
        for key, blocks in _self_stacks(params, cfg):
            for i, p_l in enumerate(blocks):
                x = self_layer(p_l, x, key, i)
    elif fam == "vlm":
        for si, selfs, cross in _superblocks(params, cfg):
            for i, p_i in enumerate(selfs):
                x = self_layer(p_i, x, "layers", si, i)
            x = cross_layer(cross, x, si)
    elif fam == "audio":
        for i, (p_l, cross) in enumerate(zip(params.blocks,
                                             params.cross_blocks)):
            x = cross_layer(cross, self_layer(p_l, x, "layers", i), i)
    elif fam == "hybrid":
        for g, layers, shared in _hybrid_groups(params, cfg):
            for i, p_i in enumerate(layers):
                st_i = _layer(cache["ssm"], g, i)
                x, st = mamba_layer(p_i, cfg, x, state=st_i, decode=True)
                _write_state(st_i, st)
            x = self_layer(shared, x, "layers", g)
    else:   # ssm
        for p_l, st_l in zip(params.blocks, cache["xlstm"]):
            x, st = xlstm_layer(p_l, cfg, x, state=st_l, decode=True)
            _write_state(st_l, st)
    return _logits(params, cfg, x), {**cache, "t": t + 1}
