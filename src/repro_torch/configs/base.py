"""Architecture configuration system.

Every assigned architecture is a frozen ``ArchConfig`` registered under its
public id (``--arch <id>``). ``ArchConfig.reduced()`` returns a small config
of the same *family* (same block pattern, same attention/MoE/SSM kinds) used
by the CPU tests; ``chip_smoke.py`` serves the full configs on the card.
The port's copy of ``repro.configs.base``: the same fields and counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity ---------------------------------------------------------------
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    source: str = ""                 # provenance note ([hf:...; tier])

    # trunk ------------------------------------------------------------------
    n_layers: int = 0                # decoder layers
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 0                    # dense-FFN hidden size (0 -> no FFN, e.g. xLSTM)
    vocab_size: int = 0
    act: str = "silu"                # silu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention --------------------------------------------------------------
    qkv_bias: bool = False
    pos: str = "rope"                # rope | abs (learned absolute)
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # chatglm 2d-RoPE -> 0.5 (rotary on half dims)
    window: int = 0                  # sliding-window size; 0 = full attention

    # enc-dec / cross-attention (audio, vlm) ----------------------------------
    encoder_layers: int = 0          # >0 -> encoder-decoder (whisper)
    cross_attn_every: int = 0        # vlm: every Nth decoder layer is cross-attn
    n_frontend_tokens: int = 0       # stub-frontend sequence length
    d_frontend: int = 0              # stub-frontend embedding dim (0 -> d_model)

    # MoE ----------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0           # leading dense layers before MoE layers
    router_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25

    # SSM / hybrid -------------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0              # hybrid: shared attention block every Nth layer
    n_shared_blocks: int = 2         # zamba2 alternates between 2 shared blocks
    slstm_at: Tuple[int, ...] = ()   # xLSTM: layer indices that use sLSTM cells

    # numerics / optimizer hints ------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor
    sharding_policy: str = "2d"      # 2d (FSDP x TP) | fsdp (pure DP/FSDP)
    remat: str = "selective"         # none | selective | full
    microbatches: int = 1            # gradient-accumulation splits for train_4k

    # capability flags ------------------------------------------------------------
    subquadratic: bool = False       # eligible for long_500k
    notes: str = ""

    # ---------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        attn = d * n_q + 2 * d * n_kv + n_q * d  # wq, wk, wv, wo

        def ffn(width: int) -> int:
            return 3 * d * width  # gated (gate, up, down)

        for layer in range(self.n_layers):
            if self.family in ("ssm", "hybrid") and not self._is_attn_layer(layer):
                if self.slstm_at and layer in self.slstm_at:
                    total += 6 * d * d  # sLSTM-ish projections
                elif self.family == "ssm":
                    total += int(4.5 * d * d)  # mLSTM block approx
                else:
                    d_in = self.ssm_expand * d
                    total += 2 * d * d_in + d_in * d  # mamba2 in/out proj approx
                continue
            total += attn
            if self.is_moe and layer >= self.first_k_dense:
                total += self.n_experts * ffn(self.d_ff_expert) + \
                    self.n_shared_experts * ffn(self.d_ff_expert) + d * self.n_experts
            elif self.d_ff:
                total += ffn(self.d_ff)
        if self.encoder_layers:
            total += self.encoder_layers * (attn + ffn(self.d_ff))
            total += self.n_layers * attn  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_exp = (self.n_layers - self.first_k_dense) * self.n_experts * 3 * d * self.d_ff_expert
        act_exp = (self.n_layers - self.first_k_dense) * self.experts_per_token * 3 * d * self.d_ff_expert
        return full - all_exp + act_exp

    def _is_attn_layer(self, layer: int) -> bool:
        if self.family == "hybrid":
            return self.attn_every > 0 and (layer + 1) % self.attn_every == 0
        if self.family == "ssm":
            return False
        return True

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            param_dtype="float32",
            compute_dtype="float32",
            microbatches=1,
            remat="none",
        )
        if self.is_moe:
            changes.update(n_experts=4, experts_per_token=2, d_ff_expert=64,
                           n_shared_experts=min(self.n_shared_experts, 1),
                           first_k_dense=min(self.first_k_dense, 1),
                           moe_capacity_factor=8.0)  # drop-free smoke tests
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_head_dim=16)
        if self.encoder_layers:
            changes.update(encoder_layers=2)
        if self.n_frontend_tokens:
            changes.update(n_frontend_tokens=8, d_frontend=0)
        if self.cross_attn_every:
            changes.update(cross_attn_every=2)
        if self.attn_every:
            changes.update(attn_every=2, n_layers=4)
        if self.slstm_at:
            changes.update(slstm_at=(1,), n_layers=min(self.n_layers, 4))
        if self.window:
            changes.update(window=8)
        return dataclasses.replace(self, **changes)


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config: {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # import side-effect registration
    from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)
