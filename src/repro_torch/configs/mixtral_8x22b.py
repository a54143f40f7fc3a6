"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf]. SWA window 4096 -> sub-quadratic, long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088; hf",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,               # == expert width (no dense layers)
    d_ff_expert=16384,
    n_experts=8,
    experts_per_token=2,
    vocab_size=32768,
    window=4096,
    rope_theta=1000000.0,
    optimizer="adafactor",
    remat="full",
    microbatches=4,
    subquadratic=True,
))
