"""Kimi-K2 1T-A32B — trillion-parameter MoE (paper-table config).
[arXiv:2501.kimi2; unverified]. 61 layers, 384 experts top-8 + 1 shared
expert, expert d_ff=2048, first layer dense (d_ff=18432). The assigned
table specifies GQA kv=8 (we follow the table, not MLA). Adafactor keeps
optimizer state sub-linear so the 1T model fits the multi-pod mesh.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2; unverified",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,               # the single leading dense layer
    d_ff_expert=2048,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    first_k_dense=1,
    vocab_size=163840,
    rope_theta=50000.0,
    optimizer="adafactor",
    remat="full",
    microbatches=8,
    subquadratic=False,
    notes="full attention -> long_500k skipped; 1T total / ~32B active params",
))
