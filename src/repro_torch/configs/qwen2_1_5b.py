"""Qwen2-1.5B — dense GQA decoder with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671; hf",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    sharding_policy="fsdp",
    subquadratic=False,
    notes="full attention -> long_500k skipped",
))
