"""Llama-3.2-Vision-11B — text trunk with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. The vision encoder is a
STUB frontend: ``input_specs()`` provides precomputed patch embeddings of
shape (batch, n_frontend_tokens, d_model); every 5th decoder layer
cross-attends to them (8 cross-attn layers out of 40, as in the HF config).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    n_frontend_tokens=1601,     # one 448px tile of 14px patches + class token
    optimizer="adamw",
    remat="selective",
    microbatches=2,
    subquadratic=False,
    notes="full attention -> long_500k skipped",
))
