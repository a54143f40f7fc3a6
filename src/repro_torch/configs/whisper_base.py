"""Whisper-base — encoder-decoder audio backbone. [arXiv:2212.04356; unverified]

The conv frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (batch, 1500, d_model) for the encoder. 6L encoder + 6L decoder,
MHA (kv=8), GELU, learned absolute positions. Decode shapes exercise the
decoder with self+cross KV caches.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356; unverified",
    n_layers=6,
    encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    pos="abs",
    n_frontend_tokens=1500,   # 30 s of audio after the conv stem
    param_dtype="float32",
    sharding_policy="fsdp",
    compute_dtype="bfloat16",
    subquadratic=False,
    notes="enc-dec; full attention -> long_500k skipped",
))
