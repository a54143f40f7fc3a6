"""ChatGLM3-6B — dense GQA decoder with 2d (partial) RoPE. [arXiv:2406.12793; hf]

ChatGLM applies rotary embeddings to half of each head's dimensions
(`rotary_pct=0.5`, the "RoPE 2d" scheme) and uses QKV bias.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793; hf",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rotary_pct=0.5,
    subquadratic=False,
    notes="full attention -> long_500k skipped",
))
