"""Zamba2-2.7B — hybrid Mamba2 trunk with shared attention blocks.
[arXiv:2411.15242; hf]. 54 Mamba2 layers; after every 6th layer one of two
*weight-shared* attention+MLP blocks (alternating) is applied. Attention is
MHA (kv=32). Constant-size SSM state -> sub-quadratic, long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242; hf",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,               # MLP inside the shared attention block
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=6,             # shared block after every 6 mamba layers
    n_shared_blocks=2,
    subquadratic=True,
))
