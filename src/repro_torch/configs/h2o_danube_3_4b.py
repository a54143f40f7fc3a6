"""H2O-Danube-3-4B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]. window=4096 (mistral-style SWA) makes it
sub-quadratic, so long_500k runs for this arch.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818; unverified",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,            # 3840/32; non-128 head dim (MXU pads to 128)
    d_ff=10240,
    vocab_size=32000,
    window=4096,
    subquadratic=True,
))
