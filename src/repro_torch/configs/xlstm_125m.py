"""xLSTM-125M — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

12 layers, d_model=768, 4 heads. d_ff=0: xLSTM blocks carry their own
up/down projections (mLSTM: pre-up-projection x2; sLSTM: post-up FFN).
sLSTM cells at layers {1, 7} (xLSTM[1:1]-style placement); the rest are
mLSTM. Constant-size recurrent state -> sub-quadratic, long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517; unverified",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    slstm_at=(1, 7),
    param_dtype="float32",
    sharding_policy="fsdp",
    compute_dtype="bfloat16",
    subquadratic=True,
))
