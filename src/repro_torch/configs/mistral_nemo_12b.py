"""Mistral-Nemo-12B — dense GQA decoder, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]. head_dim is 128 (not d_model/H=160).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407; hf",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    # tuned in EXPERIMENTS.md §Perf: mb=8 + full remat takes the train_4k
    # cell from 72.8 GiB/chip (doesn't fit) to 11.0 GiB (fits v5e HBM)
    # and the roofline fraction from 0.022 to 0.034
    microbatches=8,
    remat="full",
    subquadratic=False,
    notes="full attention -> long_500k skipped",
))
