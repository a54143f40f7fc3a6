"""Config registry: importing this package registers every assigned arch.

The port's own copy of ``repro.configs`` (the port imports nothing of the
JAX package): the same ten architectures, fields and ``reduced()``, so a
test can build both packages' models from one name. The SOCCER presets
live beside them in ``soccer_paper.py``.
"""
from repro_torch.configs.base import ArchConfig, get_config, list_archs, register  # noqa: F401
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_is_applicable, get_shape  # noqa: F401

# side-effect registration of the assigned architectures -----------------------
from repro_torch.configs import (  # noqa: F401
    llama_3_2_vision_11b,
    qwen2_1_5b,
    chatglm3_6b,
    mistral_nemo_12b,
    h2o_danube_3_4b,
    whisper_base,
    zamba2_2_7b,
    kimi_k2_1t_a32b,
    mixtral_8x22b,
    xlstm_125m,
)

ASSIGNED_ARCHS = (
    "llama-3.2-vision-11b",
    "qwen2-1.5b",
    "chatglm3-6b",
    "mistral-nemo-12b",
    "h2o-danube-3-4b",
    "whisper-base",
    "zamba2-2.7b",
    "kimi-k2-1t-a32b",
    "mixtral-8x22b",
    "xlstm-125m",
)
