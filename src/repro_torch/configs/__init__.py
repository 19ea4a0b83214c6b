"""Config registry: ``get_config(arch_id)`` / ``--arch <id>`` support.

The port's own copy of the reference's ``repro/configs`` (no import of
``repro``): the same ``ModelConfig``, registry and ``ARCH_IDS``, so
``get_config`` answers for every id the JAX package knows.  ``get_config`` also resolves
the port's own published configurations (:data:`PUBLISHED`: models at
their published settings in a family the JAX package does not have), kept
apart from ``REGISTRY`` and ``ARCH_IDS``, which stay the reference's."""
from .base import ModelConfig, reduce_for_smoke
from .pixtral_12b import CONFIG as PIXTRAL_12B
from .qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A2_7B
from .stablelm_12b import CONFIG as STABLELM_12B
from .qwen2_72b import CONFIG as QWEN2_72B
from .yi_9b import CONFIG as YI_9B
from .seamless_m4t_medium import CONFIG as SEAMLESS_M4T_MEDIUM
from .starcoder2_15b import CONFIG as STARCODER2_15B
from .arctic_480b import CONFIG as ARCTIC_480B
from .zamba2_1_2b import CONFIG as ZAMBA2_1_2B
from .mamba2_130m import CONFIG as MAMBA2_130M
from .paper_zoo import PAPER_ZOO, SQUEEZE_LM, MID_LM, GOOGLE_LM
from .zamba2 import Zamba2Config
from .zamba2_7b import CONFIG as ZAMBA2_7B

REGISTRY = {
    c.arch_id: c
    for c in (
        PIXTRAL_12B,
        QWEN2_MOE_A2_7B,
        STABLELM_12B,
        QWEN2_72B,
        YI_9B,
        SEAMLESS_M4T_MEDIUM,
        STARCODER2_15B,
        ARCTIC_480B,
        ZAMBA2_1_2B,
        MAMBA2_130M,
    )
}
REGISTRY.update(PAPER_ZOO)

ARCH_IDS = [
    "pixtral-12b",
    "qwen2-moe-a2.7b",
    "stablelm-12b",
    "qwen2-72b",
    "yi-9b",
    "seamless-m4t-medium",
    "starcoder2-15b",
    "arctic-480b",
    "zamba2-1.2b",
    "mamba2-130m",
]


#: the port's own configurations: published models in a family that only the
#: port has, each at its published settings
PUBLISHED = {c.arch_id: c for c in (ZAMBA2_7B,)}


def get_config(arch_id: str) -> ModelConfig:
    """The configuration ``arch_id`` of :data:`REGISTRY` or :data:`PUBLISHED`."""
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in PUBLISHED:
        return PUBLISHED[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY) + sorted(PUBLISHED)}")


__all__ = ["ModelConfig", "Zamba2Config", "reduce_for_smoke", "get_config", "REGISTRY",
           "PUBLISHED", "ARCH_IDS", "PAPER_ZOO"]
