"""repro_torch.configs — environment switches (``flags``), the
architecture and shape configuration (``base``) and the ported
architectures: ``get_config(arch_id)`` resolves ``mamba2-2.7b`` (the SSM
family) and ``qwen3-14b`` (the dense family); the other families wait for
ROADMAP A10."""
from .base import SHAPES, ArchConfig, ShapeSpec
from . import mamba2_2_7b, qwen3_14b

CONFIGS = {c.arch_id: c for c in (mamba2_2_7b.CONFIG, qwen3_14b.CONFIG)}
ARCH_IDS = tuple(CONFIGS)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in CONFIGS:
        raise KeyError(f"arch {arch_id!r} is not ported yet: the port runs "
                       f"the ssm and dense families ({', '.join(ARCH_IDS)}); "
                       "the other families wait for ROADMAP A10")
    return CONFIGS[arch_id]


__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "CONFIGS", "ARCH_IDS",
           "get_config"]
