"""Arch-id -> config registry of the port (counterpart of `repro.configs`).

Architecture ids use the reference's spelling (dashes/dots); module names
use underscores. The port serves and trains all ten of the reference's
architectures: the `dense`, `vlm` and `moe` families (mixtral with its
sliding window), zamba2 (`hybrid`), xlstm (`ssm`) and whisper
(`encdec`).
"""
from repro_torch.configs.base import (
    SHAPES,
    DPMRConfig,
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
)

_ARCH_MODULES = {
    "granite-8b": "granite_8b",
    "yi-6b": "yi_6b",
    "llama3-405b": "llama3_405b",
    "granite-34b": "granite_34b",
    "chameleon-34b": "chameleon_34b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "mixtral-8x22b": "mixtral_8x22b",
    "zamba2-2.7b": "zamba2_2p7b",
    "xlstm-125m": "xlstm_125m",
    "whisper-small": "whisper_small",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    import importlib

    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "SHAPES", "DPMRConfig", "ModelConfig",
           "ParallelConfig", "ShapeConfig", "TrainConfig", "get_config"]
