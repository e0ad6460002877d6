from repro_torch.configs.base import DPMRConfig

__all__ = ["DPMRConfig"]
