"""PyTorch/CUDA port of the DPMR sparse engine, for one NVIDIA H100.

The JAX package `repro` is the reference; this package mirrors it module
for module and never imports it. What it covers today is the single-card
trainer: `DPMREngine.fit_sgd`, `fit`, `predict` and `evaluate` on the
`a2a` strategy, whose map body (`sigmoid_grad`) and owner reduce
(`segment_sum_sorted`) are hand-written CUDA kernels for `sm_90a`
(`kernels/csrc/`), built with `nvcc` at first use.

    from repro_torch import DPMRConfig, DPMREngine, get_source
"""
from repro_torch.api.engine import DPMREngine
from repro_torch.configs.base import DPMRConfig
from repro_torch.core.dpmr import DPMRState, make_step_fns
from repro_torch.data import get_source

__all__ = ["DPMRConfig", "DPMREngine", "DPMRState", "get_source",
           "make_step_fns"]
