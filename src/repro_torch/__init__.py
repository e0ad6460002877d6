"""PyTorch/CUDA port of the DPMR sparse engine, for one NVIDIA H100.

The JAX package `repro` is the reference; this package mirrors it module
for module and never imports it. What it covers today is the single-card
trainer: `DPMREngine.fit_sgd`, `fit`, `predict` and `evaluate` on the
`a2a`, `allgather`, `psum_scatter`, `compressed_reduce` and `topk_reduce`
strategies. The map body (`sigmoid_grad`), the sorted reduces
(`segment_sum_sorted`) and topk_reduce's selection (`select_pack`) are
hand-written CUDA kernels for `sm_90a` (`kernels/csrc/`), built with
`nvcc` at first use.

    from repro_torch import DPMRConfig, DPMREngine, get_source
"""
from repro_torch.api.engine import DPMREngine
from repro_torch.configs.base import DPMRConfig
from repro_torch.core.dpmr import DPMRState, make_step_fns
from repro_torch.data import get_source

__all__ = ["DPMRConfig", "DPMREngine", "DPMRState", "get_source",
           "make_step_fns"]
