"""PyTorch/CUDA port of the DPMR system, for one NVIDIA H100.

The JAX package `repro` is the reference; this package mirrors it module
for module and never imports it. What it covers today:

- the sparse face's single-card trainer: `DPMREngine.fit_sgd`, `fit`,
  `predict` and `evaluate` on the `a2a`, `allgather`, `psum_scatter`,
  `compressed_reduce` and `topk_reduce` strategies;
- the dense face's serving path: prefill and greedy decode of the dense
  and vlm models (yi-6b, granite-8b, granite-34b, llama3-405b,
  chameleon-34b; `models.registry`, `train.serve.greedy_decode`,
  `launch.serve`).

The map body (`sigmoid_grad`), the sorted reduces (`segment_sum_sorted`),
topk_reduce's selection (`select_pack`) and prefill's attention
(`flash_attention`) are hand-written CUDA kernels for `sm_90a`
(`kernels/csrc/`), built with `nvcc` at first use.

    from repro_torch import DPMRConfig, DPMREngine, get_source
    from repro_torch import get_spec, greedy_decode, init_params
"""
from repro_torch.api.engine import DPMREngine
from repro_torch.configs.base import DPMRConfig, ModelConfig
from repro_torch.core.dpmr import DPMRState, make_step_fns
from repro_torch.data import get_source
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_spec, smoke_config
from repro_torch.train.serve import greedy_decode

__all__ = ["DPMRConfig", "DPMREngine", "DPMRState", "ModelConfig",
           "get_source", "get_spec", "greedy_decode", "init_params",
           "make_step_fns", "smoke_config"]
