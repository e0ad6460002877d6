"""PyTorch/CUDA port of the DPMR system, for NVIDIA H100s.

The JAX package `repro` is the reference; this package mirrors it module
for module and never imports it. What it covers today:

- the sparse face's trainer, on one rank or on P ranks of a
  `torch.distributed` mesh (`launch.mesh`, `launch.train --sparse`):
  `DPMREngine.fit_sgd`, `fit`, `predict`, `evaluate`, `save` and
  `restore` on the `a2a`, `allgather`, `psum_scatter`,
  `compressed_reduce`, `topk_reduce`, `overlap_a2a`, `hier_a2a`,
  `hier_a2a+topk` and `hier_a2a+int8` strategies, or `auto` (the
  wire-cost autotuner, `api.autotune`);
- its data plane (`data`): the `zipf_sparse`, `lm_markov` and
  `file_sparse` sources, host shard ownership, and the prefetching,
  resumable `ShardedLoader`; checkpoints (`ckpt.checkpointer`) with the
  elastic re-pad (`runtime.elastic`);
- sparse serving (`serve`): `DPMRServeEngine` over a resident state,
  with the micro-batcher and the Zipf-head cache, at one rank or at P
  (rank 0 the front, the others followers), and `launch.serve --sparse`;
- the dense face's serving path: prefill and greedy decode of every
  model family of the reference: dense and vlm (yi-6b, granite-8b,
  granite-34b, llama3-405b, chameleon-34b), MoE (phi3.5-moe, mixtral),
  the zamba2 hybrid, xlstm and the whisper encoder-decoder
  (`models.registry`, `train.serve.greedy_decode`, `launch.serve`);
- the dense trainer (`train.trainer`, `launch.train --arch`): the
  training forward under autograd and remat, the dense optimizers,
  microbatches and clipping, checkpoints in the reference's tree, and
  fault tolerance (`runtime.fault_tolerance`), on one card or over a
  mesh of ranks (`sharding`, `core.fsdp`, `models.parallel`: FSDP over
  `data`, tensor and context parallelism over `model`, compressed
  gradients across `pod`), and GPipe over a `pipe` dim
  (`train.pipeline`).

The map body (`sigmoid_grad`), the sorted reduces (`segment_sum_sorted`),
topk_reduce's selection (`select_pack`) and prefill's attention
(`flash_attention`) are hand-written CUDA kernels for `sm_90a`
(`kernels/csrc/`), built with `nvcc` at first use.

    from repro_torch import DPMRConfig, DPMREngine, get_source
    from repro_torch import get_spec, greedy_decode, init_params
    from repro_torch import DPMRServeEngine, BatchingConfig, HotCacheConfig
"""
from repro_torch.api.engine import DPMREngine
from repro_torch.configs.base import DPMRConfig, ModelConfig
from repro_torch.core.dpmr import DPMRState, make_step_fns
from repro_torch.data import get_source
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_spec, smoke_config
from repro_torch.serve import BatchingConfig, DPMRServeEngine, HotCacheConfig
from repro_torch.train.serve import greedy_decode

__all__ = ["BatchingConfig", "DPMRConfig", "DPMREngine", "DPMRServeEngine",
           "DPMRState", "HotCacheConfig", "ModelConfig", "get_source",
           "get_spec", "greedy_decode", "init_params", "make_step_fns",
           "smoke_config"]
