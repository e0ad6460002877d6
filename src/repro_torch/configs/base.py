"""Configuration dataclass of the DPMR sparse face (PyTorch port).

The counterpart of `repro.configs.base.DPMRConfig`: the same frozen
dataclass, with the same defaults for every field it has. It holds only
the fields the port reads: the reference's `kernel_impl` (its lowering
knob; the port dispatches by the tensor's device) and `seed` come back
with the code that reads them, so passing one is an error rather than
silently ignored. The reference
module's TPU hardware constants are deliberately not carried over; the
port's speed figures come from runs on the card (see PERF.md).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DPMRConfig:
    """Paper-faithful sparse-face configuration (logistic regression)."""

    num_features: int = 1 << 20      # hashed feature space
    max_features_per_sample: int = 64
    hot_threshold: float = 0.001     # features with freq above this are replicated
    max_hot: int = 512               # cap on replicated hot features
    learning_rate: float = 0.5
    iterations: int = 4
    distribution: str = "a2a"        # name in the repro_torch.api strategy
    #                                  registry (a2a | allgather |
    #                                  psum_scatter | compressed_reduce |
    #                                  topk_reduce | user-registered); the
    #                                  multi-rank ones are ROADMAP queue A
    topk_frac: float = 0.25          # topk_reduce: fraction of the per-
    #                                  destination capacity slots whose
    #                                  largest-|g| gradients go on the wire
    #                                  (k = ceil(topk_frac * cap)); the rest
    #                                  feed the error-feedback residual.
    #                                  1.0 degenerates to the full shuffle.
    grad_scale: str = "mean"         # mean | sum (paper: sum, full-batch GD)
    optimizer: str = "sgd"           # any name in optim.SPARSE_OPTIMIZERS
    adagrad_eps: float = 1e-6
    momentum: float = 0.9            # sparse momentum optimizer coefficient
    schedule: str = "constant"       # any name in optim.schedules.SCHEDULES
    warmup_steps: int = 0            # schedule parameters (warmup_cosine)
    total_steps: int = 0
