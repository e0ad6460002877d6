"""Configuration dataclasses of the PyTorch port.

`DPMRConfig` is the counterpart of `repro.configs.base.DPMRConfig` (the
sparse face): the same frozen dataclass, with the same defaults for every
field it has. It holds only the fields the port reads: the reference's
`kernel_impl` (its lowering knob; the port dispatches by the tensor's
device) and `seed` come back with the code that reads them, so passing
one is an error rather than silently ignored.

`ModelConfig` is the counterpart of `repro.configs.base.ModelConfig` (the
dense face), with all of its fields, defaults and parameter counts; the
port serves and trains every family of the reference: `dense`, `vlm`,
`moe` (experts, a sliding window), `hybrid` (zamba2), `ssm` (xlstm) and
`encdec` (whisper).

`ShapeConfig` and `SHAPES` are the reference's input-shape cells, which
`launch.dryrun` sweeps. `ParallelConfig` and `TrainConfig` are copies of the reference's, field
for field. The trainer reads `remat`, `microbatches` and `accum_dtype`;
over a mesh also `attn_mode` ("cp": context-parallel attention over
`model`) and `compress_pod_grads` (int8 gradients across `pod`), each
the reference's no-op without that mesh dim; `seq_shard` is a layout
that does not change the numbers (the port's tensor-parallel stream is
always S-sharded), and `scan_layers` has no meaning for the port's loop
over layers. `sparse_embed` is read by neither package's trainer.

The reference module's TPU hardware constants are deliberately not
carried over. In their place stand the data-sheet figures of the card
the port runs on, an NVIDIA H100 SXM, in one place: `chip_smoke.py`'s
bounds read the memory rate and the peak rates, `api/autotune.py`'s
wire model the link speeds, and `launch/dryrun.py` the memory size. The port's measured speeds come from runs on
the card (see PERF.md).
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM, from NVIDIA's data sheet
H100_HBM_BYTES_PER_S = 3.35e12    # HBM3
H100_F32_FLOPS = 67e12            # f32 outside the tensor cores
H100_BF16_TC_FLOPS = 989e12       # bf16 tensor cores, dense
H100_NVLINK_GBPS = 450.0          # NVLink 4 inside a host, one way a card
H100_NDR_GBPS = 50.0              # one 400 Gb/s NDR port a card, between
#                                   hosts
H100_HBM_BYTES = 80 * 10 ** 9     # 80 GB of HBM3


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
    #                                  topk_reduce | overlap_a2a |
    #                                  hier_a2a | user-registered), or
    #                                  "auto": the wire-cost autotuner
    #                                  (api/autotune.py) picks one
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


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (one instance per arch)."""

    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # Attention
    sliding_window: int = 0         # 0 = full attention (Mixtral uses SWA)
    qk_norm: bool = False           # chameleon-style qk layernorm

    # SSM / hybrid (zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0              # 0 -> num_heads
    ssm_expand: int = 2
    attn_every: int = 0             # hybrid: shared attention block every N layers

    # xLSTM
    slstm_every: int = 0            # every Nth block is sLSTM (rest mLSTM)

    # Encoder-decoder (whisper)
    encoder_layers: int = 0

    # MLP flavour
    mlp_type: str = "swiglu"        # swiglu (3 mats) | gelu (2 mats)

    # Numerics
    dtype: str = "bfloat16"         # activation dtype
    param_dtype: str = "float32"    # master parameter dtype
    opt_dtype: str = "float32"      # optimizer moment dtype
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # Modality frontend stub: if True, input_specs() provides precomputed
    # frame/patch embeddings instead of token ids for the encoder side.
    frontend_stub: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qo = self.num_heads * hd
        kv = self.num_kv_heads * hd
        attn = d * qo + 2 * d * kv + qo * d
        if self.family == "ssm":                      # xLSTM-style blocks
            per_layer = _xlstm_block_params(self)
        elif self.family == "hybrid":
            per_layer = _mamba_block_params(self)
            # shared attention block amortized over layers it serves
            n_attn = self.num_layers // max(self.attn_every, 1)
            shared = attn + 3 * d * f
            return (self.num_layers * per_layer + n_attn * shared
                    + v * d * (1 if self.tie_embeddings else 2))
        else:
            mats = 3 if self.mlp_type == "swiglu" else 2
            mlp = mats * d * f
            if self.num_experts:
                mlp = self.num_experts * mats * d * f + d * self.num_experts
            per_layer = attn + mlp
        n_layers = self.num_layers + self.encoder_layers
        embed = v * d * (1 if self.tie_embeddings else 2)
        return n_layers * per_layer + embed

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mats = 3 if self.mlp_type == "swiglu" else 2
        dense_mlp = self.num_experts * mats * d * f
        active_mlp = self.experts_per_token * mats * d * f
        return self.param_count() - self.num_layers * (dense_mlp - active_mlp)


def _xlstm_block_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    # mLSTM block: up-proj 2x, qkv, gates, down-proj (approximate, matches model defs)
    return 2 * d * 2 * d + 4 * (2 * d) * (2 * d) // 4 + 2 * d * d


def _mamba_block_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    e = cfg.ssm_expand
    di = e * d
    n = cfg.ssm_state
    g = max(1, cfg.resolved_ssm_heads // 4)
    return d * 2 * di + di * d + 2 * g * n * d + di  # in/out proj + B,C proj + dt


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the dry run (the reference's)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the mesh."""

    fsdp_axis: str = "data"          # DPMR dense face: params sharded here
    tensor_axis: str = "model"       # TP / expert-parallel / feature-owner axis
    dp_axes: tuple[str, ...] = ("pod", "data")
    remat: str = "full"              # none | full | dots
    scan_layers: bool = True
    microbatches: int = 1            # grad-accumulation chunks per step
    seq_shard: bool = True           # SP: residual stream sharded over model
    accum_dtype: str = "float32"     # grad-accumulator dtype (bf16 on giants)
    attn_mode: str = "auto"          # auto (GSPMD) | cp (context-parallel:
    #                                  q sequence-sharded, kv-only gather)
    moe_group: int = 512             # MoE group-limited dispatch group size
    # DPMR sparse face for embedding tables
    sparse_embed: bool = False
    # gradient compression on the cross-pod DP axis
    compress_pod_grads: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    optimizer: str = "adamw"         # sgd | momentum | adam | adamw
    seed: int = 0
