"""Architecture registry of the port: arch id -> params, forward, prefill,
decode (counterpart of `repro.models.registry`).

Every family of the reference: `dense`, `vlm` and `moe` through
`models.transformer`, `hybrid` (zamba2) through `models.mamba`, `ssm`
(xlstm) through `models.xlstm` and `encdec` (whisper) through
`models.encdec`. A batch is a dict: `tokens` (B, S), and for `encdec`
`frames` (B, S_enc, D) too.

`batch_defs` gives the inputs of a shape cell (`configs.SHAPES`) as
`sharding.LeafDef`s, the reference's `input_specs` (`launch.dryrun`
lays them out without allocating anything); `supported_shapes` and
`skip_reason` are the reference's rule of which cells an arch runs.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, mamba, parallel, transformer, xlstm


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    cfg: ModelConfig
    model: Callable               # (cfg, device, train=False) ->
    #                               uninitialised nn.Module
    forward: Callable             # (model, batch, cfg, parallel) -> (logits,
    #                               aux)
    prefill: Callable             # (model, batch, cfg) -> (logits, cache)
    decode_step: Callable         # (model, cache, tokens, cfg) -> (logits,
    #                               cache)
    tp_forward: Callable          # (view, batch, cfg, parallel, tp) ->
    #                               (vocab-sharded logits, aux) over
    #                               `model` ranks (`models.parallel`)
    mesh_prefill: Callable        # (view, batch, cfg, sm) -> (vocab-sharded
    #                               logits, this rank's cache blocks) over
    #                               a serving mesh (`parallel.ServeMesh`)
    mesh_decode_step: Callable    # (view, cache, tokens, cfg, sm) ->
    #                               (vocab-sharded logits, cache)
    cache_defs: Callable          # (cfg, batch, max_len) -> the cache's
    #                               LeafDefs
    supported_shapes: tuple[str, ...] = ()
    skip_reason: str = ""         # why some shapes are skipped


def _on_tokens(fn):
    """A family function of tokens as one of the batch."""
    def call(model, batch, cfg, *args, **kwargs):
        return fn(model, batch["tokens"], cfg, *args, **kwargs)

    return call


def _xlstm_cache_defs(cfg, batch, max_len):
    return xlstm.cache_defs(cfg, batch)


_FULL_ATTN = ("train_4k", "prefill_32k", "decode_32k")
_ALL = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

_FAMILY = {
    "dense": dict(model=transformer.Transformer,
                  forward=_on_tokens(transformer.forward),
                  prefill=_on_tokens(transformer.prefill),
                  decode_step=transformer.decode_step,
                  tp_forward=_on_tokens(parallel.tp_forward),
                  mesh_prefill=_on_tokens(parallel.mesh_prefill),
                  mesh_decode_step=parallel.mesh_decode_step,
                  cache_defs=transformer.cache_defs),
    "hybrid": dict(model=mamba.Zamba, forward=_on_tokens(mamba.forward),
                   prefill=_on_tokens(mamba.prefill),
                   decode_step=mamba.decode_step,
                   tp_forward=_on_tokens(mamba.tp_forward),
                   mesh_prefill=_on_tokens(mamba.mesh_prefill),
                   mesh_decode_step=mamba.mesh_decode_step,
                   cache_defs=mamba.cache_defs),
    "ssm": dict(model=xlstm.XLSTM, forward=_on_tokens(xlstm.forward),
                prefill=_on_tokens(xlstm.prefill),
                decode_step=xlstm.decode_step,
                tp_forward=_on_tokens(xlstm.tp_forward),
                mesh_prefill=_on_tokens(xlstm.mesh_prefill),
                mesh_decode_step=xlstm.mesh_decode_step,
                cache_defs=_xlstm_cache_defs),
    "encdec": dict(model=encdec.EncDec, forward=encdec.forward,
                   prefill=encdec.prefill, decode_step=encdec.decode_step,
                   tp_forward=encdec.tp_forward,
                   mesh_prefill=encdec.mesh_prefill,
                   mesh_decode_step=encdec.mesh_decode_step,
                   cache_defs=encdec.cache_defs),
}
_FAMILY["moe"] = _FAMILY["dense"]
_FAMILY["vlm"] = _FAMILY["dense"]


def get_spec(arch_id: str) -> ArchSpec:
    cfg = get_config(arch_id)
    if cfg.family in ("hybrid", "ssm"):
        shapes, reason = _ALL, ""
    elif cfg.sliding_window:
        shapes, reason = _ALL, ""          # SWA: bounded cache at 500k
    elif cfg.family == "encdec":
        shapes = _FULL_ATTN
        reason = "long_500k skipped: full attention, quadratic at 512k"
    else:
        shapes = _FULL_ATTN
        reason = "long_500k skipped: pure full attention (dense KV cache)"
    return ArchSpec(arch_id=arch_id, cfg=cfg, supported_shapes=shapes,
                    skip_reason=reason, **_FAMILY[cfg.family])


# ---------------------------------------------------------------------------
# input specs per (arch x shape)
# ---------------------------------------------------------------------------


def train_batch_defs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    toks = shd.LeafDef((b, s), "int32", ("batch", None))
    batch = {"tokens": toks,
             "labels": shd.LeafDef((b, s), "int32", ("batch", None))}
    if cfg.family == "encdec":
        batch["frames"] = shd.LeafDef((b, s, cfg.d_model), cfg.dtype,
                                      ("batch", None, None))
    return batch


def prefill_batch_defs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": shd.LeafDef((b, s), "int32", ("batch", None))}
    if cfg.family == "encdec":
        batch["frames"] = shd.LeafDef((b, s, cfg.d_model), cfg.dtype,
                                      ("batch", None, None))
    return batch


def decode_batch_defs(cfg: ModelConfig, shape: ShapeConfig,
                      spec: ArchSpec) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return {"tokens": shd.LeafDef((b, 1), "int32", ("batch", None)),
            "cache": spec.cache_defs(cfg, b, s)}


def batch_defs(spec: ArchSpec, shape: ShapeConfig) -> dict:
    if shape.kind == "train":
        return train_batch_defs(spec.cfg, shape)
    if shape.kind == "prefill":
        return prefill_batch_defs(spec.cfg, shape)
    return decode_batch_defs(spec.cfg, shape, spec)


def model_class(cfg: ModelConfig):
    """The `nn.Module` class that holds `cfg`'s family's parameters."""
    return _FAMILY[cfg.family]["model"]


def smoke_config(arch_id: str) -> ModelConfig:
    """Same-family reduced config: tiny widths, few layers and experts,
    a window of 8, f32, as the reference's `registry.smoke_config`
    (zamba2: 4 layers, the shared block every 2, an SSM state of 16;
    xlstm: an sLSTM every 2 blocks; whisper: 2 encoder layers)."""
    cfg = get_config(arch_id)
    r = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2)
        if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        param_dtype="float32",
        dtype="float32",
    )
    if cfg.num_experts:
        r.update(num_experts=4, experts_per_token=2)
    if cfg.sliding_window:
        r.update(sliding_window=8)
    if cfg.family == "hybrid":
        r.update(num_layers=4, attn_every=2, ssm_state=16)
    if cfg.family == "ssm":
        r.update(num_layers=2, slstm_every=2)
    if cfg.encoder_layers:
        r.update(encoder_layers=2)
    return dataclasses.replace(cfg, **r)
