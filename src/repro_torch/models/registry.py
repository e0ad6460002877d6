"""Architecture registry of the port: arch id -> params, forward, prefill,
decode (counterpart of `repro.models.registry`).

Every family of the reference: `dense`, `vlm` and `moe` through
`models.transformer`, `hybrid` (zamba2) through `models.mamba`, `ssm`
(xlstm) through `models.xlstm` and `encdec` (whisper) through
`models.encdec`. A batch is a dict: `tokens` (B, S), and for `encdec`
`frames` (B, S_enc, D) too.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
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


def _on_tokens(fn):
    """A family function of tokens as one of the batch."""
    def call(model, batch, cfg, *args, **kwargs):
        return fn(model, batch["tokens"], cfg, *args, **kwargs)

    return call


_FAMILY = {
    "dense": dict(model=transformer.Transformer,
                  forward=_on_tokens(transformer.forward),
                  prefill=_on_tokens(transformer.prefill),
                  decode_step=transformer.decode_step,
                  tp_forward=_on_tokens(parallel.tp_forward),
                  mesh_prefill=_on_tokens(parallel.mesh_prefill),
                  mesh_decode_step=parallel.mesh_decode_step),
    "hybrid": dict(model=mamba.Zamba, forward=_on_tokens(mamba.forward),
                   prefill=_on_tokens(mamba.prefill),
                   decode_step=mamba.decode_step,
                   tp_forward=_on_tokens(mamba.tp_forward),
                   mesh_prefill=_on_tokens(mamba.mesh_prefill),
                   mesh_decode_step=mamba.mesh_decode_step),
    "ssm": dict(model=xlstm.XLSTM, forward=_on_tokens(xlstm.forward),
                prefill=_on_tokens(xlstm.prefill),
                decode_step=xlstm.decode_step,
                tp_forward=_on_tokens(xlstm.tp_forward),
                mesh_prefill=_on_tokens(xlstm.mesh_prefill),
                mesh_decode_step=xlstm.mesh_decode_step),
    "encdec": dict(model=encdec.EncDec, forward=encdec.forward,
                   prefill=encdec.prefill, decode_step=encdec.decode_step,
                   tp_forward=encdec.tp_forward,
                   mesh_prefill=encdec.mesh_prefill,
                   mesh_decode_step=encdec.mesh_decode_step),
}
_FAMILY["moe"] = _FAMILY["dense"]
_FAMILY["vlm"] = _FAMILY["dense"]


def get_spec(arch_id: str) -> ArchSpec:
    cfg = get_config(arch_id)
    return ArchSpec(arch_id=arch_id, cfg=cfg, **_FAMILY[cfg.family])


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
