"""Architecture registry of the port: arch id -> params, forward, prefill,
decode (counterpart of `repro.models.registry`, for the ported families).

The port trains and serves the `dense`, `vlm` and `moe` families through
`models.transformer`, as the reference does; `configs.get_config` raises
for the others.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


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


def _lm_forward(model, batch, cfg, parallel=None):
    return transformer.forward(model, batch["tokens"], cfg, parallel)


def _lm_prefill(model, batch, cfg):
    return transformer.prefill(model, batch["tokens"], cfg)


_FAMILY = {
    "dense": dict(model=transformer.Transformer, forward=_lm_forward,
                  prefill=_lm_prefill, decode_step=transformer.decode_step),
}
_FAMILY["moe"] = _FAMILY["dense"]
_FAMILY["vlm"] = _FAMILY["dense"]


def get_spec(arch_id: str) -> ArchSpec:
    cfg = get_config(arch_id)
    return ArchSpec(arch_id=arch_id, cfg=cfg, **_FAMILY[cfg.family])


def smoke_config(arch_id: str) -> ModelConfig:
    """Same-family reduced config: tiny widths, few layers and experts,
    a window of 8, f32, as the reference's `registry.smoke_config`."""
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
    return dataclasses.replace(cfg, **r)
