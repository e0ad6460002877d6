"""Decoder-only transformer (counterpart of `repro.models.transformer`):
the dense family, chameleon (vlm) with qk-norm, and the MoE family
(`models.moe` in place of the MLP; mixtral with a sliding window).

`Transformer` holds the parameters as `nn.Module`s, one `Params` of
`_layer_defs` per layer, under the reference's names and layouts (`attn.wq`,
`mlp.wi_gate`, `ln1`, ..., `embed`, `ln_f`, `unembed`); the reference
stacks the layers on a leading axis for `lax.scan`, the port loops over
them (`convert` carries a stacked numpy tree either way). Built with
`train=True` it keeps f32 masters that require grad
(`common.add_params`).

`forward` is training's forward, `transformer.forward`: logits (B, S,
V_pad) f32 and the aux loss (the sum over layers of the MoE
load-balancing loss, 0 for dense layers, with MoE groups of
`ParallelConfig.moe_group` tokens), differentiable. `ParallelConfig.remat`
maps onto `torch.utils.checkpoint` a layer at a time ("full" saves only
a layer's input, "dots" also the outputs of `aten.mm`, the counterpart
of `checkpoint_dots_with_no_batch_dims`, "none" is plain autograd);
`scan_layers` has no meaning for a loop and is ignored, and
`seq_shard`'s sharding constraint is a no-op outside a mesh, as in the
reference.

`prefill` and `decode_step` follow `transformer.prefill` and
`transformer.decode_step`. The KV cache has the reference's layout
(`cache_defs`): k and v (L, B, slots, KH, hd) in `cfg.dtype`, `length`
(B,) int32. Prefill allocates it once with PREFILL_EXTRA slots of zero
headroom and writes each layer's K/V into it (the reference pads after
the scan); decode writes its slot in place (the reference's one-hot
masked update, which gives the same values). Under a sliding window W
the cache is a ring of min(S, W) slots with no headroom, holding the
prompt's last positions in order, and decode writes slot `pos % slots`,
as the reference does; that ring is aligned with positions only when
the prompt length S is a multiple of W, and the port reproduces the
reference's results where it is not (ROADMAP C21).
Prefill and decode route MoE tokens in the default groups of
`moe.GROUP_SIZE`: a decode step's B tokens are one group.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, layers, moe

PREFILL_EXTRA = 32   # decode headroom appended to non-SWA prefill caches


def _mlp_defs(cfg: ModelConfig) -> dict:
    return moe.moe_defs(cfg) if cfg.num_experts else layers.mlp_defs(cfg)


def _layer_defs(cfg: ModelConfig) -> dict:
    """Pre-norm block: attention and MLP (or MoE), each behind an RMS
    norm."""
    return {"attn": layers.attn_defs(cfg), "mlp": _mlp_defs(cfg),
            "ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}


class Params(nn.Module):
    """A block's parameters from its defs: each nested dict a child
    `Params` under its name, each shape one parameter
    (`common.add_params`)."""

    def __init__(self, defs: dict, cfg: ModelConfig, device, train: bool):
        super().__init__()
        for name, sub in defs.items():
            if isinstance(sub, dict):
                setattr(self, name, Params(sub, cfg, device, train))
        common.add_params(self, {k: v for k, v in defs.items()
                                 if not isinstance(v, dict)},
                          cfg, device, train)


class Transformer(nn.Module):
    """Parameters of a decoder-only LM on `device` (default: the card;
    raises without one unless `device="cpu"`), uninitialised until
    `common.init_params` or `convert.params_from_numpy` fills them; for
    serving, or with `train=True` for training (f32 masters that require
    grad)."""

    STACKS = ("layers",)       # stacked on a leading axis in the reference

    @staticmethod
    def defs(cfg: ModelConfig) -> dict:
        return transformer_defs(cfg)

    def __init__(self, cfg: ModelConfig, device=None, train: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.layers = nn.ModuleList(Params(_layer_defs(cfg), cfg, device,
                                           train)
                                    for _ in range(cfg.num_layers))
        common.add_params(self, common.embed_defs(cfg), cfg, device, train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_table(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


def transformer_defs(cfg: ModelConfig) -> dict:
    """Parameter shapes in the reference's tree, layers stacked on a
    leading axis (the layout `convert` carries)."""
    return {"layers": stack_defs(_layer_defs(cfg), cfg.num_layers),
            **common.embed_defs(cfg)}


def stack_defs(defs: dict, n: int) -> dict:
    """`defs` with a leading axis of `n` on every shape (the reference's
    `common.stack_defs`)."""
    return {k: stack_defs(v, n) if isinstance(v, dict) else (n, *v)
            for k, v in defs.items()}


def new_cache(defs, device, shapes=None):
    """Zero tensors of a cache's tree of `sharding.LeafDef`s, of their
    shapes or, over a mesh, of a rank's block `shapes` (the same tree)."""
    if isinstance(defs, shd.LeafDef):
        return torch.zeros(defs.shape if shapes is None else shapes,
                           dtype=getattr(torch, defs.dtype), device=device)
    if isinstance(defs, (list, tuple)):
        return [new_cache(d, device, None if shapes is None else s)
                for d, s in zip(defs, shapes or defs, strict=True)]
    return {k: new_cache(d, device, None if shapes is None else shapes[k])
            for k, d in defs.items()}


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The KV cache's `sharding.LeafDef`s: k and v (L, B, slots, KH, hd)
    in `cfg.dtype`, slots = max_len, or min(max_len, W) under a sliding
    window W; `length` (B,) int32. Their logical axes are the
    reference's (`sharding.kv_cache_logical`)."""
    w = cfg.sliding_window
    slots = min(max_len, w) if w else max_len
    kv = shd.LeafDef((cfg.num_layers, batch, slots, cfg.num_kv_heads,
                      cfg.resolved_head_dim), cfg.dtype,
                     shd.kv_cache_logical(cfg.num_kv_heads))
    return {"k": kv, "v": kv,
            "length": shd.LeafDef((batch,), "int32", ("batch",))}


def rope_tables(positions, cfg: ModelConfig):
    """(sin, cos) for `positions`, computed once for all layers (the
    reference computes the same tables in every layer), or None."""
    if not cfg.rope_theta:
        return None
    return layers.rope_tables(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)


def rope(q, k, tables):
    if tables is None:
        return q, k
    sin, cos = tables
    return layers.apply_rope(q, sin, cos), layers.apply_rope(k, sin, cos)


def decoder_layer(lp, x, cfg: ModelConfig, tables,
                  attn_mode: str = "auto",
                  moe_group: int = moe.GROUP_SIZE, exchange=None):
    """x (B, S, D) -> ((B, S, D), aux): the pre-norm residual block of
    training. `tables` are RoPE's (sin, cos) for the sequence's positions
    (`rope_tables`, None without RoPE); aux, the MoE load-balance loss
    over groups of `moe_group` tokens, is 0 for a dense layer. Over a
    mesh of DP ranks `exchange` (`moe.Exchange`) places x's tokens in the
    microbatch, whose groups may span the ranks."""
    h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + layers.attention_block(lp.attn, h, cfg, tables,
                                   attn_mode=attn_mode)
    x, aux = _ffn_half(lp, x, cfg, moe_group, exchange)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _save_mm(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for remat="dots": keep the
    outputs of the products without batch dims, recompute the rest."""
    if op.overloadpacket is torch.ops.aten.mm:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def remat(layer_fn, mode: str):
    """`layer_fn` under `ParallelConfig.remat`'s `mode`."""
    if mode == "none":
        return layer_fn
    if mode == "full":
        return functools.partial(checkpoint.checkpoint, layer_fn,
                                 use_reentrant=False)
    if mode == "dots":
        return functools.partial(
            checkpoint.checkpoint, layer_fn, use_reentrant=False,
            context_fn=functools.partial(
                checkpoint.create_selective_checkpoint_contexts, _save_mm))
    raise ValueError(f"unknown remat {mode!r}: none | full | dots")


def forward(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            parallel: ParallelConfig | None = None, exchange=None):
    """Training's forward: tokens (B, S) int -> (logits (B, S, V_pad) f32,
    aux 0-d f32), differentiable with respect to the model's parameters,
    each layer under `parallel.remat`; `exchange` as `decoder_layer`'s."""
    parallel = parallel or ParallelConfig()
    layer = remat(decoder_layer, parallel.remat)
    x = common.embed_tokens(model.embed, tokens, cfg)
    tables = rope_tables(torch.arange(tokens.shape[1], dtype=torch.int32,
                                       device=x.device), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        x, a = layer(lp, x, cfg, tables, parallel.attn_mode,
                     parallel.moe_group, exchange)
        aux = aux + a
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    return common.lm_head(model.unembed_table(), x, cfg), aux


def _ffn_half(lp, x, cfg: ModelConfig, moe_group: int = moe.GROUP_SIZE,
              exchange=None):
    """x + the MLP (or MoE) of its RMS norm, and the MoE aux loss (None
    for a dense layer), as the reference's `_ffn`."""
    h = layers.rms_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.num_experts:
        ff, aux = moe.moe_block(lp.mlp, h, cfg, group_size=moe_group,
                                exchange=exchange)
        return x + ff, aux
    return x + layers.mlp_block(lp.mlp, h, cfg), None


@torch.inference_mode()
def prefill(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens (B, S) int -> (last-token logits (B, 1, V_pad) f32, cache)."""
    b, s = tokens.shape
    w = cfg.sliding_window
    slots = min(s, w) if w else s
    x = common.embed_tokens(model.embed, tokens, cfg)
    tables = rope_tables(torch.arange(s, dtype=torch.int32,
                                       device=x.device), cfg)
    cache = new_cache(cache_defs(cfg, b, slots if w else s + PREFILL_EXTRA),
                      x.device)
    cache["length"].fill_(s)
    for i, lp in enumerate(model.layers):
        h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
        q = layers.project_q(lp.attn, h, cfg)
        k, v = layers.project_kv(lp.attn, h, cfg)
        q, k = rope(q, k, tables)
        att = layers.causal_self_attention(q, k, v,
                                           window=cfg.sliding_window)
        x = x + layers.project_out(lp.attn, att)
        x, _ = _ffn_half(lp, x, cfg)
        cache["k"][i, :, :slots] = k[:, s - slots:]
        cache["v"][i, :, :slots] = v[:, s - slots:]
    x = layers.rms_norm(x[:, -1:], model.ln_f, cfg.norm_eps)
    return common.lm_head(model.unembed_table(), x, cfg), cache


@torch.inference_mode()
def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decode step. tokens: (B, 1) int; `cache` as `prefill` returns
    it, updated IN PLACE (its K/V slot and `length`) and returned.
    Returns (logits (B, 1, V_pad) f32, cache)."""
    b = tokens.shape[0]
    slots = cache["k"].shape[2]
    pos = cache["length"]                                  # (B,)
    x = common.embed_tokens(model.embed, tokens, cfg)
    rows = torch.arange(b, device=x.device)
    if cfg.sliding_window:
        slot = (pos % slots).long()            # the ring of window slots
    else:
        slot = torch.clamp(pos, max=slots - 1).long()
    tables = rope_tables(pos[:, None], cfg)
    visible = pos + 1
    for i, lp in enumerate(model.layers):
        h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
        q = layers.project_q(lp.attn, h, cfg)
        k_new, v_new = layers.project_kv(lp.attn, h, cfg)
        q, k_new = rope(q, k_new, tables)
        cache["k"][i, rows, slot] = k_new[:, 0]
        cache["v"][i, rows, slot] = v_new[:, 0]
        att = layers.decode_attention(q, cache["k"][i], cache["v"][i],
                                      visible, window=cfg.sliding_window)
        x = x + layers.project_out(lp.attn, att)
        x, _ = _ffn_half(lp, x, cfg)
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = common.lm_head(model.unembed_table(), x, cfg)
    cache["length"] += 1
    return logits, cache
