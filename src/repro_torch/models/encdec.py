"""The whisper-style encoder-decoder (counterpart of `repro.models.encdec`).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, D). No RoPE; sinusoidal absolute
positions are added on both sides, and the norms are LayerNorms without
a bias.

`EncDec` holds the parameters: `encoder`, one `transformer.Params` a
layer (`attn`, `mlp`, `ln1`, `ln2`), `ln_enc`, `layers`, one a
layer (`attn`, `xattn`, `mlp`, `ln1`, `lnx`, `ln2`), `embed`, `ln_f`,
`unembed`; the reference stacks each side's layers on a leading axis.

`forward` is training's forward over {frames, tokens}: the encoder's and
the cross-attention's blocked non-causal attention and the decoder's
blocked causal one, each layer under `ParallelConfig.remat`. `prefill`
encodes the frames and runs the decoder over the prompt; on the card its
attention is the `flash_attention` kernel, three launches a layer: the
encoder's self-attention (non-causal), the decoder's causal
self-attention and its cross-attention (non-causal, the prompt's
queries against the frames' keys). The cache holds the decoder's
self-K/V (L, B, S + PREFILL_EXTRA, KH, hd), the cross-K/V over the
encoded frames (L, B, S_enc, KH, hd) and `length`; `decode_step` writes
its self-K/V slot IN PLACE.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common, layers, parallel, transformer

ENC_FRAMES = 1500     # whisper's 30 s window of encoder frames


def _enc_defs(cfg: ModelConfig) -> dict:
    return {"attn": layers.attn_defs(cfg), "mlp": layers.mlp_defs(cfg),
            "ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}


def _dec_defs(cfg: ModelConfig) -> dict:
    return {"attn": layers.attn_defs(cfg), "xattn": layers.attn_defs(cfg),
            "mlp": layers.mlp_defs(cfg), "ln1": (cfg.d_model,),
            "lnx": (cfg.d_model,), "ln2": (cfg.d_model,)}


def encdec_defs(cfg: ModelConfig) -> dict:
    """Parameter shapes in the reference's tree, each side's layers
    stacked on a leading axis."""
    return {"encoder": transformer.stack_defs(_enc_defs(cfg),
                                              cfg.encoder_layers),
            "ln_enc": (cfg.d_model,),
            "layers": transformer.stack_defs(_dec_defs(cfg),
                                             cfg.num_layers),
            **common.embed_defs(cfg)}


class EncDec(nn.Module):
    """Parameters of the encoder-decoder on `device` (default: the card;
    raises without one unless `device="cpu"`), uninitialised until
    `common.init_params` or `convert.params_from_numpy` fills them; for
    serving, or with `train=True` for training."""

    STACKS = ("encoder", "layers")
    defs = staticmethod(encdec_defs)

    def __init__(self, cfg: ModelConfig, device=None, train: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = nn.ModuleList(
            transformer.Params(_enc_defs(cfg), cfg, device, train)
            for _ in range(cfg.encoder_layers))
        common.add_params(self, {"ln_enc": (cfg.d_model,)}, cfg, device,
                          train)
        self.layers = nn.ModuleList(
            transformer.Params(_dec_defs(cfg), cfg, device, train)
            for _ in range(cfg.num_layers))
        common.add_params(self, common.embed_defs(cfg), cfg, device, train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_table(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


def _positions(x, cfg: ModelConfig):
    return x + layers.sinusoidal_positions(x.shape[1], cfg.d_model,
                                           x.dtype, x.device)[None]


def _encoder_layer(lp, x, cfg: ModelConfig, serving: bool = False):
    h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
    if serving:
        q = layers.project_q(lp.attn, h, cfg)
        k, v = layers.project_kv(lp.attn, h, cfg)
        att = layers.project_out(lp.attn,
                                 layers.bidirectional_attention(q, k, v))
    else:
        att = layers.attention_block(lp.attn, h, cfg, None, causal=False)
    x = x + att
    h = layers.layer_norm(x, lp.ln2, cfg.norm_eps)
    return x + layers.mlp_block(lp.mlp, h, cfg)


def encode(model: EncDec, frames: torch.Tensor, cfg: ModelConfig,
           parallel: ParallelConfig | None = None, serving: bool = False):
    """frames (B, S_enc, D) -> the encoded frames (B, S_enc, D) in
    `cfg.dtype`. Training's blocked attention under `parallel.remat`, or
    with `serving` the `flash_attention` kernel (no autograd)."""
    parallel = parallel or ParallelConfig()
    layer = _encoder_layer if serving else transformer.remat(
        _encoder_layer, parallel.remat)
    x = _positions(frames.to(common.act_dtype(cfg)), cfg)
    for lp in model.encoder:
        x = layer(lp, x, cfg, serving)
    return layers.layer_norm(x, model.ln_enc, cfg.norm_eps)


def _decoder_layer(lp, x, enc_out, cfg: ModelConfig):
    h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
    x = x + layers.attention_block(lp.attn, h, cfg, None, causal=True)
    h = layers.layer_norm(x, lp.lnx, cfg.norm_eps)
    x = x + layers.attention_block(lp.xattn, h, cfg, None, causal=False,
                                   kv_x=enc_out)
    h = layers.layer_norm(x, lp.ln2, cfg.norm_eps)
    return x + layers.mlp_block(lp.mlp, h, cfg)


def decode_train(model: EncDec, tokens: torch.Tensor, enc_out, cfg,
                 parallel: ParallelConfig | None = None):
    """The teacher-forced decoder: tokens (B, S) -> logits (B, S, V_pad)
    f32."""
    parallel = parallel or ParallelConfig()
    layer = transformer.remat(_decoder_layer, parallel.remat)
    x = _positions(common.embed_tokens(model.embed, tokens, cfg), cfg)
    for lp in model.layers:
        x = layer(lp, x, enc_out, cfg)
    x = layers.layer_norm(x, model.ln_f, cfg.norm_eps)
    return common.lm_head(model.unembed_table(), x, cfg)


def forward(model: EncDec, batch: dict, cfg: ModelConfig,
            parallel: ParallelConfig | None = None):
    """batch {frames (B, S_enc, D), tokens (B, S)} -> (logits, aux 0),
    differentiable."""
    enc_out = encode(model, batch["frames"], cfg, parallel)
    logits = decode_train(model, batch["tokens"], enc_out, cfg, parallel)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def _tp_encoder_layer(lp, x, cfg: ModelConfig, tp, attn_mode: str):
    h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
    x = x + parallel.attention_half(lp.attn, h, cfg, None, tp, attn_mode,
                                    causal=False)
    h = layers.layer_norm(x, lp.ln2, cfg.norm_eps)
    return x + parallel.mlp_half(lp.mlp, h, cfg, tp)


def _tp_decoder_layer(lp, x, enc_shard, enc_full, cfg: ModelConfig, tp,
                      attn_mode: str):
    h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
    x = x + parallel.attention_half(lp.attn, h, cfg, None, tp, attn_mode)
    h = layers.layer_norm(x, lp.lnx, cfg.norm_eps)
    x = x + parallel.attention_half(lp.xattn, h, cfg, None, tp, attn_mode,
                                    causal=False, kv_shard=enc_shard,
                                    kv_full=enc_full)
    h = layers.layer_norm(x, lp.ln2, cfg.norm_eps)
    return x + parallel.mlp_half(lp.mlp, h, cfg, tp)


def _shard_positions(x, cfg: ModelConfig, tp, s: int):
    """x (B, S/m, D), the rank's S-shard of a sequence of `s`, plus its
    rows of the sinusoidal positions."""
    n = s // tp.size
    pos = layers.sinusoidal_positions(s, cfg.d_model, x.dtype, x.device)
    return x + pos[tp.rank * n:(tp.rank + 1) * n][None]


def tp_forward(view, batch: dict, cfg: ModelConfig,
               parallel_cfg: ParallelConfig, tp):
    """The forward over `model` ranks (`models.parallel`): both streams
    S-sharded; the encoder's non-causal self-attention, the decoder's
    causal self-attention and its cross-attention head-parallel (the
    cross K/V from the gathered encoder output) or with `attn_mode="cp"`
    context-parallel (the cross K/V from the rank's S-shard of it,
    gathered with them); the GELU MLPs ff-parallel; the embedding, head
    and loss vocab-parallel. batch {frames (B, S_enc, D), tokens (B, S)}
    -> (logits (B, S, V_pad/m) f32, aux 0)."""
    frames, tokens = batch["frames"], batch["tokens"]
    s_enc, s = frames.shape[1], tokens.shape[1]
    parallel.check_tp(cfg, s, tp)
    if s_enc % tp.size:
        raise ValueError(f"tensor parallelism over model = {tp.size} needs "
                         f"the {s_enc} encoder frames to divide by it")
    mode = parallel_cfg.attn_mode
    n = s_enc // tp.size
    x = frames[:, tp.rank * n:(tp.rank + 1) * n].to(common.act_dtype(cfg))
    x = _shard_positions(x, cfg, tp, s_enc)
    layer = transformer.remat(_tp_encoder_layer, parallel_cfg.remat)
    for lp in view.encoder:
        x = layer(lp, x, cfg, tp, mode)
    enc = layers.layer_norm(x, view.ln_enc, cfg.norm_eps)
    enc_full = None if mode == "cp" else tp.seq_gather(enc)
    x = _shard_positions(parallel.vocab_parallel_embed(
        view.embed, tokens, cfg, tp), cfg, tp, s)
    layer = transformer.remat(_tp_decoder_layer, parallel_cfg.remat)
    for lp in view.layers:
        x = layer(lp, x, enc, enc_full, cfg, tp, mode)
    logits = parallel.tp_logits(view, x, cfg, tp, layers.layer_norm)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int,
               enc_frames: int = ENC_FRAMES) -> dict:
    """The cache's `sharding.LeafDef`s, the reference's: k and v (L, B,
    max_len, KH, hd) by `kv_heads` or `kv_seq`
    (`sharding.kv_cache_logical`), xk and xv (L, B, enc_frames, KH, hd) by
    `kv_heads`, length (B,)."""
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kv = shd.LeafDef((cfg.num_layers, batch, max_len, kh, hd), cfg.dtype,
                     shd.kv_cache_logical(kh))
    xkv = shd.LeafDef((cfg.num_layers, batch, enc_frames, kh, hd),
                      cfg.dtype, ("layers", "batch", None, "kv_heads", None))
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv,
            "length": shd.LeafDef((batch,), "int32", ("batch",))}


@torch.inference_mode()
def prefill(model: EncDec, batch: dict, cfg: ModelConfig):
    """batch {frames (B, S_enc, D), tokens (B, S)} -> (last-token logits
    (B, 1, V_pad) f32, cache)."""
    enc_out = encode(model, batch["frames"], cfg, serving=True)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _positions(common.embed_tokens(model.embed, tokens, cfg), cfg)
    cache = transformer.new_cache(cache_defs(
        cfg, b, s + transformer.PREFILL_EXTRA, enc_out.shape[1]), x.device)
    cache["length"].fill_(s)
    for i, lp in enumerate(model.layers):
        h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
        q = layers.project_q(lp.attn, h, cfg)
        k, v = layers.project_kv(lp.attn, h, cfg)
        x = x + layers.project_out(lp.attn,
                                   layers.causal_self_attention(q, k, v))
        h = layers.layer_norm(x, lp.lnx, cfg.norm_eps)
        xk, xv = layers.project_kv(lp.xattn, enc_out, cfg)
        qx = layers.project_q(lp.xattn, h, cfg)
        x = x + layers.project_out(
            lp.xattn, layers.bidirectional_attention(qx, xk, xv))
        h = layers.layer_norm(x, lp.ln2, cfg.norm_eps)
        x = x + layers.mlp_block(lp.mlp, h, cfg)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    x = layers.layer_norm(x[:, -1:], model.ln_f, cfg.norm_eps)
    return common.lm_head(model.unembed_table(), x, cfg), cache


@torch.inference_mode()
def decode_step(model: EncDec, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decoder token, tokens (B, 1) int; the cache as `prefill`
    returns it, its self-K/V slot and `length` updated IN PLACE. Returns
    (logits (B, 1, V_pad) f32, cache)."""
    b = tokens.shape[0]
    slots = cache["k"].shape[2]
    pos = cache["length"]
    x = common.embed_tokens(model.embed, tokens, cfg)
    postab = layers.sinusoidal_positions(slots, cfg.d_model, x.dtype,
                                         x.device)
    x = x + postab[torch.clamp(pos, max=slots - 1).long()][:, None, :]
    rows = torch.arange(b, device=x.device)
    slot = torch.clamp(pos, max=slots - 1).long()
    frames = torch.full((b,), cache["xk"].shape[2], dtype=torch.int32,
                        device=x.device)
    for i, lp in enumerate(model.layers):
        h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
        q = layers.project_q(lp.attn, h, cfg)
        k_new, v_new = layers.project_kv(lp.attn, h, cfg)
        cache["k"][i, rows, slot] = k_new[:, 0]
        cache["v"][i, rows, slot] = v_new[:, 0]
        att = layers.decode_attention(q, cache["k"][i], cache["v"][i],
                                      pos + 1)
        x = x + layers.project_out(lp.attn, att)
        h = layers.layer_norm(x, lp.lnx, cfg.norm_eps)
        qx = layers.project_q(lp.xattn, h, cfg)
        attx = layers.decode_attention(qx, cache["xk"][i], cache["xv"][i],
                                       frames)
        x = x + layers.project_out(lp.xattn, attx)
        h = layers.layer_norm(x, lp.ln2, cfg.norm_eps)
        x = x + layers.mlp_block(lp.mlp, h, cfg)
    x = layers.layer_norm(x, model.ln_f, cfg.norm_eps)
    logits = common.lm_head(model.unembed_table(), x, cfg)
    cache["length"] += 1
    return logits, cache


# ---------------------------------------------------------------------------
# serving over a mesh
# ---------------------------------------------------------------------------


def serve_encode(view, frames: torch.Tensor, cfg: ModelConfig, tp):
    """The encoder over `model`, head-parallel on the replicated frames
    (b, S_enc, D) (the kernel non-causal on the card), the MLP
    ff-parallel, each summed over `model` -> the encoded frames."""
    x = _positions(frames.to(common.act_dtype(cfg)), cfg)
    for lp in view.encoder:
        h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
        x = x + parallel.serve_attention(lp.attn, h, cfg, None, tp,
                                         causal=False)[0]
        x = x + parallel.serve_mlp(
            lp.mlp, layers.layer_norm(x, lp.ln2, cfg.norm_eps), cfg, tp)
    return layers.layer_norm(x, view.ln_enc, cfg.norm_eps)


@torch.inference_mode()
def mesh_prefill(view, batch: dict, cfg: ModelConfig, sm):
    """whisper's prefill over a serving mesh (`models.parallel.ServeMesh`):
    batch {frames, tokens} of this rank's rows -> (vocab-sharded last
    logits, this rank's cache blocks: the self K/V by `kv_seq` or
    `kv_heads`, the cross K/V, computed once here, by `kv_heads`)."""
    tp = sm.tp
    enc = serve_encode(view, batch["frames"], cfg, tp)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _positions(parallel.serve_embed(view.embed, tokens, cfg, tp), cfg)
    defs = cache_defs(cfg, sm.batch, s + transformer.PREFILL_EXTRA,
                      enc.shape[1])
    cache = sm.new_cache(defs, x.device)
    cache["length"].fill_(s)
    place = sm.place("kv", defs["k"])
    xplace = sm.place("xkv", defs["xk"])
    for i, lp in enumerate(view.layers):
        h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
        att, k, v = parallel.serve_attention(lp.attn, h, cfg, None, tp)
        x = x + att
        h = layers.layer_norm(x, lp.lnx, cfg.norm_eps)
        att, xk, xv = parallel.serve_attention(lp.xattn, h, cfg, None, tp,
                                               causal=False, kv_x=enc)
        x = x + att
        x = x + parallel.serve_mlp(
            lp.mlp, layers.layer_norm(x, lp.ln2, cfg.norm_eps), cfg, tp)
        for name, t, pl in (("k", k, place), ("v", v, place),
                            ("xk", xk, xplace), ("xv", xv, xplace)):
            blk = parallel.prefill_kv_block(t, pl, cfg, tp)
            cache[name][i, :, :blk.shape[1]] = blk
    return parallel.serve_logits(view, x[:, -1:], cfg, tp,
                                 layers.layer_norm), cache


@torch.inference_mode()
def mesh_decode_step(view, cache: dict, tokens: torch.Tensor,
                     cfg: ModelConfig, sm):
    """One decoder token over a serving mesh, tokens (b, 1) of this rank's
    rows; the self K/V blocks and `length` updated IN PLACE: the self-
    attention by `parallel.decode_self_attention`, the cross-attention
    head-local. Returns (vocab-sharded logits, cache)."""
    tp, place, xplace = sm.tp, sm.kv["kv"], sm.kv["xkv"]
    b = tokens.shape[0]
    pos = cache["length"]
    x = parallel.serve_embed(view.embed, tokens, cfg, tp)
    postab = layers.sinusoidal_positions(place.slots, cfg.d_model, x.dtype,
                                         x.device)
    x = x + postab[torch.clamp(pos, max=place.slots - 1).long()][:, None, :]
    slot = parallel.decode_slot(pos, place, 0)
    frames = torch.full((b,), xplace.slots, dtype=torch.int32,
                        device=x.device)
    for i, lp in enumerate(view.layers):
        h = layers.layer_norm(x, lp.ln1, cfg.norm_eps)
        x = x + parallel.decode_attention_layer(
            lp.attn, h, cache["k"][i], cache["v"][i], pos, slot, None,
            place, cfg, tp)
        h = layers.layer_norm(x, lp.lnx, cfg.norm_eps)
        qx = layers.project_q(lp.xattn, h, cfg)
        attx = parallel.local_decode_attention(qx, cache["xk"][i],
                                               cache["xv"][i], frames, cfg,
                                               tp)
        x = x + parallel.attn_out(lp.xattn, attx, cfg, tp)
        x = x + parallel.serve_mlp(
            lp.mlp, layers.layer_norm(x, lp.ln2, cfg.norm_eps), cfg, tp)
    logits = parallel.serve_logits(view, x, cfg, tp, layers.layer_norm)
    cache["length"] += 1
    return logits, cache
