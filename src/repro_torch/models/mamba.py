"""Mamba2 (SSD) blocks and the zamba2 hybrid backbone (counterpart of
`repro.models.mamba`).

zamba2 stacks Mamba2 blocks and applies one *shared* transformer block
(attention + MLP, one set of weights) after every `attn_every` of them.
The SSD core is `ssm_common.chunked_linear_attention` with q = C, k = B,
v = the x heads scaled by dt, and a decay exp(dt * -exp(A_log)) a head
and step.

`Zamba` holds the parameters: `layers`, one `MambaLayer` a layer under
the reference's names (`norm`, `wx`, `wz`, `wB`, `wC`, `wdt`, `dt_bias`,
`A_log`, `D_skip`, `conv`, `out_norm`, `wo`; the reference stacks them
on a leading axis), `shared` (`attn`, `mlp`, `ln1`, `ln2`), `embed`,
`ln_f`, `unembed`. A serving model keeps the convolution's taps in f32,
as the reference reads them.

`forward` is training's forward: each group of `attn_every` layers and
the shared block after it is one unit of `ParallelConfig.remat` (the
reference's `jax.checkpoint(group)`). `prefill` and `decode_step` follow
the reference's: the cache holds each layer's conv tail (L, B, K - 1,
d_inner) in `cfg.dtype`, its SSD state (L, B, H, N, P) in f32, and each
invocation of the shared block's K/V (n_inv, B, S + PREFILL_EXTRA, KH,
hd), with `length`. Prefill's shared attention is
`layers.causal_self_attention`: the `flash_attention` kernel on the card
(zamba2's head dim is 80), once per invocation. Decode writes the cache
IN PLACE and returns it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import fsdp
from repro_torch.device import resolve_device
from repro_torch.models import (common, layers, parallel, ssm_common,
                                 transformer)

P_HEAD = 64      # SSD head dim (mamba2's default)
CONV_K = 4       # depthwise convolution taps


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // P_HEAD, cfg.ssm_state


def mamba_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, n = _dims(cfg)
    return {"norm": (d,), "wx": (d, di), "wz": (d, di), "wB": (d, n),
            "wC": (d, n), "wdt": (d, h), "dt_bias": (h,), "A_log": (h,),
            "D_skip": (h,), "conv": (CONV_K, di), "out_norm": (di,),
            "wo": (di, d)}


def _shared_defs(cfg: ModelConfig) -> dict:
    return {"attn": layers.attn_defs(cfg), "mlp": layers.mlp_defs(cfg),
            "ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}


def _n_inv(cfg: ModelConfig) -> int:
    every = max(cfg.attn_every, 1)
    if cfg.num_layers % every:
        raise ValueError(f"{cfg.num_layers} layers do not split into "
                         f"groups of attn_every = {every}")
    return cfg.num_layers // every


def zamba_defs(cfg: ModelConfig) -> dict:
    """Parameter shapes in the reference's tree (the mamba layers stacked
    on a leading axis, the shared block once)."""
    return {"layers": transformer.stack_defs(mamba_defs(cfg),
                                             cfg.num_layers),
            "shared": _shared_defs(cfg), **common.embed_defs(cfg)}


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, train: bool = False):
        super().__init__()
        common.add_params(self, mamba_defs(cfg), cfg, device, train,
                          keep_f32=("conv",))


class Zamba(nn.Module):
    """Parameters of zamba2 on `device` (default: the card; raises without
    one unless `device="cpu"`), uninitialised until `common.init_params`
    or `convert.params_from_numpy` fills them; for serving, or with
    `train=True` for training."""

    STACKS = ("layers",)
    defs = staticmethod(zamba_defs)

    def __init__(self, cfg: ModelConfig, device=None, train: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        _n_inv(cfg)
        self.layers = nn.ModuleList(MambaLayer(cfg, device, train)
                                    for _ in range(cfg.num_layers))
        self.shared = transformer.Params(_shared_defs(cfg), cfg, device,
                                         train)
        common.add_params(self, common.embed_defs(cfg), cfg, device, train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_table(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def softplus(x):
    """`jax.nn.softplus`, logaddexp(x, 0) (F.softplus turns linear above
    its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def conv1d(x, kernel):
    """Causal depthwise convolution, x (B, S, C), kernel (K, C): the
    reference's loop over the K taps, summed in f32, cast to x's dtype.
    The taps read views of one f32 copy of the padded input, so that
    autograd keeps one copy for the K products, not K."""
    k, s = kernel.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)).to(torch.float32)
    w = kernel.to(torch.float32)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out.to(x.dtype)


def _ssd_inputs(p, x, cfg: ModelConfig, heads: slice | None = None):
    """x's projections: x and z in x's dtype, B and C f32 products, and
    dt = softplus(x wdt + dt_bias) f32; `heads`, the heads of `p`'s
    `wdt` columns among dt_bias' (all of them by default)."""
    dt_ = x.dtype
    xin = x @ p.wx.to(dt_)
    z = x @ p.wz.to(dt_)
    bm = common.dot_f32(x, p.wB.to(dt_))
    cm = common.dot_f32(x, p.wC.to(dt_))
    bias = p.dt_bias if heads is None else p.dt_bias[heads]
    dt = softplus(common.dot_f32(x, p.wdt.to(dt_))
                  + bias.to(torch.float32))
    return xin, z, bm, cm, dt


def _gated_out(p, y, z, x, cfg: ModelConfig):
    """rms_norm(y * silu(z)) @ wo, added to the residual x."""
    dt_ = x.dtype
    y = layers.rms_norm(y * F.silu(z.to(torch.float32)).to(dt_),
                        p.out_norm, cfg.norm_eps)
    return x + y @ p.wo.to(dt_)


def _ssd(p, hdd, x_dtype, cfg: ModelConfig, head0: int = 0,
         return_state: bool = False):
    """The projections, convolution and SSD scan of the normed input hdd
    (B, S, D) for the heads [head0, head0 + H') whose channels `p`'s
    `wx`, `wz`, `conv` and `wdt` hold (all of them by default) -> (y
    (B, S, H' * P) in x's dtype, z, the raw x projection, the SSD
    state)."""
    _, _, n = _dims(cfg)
    b, s, _ = hdd.shape
    h = p.wdt.shape[-1]
    heads = slice(head0, head0 + h)
    xin_raw, z, bm, cm, dt = _ssd_inputs(p, hdd, cfg, heads)
    xin = F.silu(conv1d(xin_raw, p.conv).to(torch.float32)).to(x_dtype)
    xh = xin.reshape(b, s, h, P_HEAD)
    log_a = -torch.exp(p.A_log[heads].to(torch.float32)) * dt
    # one B/C group broadcast over the heads; dt scales the input (v)
    k = bm[:, :, None, :].expand(b, s, h, n)
    q = cm[:, :, None, :].expand(b, s, h, n)
    v = xh * dt[..., None]
    res = ssm_common.chunked_linear_attention(
        q, k, v, log_a, chunk=min(128, s), return_state=return_state)
    y, state = res if return_state else (res, None)
    y = y + xh.to(torch.float32) \
        * p.D_skip[heads].to(torch.float32)[:, None]
    return y.reshape(b, s, h * P_HEAD).to(x_dtype), z, xin_raw, state


def mamba_block(p, x, cfg: ModelConfig, return_state: bool = False):
    """The SSD block of training and prefill, x (B, S, D) -> (B, S, D).
    With `return_state`, also (conv tail (B, K - 1, d_inner), SSD state
    (B, H, N, P) f32) for the prefill -> decode handoff."""
    hdd = layers.rms_norm(x, p.norm, cfg.norm_eps)
    y, z, xin_raw, state = _ssd(p, hdd, x.dtype, cfg,
                                return_state=return_state)
    out = _gated_out(p, y, z, x, cfg)
    if return_state:
        return out, (conv_tail(xin_raw), state[0])
    return out


def tp_mamba_block(p, x, cfg: ModelConfig, tp):
    """`mamba_block` of the stream's S-shard x (B, S/m, D) over `model`
    (`models.parallel.TP`): head-parallel where the heads and d_inner
    split over it (`wx`, `wz`, `conv` by channels and `wdt` by heads;
    `wB`, `wC` and the per-head vectors whole, each rank scanning its
    heads over the whole sequence; `out_norm`'s mean of squares summed
    over the ranks; `wo` row-parallel back to the S-shard), else whole
    on its leaves gathered at use (the S-shard of the output kept)."""
    di, h, _ = _dims(cfg)
    if h % tp.size or di % tp.size:
        return parallel.whole_block(mamba_block, p, x, tp, cfg)
    dt_ = x.dtype
    hdd = tp.seq_gather(layers.rms_norm(x, p.norm, cfg.norm_eps))
    y, z, _, _ = _ssd(p, hdd, dt_, cfg, tp.rank * (h // tp.size))
    y = parallel.sharded_rms_norm(y * F.silu(z.to(torch.float32)).to(dt_),
                                  p.out_norm, cfg.norm_eps, tp, di)
    return x + tp.seq_scatter(y @ p.wo.to(dt_))


def conv_tail(x):
    """The last K - 1 positions of x (B, S, C), zero-padded on the left
    when S is shorter."""
    s = x.shape[1]
    if s < CONV_K - 1:
        return F.pad(x, (0, 0, CONV_K - 1 - s, 0))
    return x[:, s - (CONV_K - 1):]


def mamba_decode_step(p, x, cfg: ModelConfig, conv_buf, ssd_state,
                      tp=None):
    """One token, x (B, 1, D); conv_buf (B, K - 1, d_inner); ssd_state
    (B, H, N, P) f32. Returns (x_out, new conv_buf, new ssd_state). With
    `tp` (`models.parallel.TP`, the heads split over `model`) `p`'s
    leaves, conv_buf and ssd_state are the rank's channels and heads,
    `out_norm` sums its squares over the ranks and the output is summed
    over them."""
    di, h, n = _dims(cfg)
    b = x.shape[0]
    hl = h if tp is None else h // tp.size
    heads = slice(0, h) if tp is None else \
        slice(tp.rank * hl, (tp.rank + 1) * hl)
    hdd = layers.rms_norm(x, p.norm, cfg.norm_eps)
    xin, z, bm, cm, dt = _ssd_inputs(p, hdd, cfg,
                                     None if tp is None else heads)
    seqbuf = torch.cat([conv_buf, xin], dim=1)               # (B, K, di')
    conv = (seqbuf.to(torch.float32) * p.conv.to(torch.float32)).sum(1)
    xh = F.silu(conv).to(x.dtype).reshape(b, hl, P_HEAD)
    dt1 = dt[:, 0]                                           # (B, H')
    log_a = -torch.exp(p.A_log[heads].to(torch.float32)) * dt1
    k = bm[:, 0, None, :].expand(b, hl, n)
    q = cm[:, 0, None, :].expand(b, hl, n)
    y, ssd_state, _ = ssm_common.linear_attention_step(
        ssd_state, q, k, xh * dt1[..., None], log_a)
    y = y + xh.to(torch.float32) \
        * p.D_skip[heads].to(torch.float32)[:, None]
    y = y.reshape(b, 1, hl * P_HEAD).to(x.dtype)
    if tp is None:
        return _gated_out(p, y, z, x, cfg), seqbuf[:, 1:], ssd_state
    return _sharded_out(p, y, z, x, cfg, tp), seqbuf[:, 1:], ssd_state


def _sharded_out(p, y, z, x, cfg: ModelConfig, tp):
    """`_gated_out` of the rank's channels y, z: `out_norm`'s mean of
    squares summed over `model`, `wo` row-parallel and its output summed
    over `model` (the replicated stream of serving)."""
    dt_ = x.dtype
    y = parallel.sharded_rms_norm(y * F.silu(z.to(torch.float32)).to(dt_),
                                  p.out_norm, cfg.norm_eps, tp,
                                  _dims(cfg)[0])
    return x + tp.sum(y @ p.wo.to(dt_))


def _heads_split(cfg: ModelConfig, tp) -> bool:
    di, h, _ = _dims(cfg)
    return tp.splits(h) and tp.splits(di)


def serve_mamba_block(p, x, cfg: ModelConfig, tp, conv_place):
    """Prefill's Mamba2 block of the replicated stream x (b, S, D) over
    `model` -> (out, this rank's block of the conv tail, of the SSD
    state). Head-parallel where the heads and d_inner split (each rank
    scans its heads); else whole on its leaves gathered at use, the conv
    tail cut to the cache's block (`conv_place`, its channels: d_inner
    may split where the heads do not)."""
    if _heads_split(cfg, tp):
        h = _dims(cfg)[1]
        hdd = layers.rms_norm(x, p.norm, cfg.norm_eps)
        y, z, xin_raw, state = _ssd(p, hdd, x.dtype, cfg,
                                    tp.rank * (h // tp.size),
                                    return_state=True)
        return _sharded_out(p, y, z, x, cfg, tp), conv_tail(xin_raw), \
            state[0]
    out, (tail, state) = mamba_block(p.regather(("data", "model")), x, cfg,
                                     return_state=True)
    c0, cn = conv_place
    return out, tail[..., c0:c0 + cn], state


def serve_mamba_decode(p, x, cfg: ModelConfig, tp, conv_buf, ssd_state,
                       conv_place):
    """Decode's Mamba2 step over `model` on the rank's cache blocks ->
    (out, conv block, SSD state): head-parallel where the heads split,
    else whole on its leaves and the conv tail gathered at use, the new
    tail cut back to the rank's channels."""
    if _heads_split(cfg, tp):
        return mamba_decode_step(p, x, cfg, conv_buf, ssd_state, tp)
    di = _dims(cfg)[0]
    if tp.splits(di):
        conv_buf = fsdp.all_gather_dim(conv_buf, tp.group, 2)
    out, conv, ssd_state = mamba_decode_step(
        p.regather(("data", "model")), x, cfg, conv_buf, ssd_state)
    c0, cn = conv_place
    return out, conv[..., c0:c0 + cn], ssd_state


# ---------------------------------------------------------------------------
# the zamba2 backbone
# ---------------------------------------------------------------------------


def _shared_block(sp, x, cfg: ModelConfig, tables):
    h = layers.rms_norm(x, sp.ln1, cfg.norm_eps)
    x = x + layers.attention_block(sp.attn, h, cfg, tables)
    h = layers.rms_norm(x, sp.ln2, cfg.norm_eps)
    return x + layers.mlp_block(sp.mlp, h, cfg)


def _group(model, g, x, cfg: ModelConfig, tables):
    every = max(cfg.attn_every, 1)
    for lp in model.layers[g * every:(g + 1) * every]:
        x = mamba_block(lp, x, cfg)
    return _shared_block(model.shared, x, cfg, tables)


def forward(model: Zamba, tokens: torch.Tensor, cfg: ModelConfig,
            parallel: ParallelConfig | None = None):
    """Training's forward: tokens (B, S) int -> (logits (B, S, V_pad) f32,
    aux 0), differentiable, each group of `attn_every` layers and its
    shared block under `parallel.remat`."""
    parallel = parallel or ParallelConfig()
    group = transformer.remat(_group, parallel.remat)
    x = common.embed_tokens(model.embed, tokens, cfg)
    tables = transformer.rope_tables(torch.arange(
        tokens.shape[1], dtype=torch.int32, device=x.device), cfg)
    for g in range(_n_inv(cfg)):
        x = group(model, g, x, cfg, tables)
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    return common.lm_head(model.unembed_table(), x, cfg), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def _tp_group(model, g, x, cfg: ModelConfig, tables, tp):
    every = max(cfg.attn_every, 1)
    for lp in model.layers[g * every:(g + 1) * every]:
        x = tp_mamba_block(lp, x, cfg, tp)
    return parallel.tp_decoder_layer(model.shared, x, cfg, tables, tp)[0]


def tp_forward(view, tokens: torch.Tensor, cfg: ModelConfig,
               parallel_cfg: ParallelConfig, tp):
    """zamba2's forward over `model` ranks (`models.parallel`): the stream
    S-sharded, the Mamba2 blocks `tp_mamba_block`, the shared block the
    dense family's tensor-parallel layer, vocab-parallel embedding and
    head: tokens (B, S) -> (logits (B, S, V_pad/m) f32, aux 0)."""
    s = tokens.shape[1]
    parallel.check_tp(cfg, s, tp)
    group = transformer.remat(_tp_group, parallel_cfg.remat)
    x = parallel.vocab_parallel_embed(view.embed, tokens, cfg, tp)
    tables = transformer.rope_tables(torch.arange(
        s, dtype=torch.int32, device=x.device), cfg)
    for g in range(_n_inv(cfg)):
        x = group(view, g, x, cfg, tables, tp)
    return parallel.tp_logits(view, x, cfg, tp), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache's `sharding.LeafDef`s, the reference's
    (`zamba_cache_defs`): conv (L, B, K - 1, d_inner) in `cfg.dtype` by
    `ssm_inner`, ssd (L, B, H, N, P) f32 by `ssm_heads`, k and v
    (n_inv, B, max_len, KH, hd) by `kv_heads` or `kv_seq`
    (`sharding.kv_cache_logical`), length (B,)."""
    di, h, n = _dims(cfg)
    kv = shd.LeafDef((_n_inv(cfg), batch, max_len, cfg.num_kv_heads,
                      cfg.resolved_head_dim), cfg.dtype,
                     shd.kv_cache_logical(cfg.num_kv_heads, None))
    return {"conv": shd.LeafDef((cfg.num_layers, batch, CONV_K - 1, di),
                                cfg.dtype,
                                ("layers", "batch", None, "ssm_inner")),
            "ssd": shd.LeafDef((cfg.num_layers, batch, h, n, P_HEAD),
                               "float32",
                               ("layers", "batch", "ssm_heads", None, None)),
            "k": kv, "v": kv,
            "length": shd.LeafDef((batch,), "int32", ("batch",))}


@torch.inference_mode()
def prefill(model: Zamba, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens (B, S) int -> (last-token logits (B, 1, V_pad) f32, cache)."""
    b, s = tokens.shape
    every = max(cfg.attn_every, 1)
    x = common.embed_tokens(model.embed, tokens, cfg)
    tables = transformer.rope_tables(torch.arange(
        s, dtype=torch.int32, device=x.device), cfg)
    cache = transformer.new_cache(cache_defs(
        cfg, b, s + transformer.PREFILL_EXTRA), x.device)
    cache["length"].fill_(s)
    sp = model.shared
    for i, lp in enumerate(model.layers):
        x, (tail, state) = mamba_block(lp, x, cfg, return_state=True)
        cache["conv"][i] = tail
        cache["ssd"][i] = state
        if (i + 1) % every:
            continue
        g = i // every
        h = layers.rms_norm(x, sp.ln1, cfg.norm_eps)
        q = layers.project_q(sp.attn, h, cfg)
        k, v = layers.project_kv(sp.attn, h, cfg)
        q, k = transformer.rope(q, k, tables)
        x = x + layers.project_out(sp.attn,
                                   layers.causal_self_attention(q, k, v))
        h = layers.rms_norm(x, sp.ln2, cfg.norm_eps)
        x = x + layers.mlp_block(sp.mlp, h, cfg)
        cache["k"][g, :, :s] = k
        cache["v"][g, :, :s] = v
    x = layers.rms_norm(x[:, -1:], model.ln_f, cfg.norm_eps)
    return common.lm_head(model.unembed_table(), x, cfg), cache


@torch.inference_mode()
def decode_step(model: Zamba, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decode step, tokens (B, 1) int; the cache as `prefill` returns
    it, updated IN PLACE (conv tails, SSD states, the K/V slot of each
    invocation, `length`) and returned. Returns (logits (B, 1, V_pad)
    f32, cache)."""
    b = tokens.shape[0]
    every = max(cfg.attn_every, 1)
    pos = cache["length"]
    x = common.embed_tokens(model.embed, tokens, cfg)
    rows = torch.arange(b, device=x.device)
    slot = torch.clamp(pos, max=cache["k"].shape[2] - 1).long()
    tables = transformer.rope_tables(pos[:, None], cfg)
    sp = model.shared
    for i, lp in enumerate(model.layers):
        x, conv, ssd = mamba_decode_step(lp, x, cfg, cache["conv"][i],
                                         cache["ssd"][i])
        cache["conv"][i] = conv
        cache["ssd"][i] = ssd
        if (i + 1) % every:
            continue
        g = i // every
        h = layers.rms_norm(x, sp.ln1, cfg.norm_eps)
        q = layers.project_q(sp.attn, h, cfg)
        k_new, v_new = layers.project_kv(sp.attn, h, cfg)
        q, k_new = transformer.rope(q, k_new, tables)
        cache["k"][g, rows, slot] = k_new[:, 0]
        cache["v"][g, rows, slot] = v_new[:, 0]
        att = layers.decode_attention(q, cache["k"][g], cache["v"][g],
                                      pos + 1)
        x = x + layers.project_out(sp.attn, att)
        h = layers.rms_norm(x, sp.ln2, cfg.norm_eps)
        x = x + layers.mlp_block(sp.mlp, h, cfg)
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = common.lm_head(model.unembed_table(), x, cfg)
    cache["length"] += 1
    return logits, cache


@torch.inference_mode()
def mesh_prefill(view, tokens: torch.Tensor, cfg: ModelConfig, sm):
    """zamba2's prefill over a serving mesh (`models.parallel.ServeMesh`):
    tokens (b, S) of this rank's rows -> (vocab-sharded last logits,
    this rank's cache blocks: conv by `ssm_inner`, ssd by `ssm_heads`, the
    shared block's K/V by `kv_heads` or `kv_seq`)."""
    b, s = tokens.shape
    every = max(cfg.attn_every, 1)
    tp = sm.tp
    defs = cache_defs(cfg, sm.batch, s + transformer.PREFILL_EXTRA)
    cache = sm.new_cache(defs, tokens.device)
    cache["length"].fill_(s)
    place = sm.place("kv", defs["k"])
    conv_place = sm.kv["conv"] = sm.block(defs["conv"])[3]
    x = parallel.serve_embed(view.embed, tokens, cfg, tp)
    tables = transformer.rope_tables(torch.arange(
        s, dtype=torch.int32, device=x.device), cfg)
    sp = view.shared
    for i, lp in enumerate(view.layers):
        x, tail, state = serve_mamba_block(lp, x, cfg, tp, conv_place)
        cache["conv"][i] = tail
        cache["ssd"][i] = state
        if (i + 1) % every:
            continue
        g = i // every
        h = layers.rms_norm(x, sp.ln1, cfg.norm_eps)
        att, k, v = parallel.serve_attention(sp.attn, h, cfg, tables, tp)
        x = x + att
        x = x + parallel.serve_mlp(
            sp.mlp, layers.rms_norm(x, sp.ln2, cfg.norm_eps), cfg, tp)
        for name, t in (("k", k), ("v", v)):
            blk = parallel.prefill_kv_block(t, place, cfg, tp)
            cache[name][g, :, :blk.shape[1]] = blk
    return parallel.serve_logits(view, x[:, -1:], cfg, tp), cache


@torch.inference_mode()
def mesh_decode_step(view, cache: dict, tokens: torch.Tensor,
                     cfg: ModelConfig, sm):
    """One decode step over a serving mesh, tokens (b, 1) of this rank's
    rows; its cache blocks updated IN PLACE. Returns (vocab-sharded
    logits, cache)."""
    every = max(cfg.attn_every, 1)
    tp, place, conv_place = sm.tp, sm.kv["kv"], sm.kv["conv"]
    pos = cache["length"]
    x = parallel.serve_embed(view.embed, tokens, cfg, tp)
    slot = parallel.decode_slot(pos, place, 0)
    tables = transformer.rope_tables(pos[:, None], cfg)
    sp = view.shared
    for i, lp in enumerate(view.layers):
        x, conv, ssd = serve_mamba_decode(lp, x, cfg, tp, cache["conv"][i],
                                          cache["ssd"][i], conv_place)
        cache["conv"][i] = conv
        cache["ssd"][i] = ssd
        if (i + 1) % every:
            continue
        g = i // every
        h = layers.rms_norm(x, sp.ln1, cfg.norm_eps)
        x = x + parallel.decode_attention_layer(
            sp.attn, h, cache["k"][g], cache["v"][g], pos, slot, tables,
            place, cfg, tp)
        x = x + parallel.serve_mlp(
            sp.mlp, layers.rms_norm(x, sp.ln2, cfg.norm_eps), cfg, tp)
    logits = parallel.serve_logits(view, x, cfg, tp)
    cache["length"] += 1
    return logits, cache
