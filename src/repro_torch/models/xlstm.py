"""xLSTM blocks (counterpart of `repro.models.xlstm`): mLSTM (matrix
memory, through the chunked linear attention of `ssm_common`) and sLSTM
(scalar memory, a true recurrence).

Every `slstm_every`-th block is an sLSTM, the rest mLSTM; `d_ff = 0`:
the capacity lives in the blocks' up and down projections (factor 2 for
the mLSTM, a 4/3 GELU-gated MLP after the sLSTM). The mLSTM's
exponential input gate is clamped, and its normaliser keeps magnitudes
bounded.

`XLSTM` holds the parameters: `blocks`, a `ModuleList` of `MLSTMBlock`s
and `SLSTMBlock`s whose `kind` is the reference's key (`"kind_mlstm"` or
`"kind_slstm"`: its tree is a tuple of `{kind: params}` dicts), `embed`,
`ln_f` (the embeddings are tied). A serving model keeps the mLSTM's
convolution taps and the sLSTM's gate weights in f32, as the reference
reads them.

The sLSTM's recurrence is a Python loop over time steps (the reference
scans it with `lax.scan`; it has no Pallas kernel, so no CUDA kernel
here): the input's gate products are one product over all steps before
the loop, the recurrent ones (batched over heads) one a step.

Numerics follow the reference: prefill's mLSTM projections are f32
products cast to the activation dtype (q, k, v) or kept in f32 (the
gates), decode's are products in the activation dtype, rounded to it,
gates included (`mlstm_decode_step`). The prefill state hands decode
`m = max(m, -1e30)`, so that the cache holds no -inf.

The cache: {"blocks": one dict a block, {"mlstm": {"conv" (B, K - 1,
d_inner) in the activation dtype, "S" (B, H, dh, dh) f32, "n" (B, H,
dh) f32}} or {"slstm": {"c", "n", "m", "h"}, each (B, H, dh) f32},
"length" (B,) int32}. Decode replaces each block's entries and returns
the same dict.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import resolve_device
from repro_torch.core import fsdp
from repro_torch.models import (common, layers, parallel, ssm_common,
                                 transformer)
from repro_torch.models.mamba import CONV_K, conv1d, conv_tail

EXP_CLAMP = 10.0


def _mdims(cfg: ModelConfig):
    di = 2 * cfg.d_model
    return di, cfg.num_heads, di // cfg.num_heads


def mlstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, _ = _mdims(cfg)
    return {"norm": (d,), "wu": (d, di), "wz": (d, di), "conv": (CONV_K, di),
            "wq": (di, di), "wk": (di, di), "wv": (di, di), "wi": (di, h),
            "wf": (di, h), "f_bias": (h,), "out_norm": (di,), "wo": (di, d)}


def slstm_defs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    dh, fup = d // h, (4 * d) // 3
    return {"norm": (d,), "w_gates": (d, 4, h, dh),
            "r_gates": (h, dh, 4, dh), "b_gates": (4, h, dh),
            "out_norm": (d,), "w_up1": (d, fup), "w_up2": (d, fup),
            "w_down": (fup, d)}


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return bool(cfg.slstm_every) and i % cfg.slstm_every \
        == cfg.slstm_every - 1


def xlstm_defs(cfg: ModelConfig) -> dict:
    """Parameter shapes in the reference's tree: `blocks` a tuple of
    `{"kind_slstm": ...}` or `{"kind_mlstm": ...}` dicts."""
    blocks = tuple({"kind_slstm": slstm_defs(cfg)} if _is_slstm(cfg, i)
                   else {"kind_mlstm": mlstm_defs(cfg)}
                   for i in range(cfg.num_layers))
    return {"blocks": blocks, **common.embed_defs(cfg)}


class MLSTMBlock(nn.Module):
    kind = "kind_mlstm"

    def __init__(self, cfg: ModelConfig, device=None, train: bool = False):
        super().__init__()
        common.add_params(self, mlstm_defs(cfg), cfg, device, train,
                          keep_f32=("conv",))


class SLSTMBlock(nn.Module):
    kind = "kind_slstm"

    def __init__(self, cfg: ModelConfig, device=None, train: bool = False):
        super().__init__()
        common.add_params(self, slstm_defs(cfg), cfg, device, train,
                          keep_f32=("w_gates", "r_gates", "b_gates"))


class XLSTM(nn.Module):
    """Parameters of an xLSTM on `device` (default: the card; raises
    without one unless `device="cpu"`), uninitialised until
    `common.init_params` or `convert.params_from_numpy` fills them; for
    serving, or with `train=True` for training."""

    STACKS = ()
    defs = staticmethod(xlstm_defs)

    def __init__(self, cfg: ModelConfig, device=None, train: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            (SLSTMBlock if _is_slstm(cfg, i) else MLSTMBlock)(cfg, device,
                                                              train)
            for i in range(cfg.num_layers))
        common.add_params(self, common.embed_defs(cfg), cfg, device, train)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed_table(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _up(p, x, cfg: ModelConfig):
    """The block's norm and its two up projections, in x's dtype."""
    hn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    return hn @ p.wu.to(x.dtype), hn @ p.wz.to(x.dtype)


def _mlstm_out(p, y, z, x, cfg: ModelConfig):
    """x + (rms_norm(y) * silu(z)) @ wo."""
    dt = x.dtype
    y = layers.rms_norm(y, p.out_norm, cfg.norm_eps)
    y = y * F.silu(z.to(torch.float32)).to(dt)
    return x + y @ p.wo.to(dt)


def mlstm_block(p, x, cfg: ModelConfig, return_state: bool = False):
    """x (B, S, D) -> (B, S, D); with `return_state` also (conv tail,
    S (B, H, dh, dh), n (B, H, dh)) for the prefill -> decode handoff."""
    di, h, dh = _mdims(cfg)
    b, s, _ = x.shape
    dt = x.dtype
    u, z = _up(p, x, cfg)
    cu = F.silu(conv1d(u, p.conv).to(torch.float32)).to(dt)
    shp = (b, s, h, dh)
    q = (cu @ p.wq.to(dt)).reshape(shp)
    k = (cu @ p.wk.to(dt)).reshape(shp)
    v = (u @ p.wv.to(dt)).reshape(shp)
    i_pre = common.dot_f32(cu, p.wi.to(dt))
    f_pre = common.dot_f32(cu, p.wf.to(dt)) + p.f_bias.to(torch.float32)
    igate = torch.exp(torch.clamp(i_pre, max=EXP_CLAMP))
    k = k * (igate[..., None] / math.sqrt(dh)).to(k.dtype)
    res = ssm_common.chunked_linear_attention(
        q, k, v, F.logsigmoid(f_pre), chunk=min(128, s), normalize=True,
        return_state=return_state)
    y, state = res if return_state else (res, None)
    out = _mlstm_out(p, y.reshape(b, s, di).to(dt), z, x, cfg)
    if return_state:
        return out, (conv_tail(u), state[0], state[1])
    return out


def tp_mlstm_block(p, x, cfg: ModelConfig, tp):
    """`mlstm_block` of the stream's S-shard x (B, S/m, D) over `model`
    (`models.parallel.TP`), where the heads split over it: `wu`, `wz` and
    `conv` by channels (the rank's heads'), `wq`, `wk`, `wv`, `wi` and
    `wf` by their input rows, so each product is a partial sum over the
    ranks, reduce-scattered to the rank's heads; each rank scans its
    heads, `out_norm`'s mean of squares is summed over the ranks and `wo`
    is row-parallel back to the S-shard. Else whole on its leaves
    gathered at use."""
    di, h, dh = _mdims(cfg)
    m = tp.size
    if h % m:
        return parallel.whole_block(mlstm_block, p, x, tp, cfg)
    b, s = x.shape[0], x.shape[1] * m
    dt = x.dtype
    hn = tp.seq_gather(layers.rms_norm(x, p.norm, cfg.norm_eps))
    u, z = hn @ p.wu.to(dt), hn @ p.wz.to(dt)
    cu = F.silu(conv1d(u, p.conv).to(torch.float32)).to(dt)

    def heads(part):          # partial (B, S, n) -> summed, own heads
        return fsdp.scatter_sum(part, tp.group, 2)

    shp = (b, s, h // m, dh)
    q = heads(cu @ p.wq.to(dt)).reshape(shp)
    k = heads(cu @ p.wk.to(dt)).reshape(shp)
    v = heads(u @ p.wv.to(dt)).reshape(shp)
    own = slice(tp.rank * (h // m), (tp.rank + 1) * (h // m))
    i_pre = heads(common.dot_f32(cu, p.wi.to(dt)))
    f_pre = heads(common.dot_f32(cu, p.wf.to(dt))) \
        + p.f_bias[own].to(torch.float32)
    igate = torch.exp(torch.clamp(i_pre, max=EXP_CLAMP))
    k = k * (igate[..., None] / math.sqrt(dh)).to(k.dtype)
    y = ssm_common.chunked_linear_attention(
        q, k, v, F.logsigmoid(f_pre), chunk=min(128, s), normalize=True)
    y = parallel.sharded_rms_norm(y.reshape(b, s, di // m).to(dt),
                                  p.out_norm, cfg.norm_eps, tp, di)
    y = y * F.silu(z.to(torch.float32)).to(dt)
    return x + tp.seq_scatter(y @ p.wo.to(dt))


def mlstm_decode_step(p, x, cfg: ModelConfig, conv_buf, S, n):
    """x (B, 1, D); conv_buf (B, K - 1, d_inner); S (B, H, dh, dh); n (B,
    H, dh). Returns (x_out, conv_buf, S, n). The projections, the gates'
    included, are products in x's dtype, as the reference's einsums
    without `preferred_element_type`."""
    di, h, dh = _mdims(cfg)
    b = x.shape[0]
    dt = x.dtype
    u, z = _up(p, x, cfg)
    seqbuf = torch.cat([conv_buf, u], dim=1)
    cu = F.silu((seqbuf.to(torch.float32)
                 * p.conv.to(torch.float32)).sum(1)).to(dt)   # (B, di)
    shp = (b, h, dh)
    q = (cu @ p.wq.to(dt)).reshape(shp)
    k = (cu @ p.wk.to(dt)).reshape(shp)
    v = (u[:, 0] @ p.wv.to(dt)).reshape(shp)
    i_pre = cu @ p.wi.to(dt)
    f_pre = (cu @ p.wf.to(dt)) + p.f_bias.to(torch.float32)
    igate = torch.exp(torch.clamp(i_pre.to(torch.float32), max=EXP_CLAMP))
    k = k * (igate[..., None] / math.sqrt(dh)).to(k.dtype)
    y, S, n = ssm_common.linear_attention_step(
        S, q, k, v, F.logsigmoid(f_pre.to(torch.float32)), norm_state=n,
        normalize=True)
    out = _mlstm_out(p, y.reshape(b, 1, di).to(dt), z, x, cfg)
    return out, seqbuf[:, 1:], S, n


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_cell(gates, state):
    """gates (B, H, 4, dh) pre-activations [z, i, f, o]; state (c, n, m,
    h) -> the new state."""
    c, n, m, _ = state
    zp, ip, fp, op = gates.unbind(2)
    z = torch.tanh(zp)
    o = torch.sigmoid(op)
    fpm = fp + m          # the reference's fp + m, once for both uses
    m_new = torch.maximum(fpm, ip)
    i = torch.exp(ip - m_new)
    f = torch.exp(fpm - m_new)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return c_new, n_new, m_new, h_new


def _input_gates(p, hn):
    """hn (B, S, D) -> its gate products (S, B, H, 4, dh) f32, all steps
    in one product: the reference's einsum("bd,dghe->bhge") a step."""
    w = p.w_gates.to(torch.float32)                       # (D, 4, H, dh)
    d, _, h, dh = w.shape
    wx = hn.to(torch.float32).transpose(0, 1) @ w.reshape(d, -1)
    return wx.reshape(*wx.shape[:2], 4, h, dh).transpose(2, 3)


def _recurrent_gates(p, wx_t, h_prev):
    """wx_t (B, H, 4, dh) + h_prev (B, H, dh) @ r_gates (H, dh, 4, dh),
    batched over heads, + b_gates (4, H, dh)."""
    r = p.r_gates.to(torch.float32)
    h, dh = r.shape[0], r.shape[1]
    wr = torch.bmm(h_prev.transpose(0, 1), r.reshape(h, dh, 4 * dh))
    wr = wr.reshape(h, -1, 4, dh).transpose(0, 1)
    return wx_t + wr + p.b_gates.to(torch.float32).transpose(0, 1)[None]


def _slstm_ffn(p, hs, dt, cfg: ModelConfig):
    """The GELU-gated MLP of rms_norm(hs) (hs (B, S, D) f32) in `dt`."""
    y = layers.rms_norm(hs.to(dt), p.out_norm, cfg.norm_eps)
    u1 = common.dot_f32(y, p.w_up1.to(dt))
    u2 = common.dot_f32(y, p.w_up2.to(dt))
    g = (F.gelu(u1, approximate="tanh") * u2).to(dt)
    return g @ p.w_down.to(dt)


def _slstm_mlp(p, hs, x, cfg: ModelConfig):
    """x + the GELU-gated MLP of rms_norm(hs) (hs (B, S, D) f32)."""
    return x + _slstm_ffn(p, hs, x.dtype, cfg)


def slstm_block(p, x, cfg: ModelConfig, return_state: bool = False):
    """x (B, S, D) -> (B, S, D), the recurrence a Python loop over the S
    steps; with `return_state` also the final (c, n, m, h)."""
    b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    hn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    z0 = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    state = (z0, z0, torch.full_like(z0, -math.inf), z0)
    hs, state = _slstm_scan(p, hn, state)
    out = _slstm_mlp(p, hs.reshape(b, s, d), x, cfg)
    if return_state:
        return out, state
    return out


def _slstm_scan(p, hn, state):
    """The recurrence over the steps of hn (B, S, D) for the heads of
    `p`'s gate leaves -> (h (B, S, H', dh) f32, the final state)."""
    hs = []
    # the steps' input gates by one unbind (its backward stacks their
    # gradients once; an index a step would add a zero-filled gradient of
    # all the steps a step)
    for wx_t in _input_gates(p, hn).unbind(0):
        state = _slstm_cell(_recurrent_gates(p, wx_t, state[3]), state)
        hs.append(state[3])
    return torch.stack(hs, dim=1), state


def tp_slstm_block(p, x, cfg: ModelConfig, tp):
    """`slstm_block` of the stream's S-shard x (B, S/m, D) over `model`,
    where the heads split over it: `w_gates`, `r_gates` and `b_gates` by
    heads, so each rank runs its heads' recurrence over the whole
    sequence; their outputs are gathered over `model` for `out_norm`
    (over all of D) and the MLP, ff-parallel (`w_up1`/`w_up2` by
    columns, `w_down` by rows) where ff splits, else whole with the
    output cut. Else the block is whole on its leaves gathered at use."""
    b, s_loc, d = x.shape
    h = cfg.num_heads
    if h % tp.size:
        return parallel.whole_block(slstm_block, p, x, tp, cfg)
    hn = tp.seq_gather(layers.rms_norm(x, p.norm, cfg.norm_eps))
    z0 = torch.zeros((b, h // tp.size, d // h), dtype=torch.float32,
                     device=x.device)
    hs, _ = _slstm_scan(p, hn, (z0, z0, torch.full_like(z0, -math.inf),
                                z0))
    hs = fsdp.gather(hs.reshape(b, hn.shape[1], -1), tp.group, 2)
    fup = (4 * d) // 3
    return x + tp.back_to_stream(_slstm_ffn(p, hs, x.dtype, cfg),
                                 fup % tp.size == 0)


def slstm_decode_step(p, x, cfg: ModelConfig, state):
    """x (B, 1, D); state (c, n, m, h). Returns (x_out, the new state)."""
    b, _, d = x.shape
    hn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    state = _slstm_cell(_recurrent_gates(p, _input_gates(p, hn)[0],
                                         state[3]), state)
    return _slstm_mlp(p, state[3].reshape(b, 1, d), x, cfg), state


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _block(bp, x, cfg: ModelConfig):
    if bp.kind == SLSTMBlock.kind:
        return slstm_block(bp, x, cfg)
    return mlstm_block(bp, x, cfg)


def forward(model: XLSTM, tokens: torch.Tensor, cfg: ModelConfig,
            parallel: ParallelConfig | None = None):
    """Training's forward: tokens (B, S) int -> (logits (B, S, V_pad) f32,
    aux 0), differentiable, each block under `parallel.remat`."""
    parallel = parallel or ParallelConfig()
    block = transformer.remat(_block, parallel.remat)
    x = common.embed_tokens(model.embed, tokens, cfg)
    for bp in model.blocks:
        x = block(bp, x, cfg)
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    return common.lm_head(model.unembed_table(), x, cfg), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def _tp_block(bp, x, cfg: ModelConfig, tp):
    if bp.kind == SLSTMBlock.kind:
        return tp_slstm_block(bp, x, cfg, tp)
    return tp_mlstm_block(bp, x, cfg, tp)


def tp_forward(view, tokens: torch.Tensor, cfg: ModelConfig,
               parallel_cfg: ParallelConfig, tp):
    """The forward over `model` ranks (`models.parallel`): the stream
    S-sharded, each block head-parallel (`tp_mlstm_block`,
    `tp_slstm_block`), the tied embedding and head vocab-parallel: tokens
    (B, S) -> (logits (B, S, V_pad/m) f32, aux 0)."""
    parallel.check_tp(cfg, tokens.shape[1], tp)
    block = transformer.remat(_tp_block, parallel_cfg.remat)
    x = parallel.vocab_parallel_embed(view.embed, tokens, cfg, tp)
    for bp in view.blocks:
        x = block(bp, x, cfg, tp)
    return parallel.tp_logits(view, x, cfg, tp), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def cache_defs(cfg: ModelConfig, batch: int) -> dict:
    """The cache's `sharding.LeafDef`s, the reference's
    (`xlstm_cache_defs`): an mLSTM block's conv (B, K - 1, d_inner) in
    `cfg.dtype` by `ssm_inner`, S (B, H, dh, dh) and n (B, H, dh) f32 by
    `heads`; an sLSTM block's c, n, m, h (B, H, D / H) f32 by `heads`;
    length (B,)."""
    di, h, dh = _mdims(cfg)
    blocks = []
    for i in range(cfg.num_layers):
        if _is_slstm(cfg, i):
            st = shd.LeafDef((batch, cfg.num_heads,
                              cfg.d_model // cfg.num_heads), "float32",
                             ("batch", "heads", None))
            blocks.append({"slstm": {"c": st, "n": st, "m": st, "h": st}})
        else:
            blocks.append({"mlstm": {
                "conv": shd.LeafDef((batch, CONV_K - 1, di), cfg.dtype,
                                    ("batch", None, "ssm_inner")),
                "S": shd.LeafDef((batch, h, dh, dh), "float32",
                                 ("batch", "heads", None, None)),
                "n": shd.LeafDef((batch, h, dh), "float32",
                                 ("batch", "heads", None))}})
    return {"blocks": blocks,
            "length": shd.LeafDef((batch,), "int32", ("batch",))}


@torch.inference_mode()
def prefill(model: XLSTM, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens (B, S) int -> (last-token logits (B, 1, V_pad) f32, cache)."""
    b, s = tokens.shape
    x = common.embed_tokens(model.embed, tokens, cfg)
    blocks = []
    for bp in model.blocks:
        if bp.kind == SLSTMBlock.kind:
            x, (c, n, m, h) = slstm_block(bp, x, cfg, return_state=True)
            # a finite stabiliser, so that the cache holds no -inf
            blocks.append({"slstm": {"c": c, "n": n,
                                     "m": torch.clamp(m, min=-1e30),
                                     "h": h}})
        else:
            x, (conv, S, n) = mlstm_block(bp, x, cfg, return_state=True)
            blocks.append({"mlstm": {"conv": conv, "S": S, "n": n}})
    x = layers.rms_norm(x[:, -1:], model.ln_f, cfg.norm_eps)
    length = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return common.lm_head(model.unembed_table(), x, cfg), \
        {"blocks": blocks, "length": length}


@torch.inference_mode()
def decode_step(model: XLSTM, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig):
    """One decode step, tokens (B, 1) int; each block's entries of the
    cache replaced by its new state, `length` advanced in place. Returns
    (logits (B, 1, V_pad) f32, cache)."""
    x = common.embed_tokens(model.embed, tokens, cfg)
    for bp, bc in zip(model.blocks, cache["blocks"], strict=True):
        if bp.kind == SLSTMBlock.kind:
            st = bc["slstm"]
            x, state = slstm_decode_step(
                bp, x, cfg, (st["c"], st["n"], st["m"], st["h"]))
            bc["slstm"] = dict(zip("cnmh", state, strict=True))
        else:
            st = bc["mlstm"]
            x, conv, S, n = mlstm_decode_step(bp, x, cfg, st["conv"],
                                              st["S"], st["n"])
            bc["mlstm"] = {"conv": conv, "S": S, "n": n}
    x = layers.rms_norm(x, model.ln_f, cfg.norm_eps)
    logits = common.lm_head(model.unembed_table(), x, cfg)
    cache["length"] += 1
    return logits, cache


# ---------------------------------------------------------------------------
# serving over a mesh
# ---------------------------------------------------------------------------


def _whole(p):
    """A block's leaves gathered over `model` too (its heads do not split:
    the block runs whole on every rank)."""
    return p.regather(("data", "model"))


def serve_mlstm_block(p, x, cfg: ModelConfig, tp, conv_place):
    """Prefill's mLSTM block of the replicated stream x (b, S, D) over
    `model` -> (out, the rank's conv tail, S, n): where the heads split,
    `wu`, `wz` and `conv` by channels, the q/k/v/gate products of the
    rank's input rows reduce-scattered to its heads, each rank scanning
    its heads, `out_norm` over split channels and `wo` row-parallel,
    summed over `model`; else whole on its leaves gathered at use."""
    di, h, dh = _mdims(cfg)
    c0, cn = conv_place
    if not tp.splits(h):
        out, (conv, S, n) = mlstm_block(_whole(p), x, cfg,
                                        return_state=True)
        return out, conv[..., c0:c0 + cn], S, n
    m = tp.size
    b, s, _ = x.shape
    dt = x.dtype
    u, z = _up(p, x, cfg)
    cu = F.silu(conv1d(u, p.conv).to(torch.float32)).to(dt)

    def heads(part):          # partial (B, S, n) -> summed, own heads
        return fsdp.reduce_scatter_dim(part, tp.group, 2)

    shp = (b, s, h // m, dh)
    q = heads(cu @ p.wq.to(dt)).reshape(shp)
    k = heads(cu @ p.wk.to(dt)).reshape(shp)
    v = heads(u @ p.wv.to(dt)).reshape(shp)
    own = slice(tp.rank * (h // m), (tp.rank + 1) * (h // m))
    i_pre = heads(common.dot_f32(cu, p.wi.to(dt)))
    f_pre = heads(common.dot_f32(cu, p.wf.to(dt))) \
        + p.f_bias[own].to(torch.float32)
    igate = torch.exp(torch.clamp(i_pre, max=EXP_CLAMP))
    k = k * (igate[..., None] / math.sqrt(dh)).to(k.dtype)
    y, (S, n) = ssm_common.chunked_linear_attention(
        q, k, v, F.logsigmoid(f_pre), chunk=min(128, s), normalize=True,
        return_state=True)
    return _sharded_mlstm_out(p, y.reshape(b, s, di // m).to(dt), z, x,
                              cfg, tp), conv_tail(u), S, n


def _sharded_mlstm_out(p, y, z, x, cfg: ModelConfig, tp):
    """`_mlstm_out` of the rank's channels, `out_norm` over split channels,
    `wo`'s output summed over `model`."""
    dt = x.dtype
    y = parallel.sharded_rms_norm(y, p.out_norm, cfg.norm_eps, tp,
                                  _mdims(cfg)[0])
    y = y * F.silu(z.to(torch.float32)).to(dt)
    return x + tp.sum(y @ p.wo.to(dt))


def serve_mlstm_decode(p, x, cfg: ModelConfig, tp, conv_buf, S, n,
                       conv_place):
    """Decode's mLSTM step over `model` on the rank's state blocks ->
    (out, conv block, S, n), `mlstm_decode_step`'s products in the
    activation dtype; head-parallel where the heads split, else whole
    with the conv tail gathered at use and cut back."""
    di, h, dh = _mdims(cfg)
    c0, cn = conv_place
    if not tp.splits(h):
        if tp.splits(di):
            conv_buf = fsdp.all_gather_dim(conv_buf, tp.group, 2)
        out, conv, S, n = mlstm_decode_step(_whole(p), x, cfg, conv_buf, S,
                                            n)
        return out, conv[..., c0:c0 + cn], S, n
    m = tp.size
    b = x.shape[0]
    dt = x.dtype
    u, z = _up(p, x, cfg)
    seqbuf = torch.cat([conv_buf, u], dim=1)
    cu = F.silu((seqbuf.to(torch.float32)
                 * p.conv.to(torch.float32)).sum(1)).to(dt)  # (B, di/m)

    def heads(part):          # partial (B, n) -> summed, own heads
        return fsdp.reduce_scatter_dim(part, tp.group, 1)

    shp = (b, h // m, dh)
    q = heads(cu @ p.wq.to(dt)).reshape(shp)
    k = heads(cu @ p.wk.to(dt)).reshape(shp)
    v = heads(u[:, 0] @ p.wv.to(dt)).reshape(shp)
    own = slice(tp.rank * (h // m), (tp.rank + 1) * (h // m))
    i_pre = heads(cu @ p.wi.to(dt))
    f_pre = heads(cu @ p.wf.to(dt)) + p.f_bias[own].to(torch.float32)
    igate = torch.exp(torch.clamp(i_pre.to(torch.float32), max=EXP_CLAMP))
    k = k * (igate[..., None] / math.sqrt(dh)).to(k.dtype)
    y, S, n = ssm_common.linear_attention_step(
        S, q, k, v, F.logsigmoid(f_pre.to(torch.float32)), norm_state=n,
        normalize=True)
    out = _sharded_mlstm_out(p, y.reshape(b, 1, di // m).to(dt), z, x, cfg,
                             tp)
    return out, seqbuf[:, 1:], S, n


def _slstm_out(p, hs, x, cfg: ModelConfig, tp):
    """x + the sLSTM's MLP of its heads' outputs gathered over `model`
    (hs (b, s, D/m) f32), ff-parallel and summed where ff splits."""
    hs = fsdp.all_gather_dim(hs, tp.group, 2)
    out = _slstm_ffn(p, hs, x.dtype, cfg)
    return x + (tp.sum(out) if tp.splits((4 * cfg.d_model) // 3) else out)


def serve_slstm_block(p, x, cfg: ModelConfig, tp):
    """Prefill's sLSTM block over `model` -> (out, the rank's state (c, n,
    m, h)): each rank runs its heads' recurrence where the heads split,
    else the block whole on its leaves gathered at use."""
    b, s, d = x.shape
    h = cfg.num_heads
    if not tp.splits(h):
        return slstm_block(_whole(p), x, cfg, return_state=True)
    hn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    z0 = torch.zeros((b, h // tp.size, d // h), dtype=torch.float32,
                     device=x.device)
    hs, state = _slstm_scan(p, hn, (z0, z0, torch.full_like(z0, -math.inf),
                                    z0))
    return _slstm_out(p, hs.reshape(b, s, -1), x, cfg, tp), state


def serve_slstm_decode(p, x, cfg: ModelConfig, tp, state):
    """Decode's sLSTM step over `model` on the rank's heads' state."""
    if not tp.splits(cfg.num_heads):
        return slstm_decode_step(_whole(p), x, cfg, state)
    b = x.shape[0]
    hn = layers.rms_norm(x, p.norm, cfg.norm_eps)
    state = _slstm_cell(_recurrent_gates(p, _input_gates(p, hn)[0],
                                         state[3]), state)
    return _slstm_out(p, state[3].reshape(b, 1, -1), x, cfg, tp), state


@torch.inference_mode()
def mesh_prefill(view, tokens: torch.Tensor, cfg: ModelConfig, sm):
    """xlstm's prefill over a serving mesh (`models.parallel.ServeMesh`):
    tokens (b, S) of this rank's rows -> (vocab-sharded last logits, this
    rank's cache blocks: the mLSTM conv by `ssm_inner`, every state by
    `heads`)."""
    b, s = tokens.shape
    tp = sm.tp
    sm.defs = defs = cache_defs(cfg, sm.batch)
    x = parallel.serve_embed(view.embed, tokens, cfg, tp)
    blocks = []
    for bp, bd in zip(view.blocks, defs["blocks"], strict=True):
        if bp.kind == SLSTMBlock.kind:
            x, (c, n, m, h) = serve_slstm_block(bp, x, cfg, tp)
            blocks.append({"slstm": {"c": c, "n": n,
                                     "m": torch.clamp(m, min=-1e30),
                                     "h": h}})
        else:
            conv_place = sm.kv["conv"] = sm.block(bd["mlstm"]["conv"])[2]
            x, conv, S, n = serve_mlstm_block(bp, x, cfg, tp, conv_place)
            blocks.append({"mlstm": {"conv": conv, "S": S, "n": n}})
    length = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return parallel.serve_logits(view, x[:, -1:], cfg, tp), \
        {"blocks": blocks, "length": length}


@torch.inference_mode()
def mesh_decode_step(view, cache: dict, tokens: torch.Tensor,
                     cfg: ModelConfig, sm):
    """One decode step over a serving mesh, tokens (b, 1) of this rank's
    rows; each block's entries of the cache replaced. Returns
    (vocab-sharded logits, cache)."""
    tp = sm.tp
    x = parallel.serve_embed(view.embed, tokens, cfg, tp)
    for bp, bc in zip(view.blocks, cache["blocks"], strict=True):
        if bp.kind == SLSTMBlock.kind:
            st = bc["slstm"]
            x, state = serve_slstm_decode(
                bp, x, cfg, tp, (st["c"], st["n"], st["m"], st["h"]))
            bc["slstm"] = dict(zip("cnmh", state, strict=True))
        else:
            st = bc["mlstm"]
            x, conv, S, n = serve_mlstm_decode(bp, x, cfg, tp, st["conv"],
                                               st["S"], st["n"],
                                               sm.kv["conv"])
            bc["mlstm"] = {"conv": conv, "S": S, "n": n}
    logits = parallel.serve_logits(view, x, cfg, tp)
    cache["length"] += 1
    return logits, cache
