"""The training forward over a mesh of ranks: parameters gathered at use
(FSDP over `data`) and, for every family, Megatron-style tensor
parallelism over `model` with a sequence-sharded residual stream.

`ShardedView` stands in for a model whose parameters are this rank's
blocks (`core.fsdp.ParamLayout`): reading a parameter from it gathers
the leaf over the given mesh dims at that moment (inside a remat region
the gather is recomputed in the backward, not stored), so a family's own
forward runs unchanged on it. That is the whole of the `(pod, data)`
mesh for every family.

With `model` > 1 each family runs its `tp_forward` (this module's for
the dense and MoE families, `mamba`, `xlstm` and `encdec`'s for theirs),
as the reference's GSPMD lays it out (`repro.models.transformer`,
`seq_shard`):
  - the embedding and the LM head are vocab-parallel, the cross-entropy
    too (`vocab_parallel_cross_entropy`: max, sum of exponentials and
    the gold logit reduced over `model`);
  - between blocks the residual stream is S-sharded over `model`;
    before attention and the MLP the normed stream is all-gathered over
    S (its backward a reduce-scatter), and the blocks' outputs, partial
    sums over the rank's heads or ff columns, are reduce-scattered back
    over S (replacing the all-reduce);
  - q, k, v are split by heads and `wo` by rows; where `kv_heads` does
    not divide `model` the K/V projections stay whole and each rank
    takes, for each of its q heads h, KV head h // (H / KH); the same
    head-parallel attention serves whisper's non-causal encoder and its
    cross-attention, whose K/V come from the gathered encoder output;
  - `wi_gate`/`wi_up`/`wi` are split by `ff`, the MLP's `wo` by rows;
  - the MoE FFN (`tp_moe_ffn`) is expert-parallel where the experts
    divide `model` (the S-shard routes itself; its buffers reach the
    experts' owners by all-to-alls), else ff-parallel on the gathered
    sequence (`models.moe`);
  - where the heads or ff do not divide `model` their leaves are whole
    on every rank (the reference's rule replicates them): the block runs
    whole and each rank keeps its S-shard of the output, the gradients of
    those leaves summed over `model` as any replicated leaf's; a block
    whose leaves `model` does split while its heads do not (zamba2's
    d_inner over heads that do not divide) gathers them at use and runs
    whole (`whole_block`);
  - a norm over channels split over `model` (the SSM blocks' `out_norm`)
    sums its squares over the ranks (`sharded_rms_norm`).
With `attn_mode="cp"` the attention is context-parallel instead
(`layers.context_parallel_attention`): the attention weights are
gathered over `model`, q and the output stay S-sharded and only K and V
are gathered; the MLP is the same ff-sharded one.

The numbers equal the reference's up to the order of f32 sums;
`seq_shard=False` (a replicated stream in the reference) gives the same
numbers and is laid out the same way here.
"""
from __future__ import annotations

import inspect
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import fsdp
from repro_torch.models import common, layers, moe, transformer


class ShardedView:
    """`module`'s parameters (blocks laid out by `layout`, under the names
    `prefix` + their own) read as their leaves gathered over the mesh dims
    `axes`; children as views, a `ModuleList` as a list of views, methods
    and properties bound to the view, anything else the module's own."""

    __slots__ = ("_module", "_prefix", "_layout", "_axes")

    def __init__(self, module: nn.Module, layout, axes=("data",),
                 prefix: str = ""):
        self._module, self._layout = module, layout
        self._axes, self._prefix = tuple(axes), prefix

    def regather(self, axes) -> ShardedView:
        """The same module gathered over other mesh dims."""
        return ShardedView(self._module, self._layout, axes, self._prefix)

    def __getattr__(self, name):
        mod = self._module
        if name in mod._parameters:
            return self._layout.use(self._prefix + name,
                                    mod._parameters[name], self._axes)
        if name in mod._modules:
            sub = mod._modules[name]
            prefix = f"{self._prefix}{name}."
            if isinstance(sub, nn.ModuleList):
                return [ShardedView(m, self._layout, self._axes,
                                    f"{prefix}{i}.")
                        for i, m in enumerate(sub)]
            return ShardedView(sub, self._layout, self._axes, prefix)
        attr = inspect.getattr_static(type(mod), name, None)
        if isinstance(attr, property):
            return attr.fget(self)
        if isinstance(attr, types.FunctionType):
            return types.MethodType(attr, self)
        return getattr(mod, name)


class TP:
    """This rank's tensor-parallel group: the mesh's `model` dim."""

    def __init__(self, layout):
        self.layout = layout
        self.size = layout.size("model")
        self.rank = layout.coord.get("model", 0)
        self.group = layout.group("model") if "model" in layout.shape \
            else None

    def seq_gather(self, x):
        """(B, S/m, ...) -> (B, S, ...); backward reduce-scatters."""
        return fsdp.gather(x, self.group, 1)

    def seq_scatter(self, x):
        """Partial (B, S, ...) -> summed (B, S/m, ...); backward gathers."""
        return fsdp.scatter_sum(x, self.group, 1)

    def seq_shard(self, x):
        """Whole (B, S, ...), the same on every rank -> this rank's rows
        (B, S/m, ...); the backward puts the gradient in those rows."""
        n = x.shape[1] // self.size
        return x.narrow(1, self.rank * n, n)

    def back_to_stream(self, out, partial: bool):
        """A block's output over the whole sequence -> this rank's S-shard:
        summed over the ranks when each holds a part of its heads or ff
        columns (`partial`), cut when its leaves are whole on every rank
        (a dim that does not divide `model`: the reference replicates
        them)."""
        return self.seq_scatter(out) if partial else self.seq_shard(out)


def check_tp(cfg: ModelConfig, seq: int, tp: TP) -> None:
    """Raise where the sequence or the padded vocab does not split over
    `model` (heads, KV heads and ff that do not are computed whole on
    every rank, as the reference replicates their leaves)."""
    m = tp.size
    bad = {name: n for name, n in (("seq", seq),
                                   ("padded vocab",
                                    common.padded_vocab(cfg)))
           if n % m}
    if bad:
        raise ValueError(f"tensor parallelism over model = {m} needs "
                         f"each of {bad} to divide by {m}")


def vocab_parallel_embed(table, tokens, cfg: ModelConfig, tp: TP):
    """The rank's vocab rows (V/m, d) looked up for every token, other
    ranks' tokens zero, summed over `model` and S-sharded: (B, S/m, d) in
    `cfg.dtype`."""
    v_loc = table.shape[0]
    ids = tokens.long() - tp.rank * v_loc
    inside = (ids >= 0) & (ids < v_loc)
    rows = F.embedding(ids.clamp(0, v_loc - 1), table)
    x = torch.where(inside[..., None], rows, 0).to(common.act_dtype(cfg))
    return tp.seq_scatter(x)


def vocab_parallel_logits(table, x, cfg: ModelConfig, tp: TP):
    """x (B, S, d) @ the rank's columns (d, V/m) -> f32 logits, the padded
    vocab tail (global column >= vocab_size) masked to -1e30."""
    logits = common.dot_f32(x, table.to(x.dtype))
    v_loc = logits.shape[-1]
    first = tp.rank * v_loc
    if first + v_loc > cfg.vocab_size:
        cols = torch.arange(first, first + v_loc, device=logits.device)
        logits = torch.where(cols >= cfg.vocab_size, -1e30, logits)
    return logits


def vocab_parallel_cross_entropy(logits, labels, tp: TP):
    """The mean nll of vocab-sharded f32 logits (B, S, V/m): the max, the
    sum of exponentials and the gold logit are reduced over `model`."""
    v_loc = logits.shape[-1]
    gmax = fsdp.all_reduce_max(torch.amax(logits, dim=-1), tp.group)
    sumexp = torch.sum(torch.exp(logits - gmax[..., None]), dim=-1)
    lse = torch.log(fsdp.all_reduce_sum(sumexp, tp.group)) + gmax
    ids = labels.long() - tp.rank * v_loc
    inside = (ids >= 0) & (ids < v_loc)
    gold = torch.gather(logits, -1, ids.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = fsdp.all_reduce_sum(torch.where(inside, gold, 0.0), tp.group)
    return torch.mean(lse - gold)


def _local_kv(k, v, cfg: ModelConfig, tp: TP, q_heads: int):
    """K/V for the rank's q heads: the projections' own heads when they
    are split over `model`, else each q head's KV head h // (H / KH)."""
    if k.shape[2] != cfg.num_kv_heads or q_heads == cfg.num_heads:
        return k, v
    group = cfg.num_heads // cfg.num_kv_heads
    idx = (tp.rank * q_heads + torch.arange(q_heads, device=k.device)) \
        // group
    return k[:, :, idx], v[:, :, idx]


def tp_attention(p, h, cfg: ModelConfig, tables, tp: TP, *,
                 causal: bool = True, kv_x=None):
    """Head-parallel attention of the whole sequence h (B, S, d): the
    rank's heads, a partial sum (B, S, d) of the output projection (every
    head, the whole output, where the heads do not split over `model`).
    Non-causal with `causal=False`; cross-attention over the whole
    sequence `kv_x` (keys and values projected from it; whisper, the one
    family with cross-attention, has no RoPE)."""
    q = layers.project_q(p, h, cfg)
    k, v = layers.project_kv(p, h if kv_x is None else kv_x, cfg)
    if kv_x is None:
        q, k = transformer.rope(q, k, tables)
    k, v = _local_kv(k, v, cfg, tp, q.shape[2])
    if kv_x is not None or not causal:
        out = layers._bidirectional_blocked(q, k, v)
    else:
        out = layers.blocked_causal_attention(q, k, v,
                                              window=cfg.sliding_window)
    return layers.project_out(p, out)


def cp_attention(p, h, cfg: ModelConfig, tables, tp: TP, *,
                 causal: bool = True, kv_x=None):
    """Context-parallel attention of the rank's S-shard h (B, S/m, d),
    every head, weights gathered over `model`: its output rows (B, S/m,
    d), whole. Cross-attention takes its keys and values from the rank's
    S-shard of `kv_x`, gathered over `model` with them."""
    q = layers.project_q(p, h, cfg)
    k, v = layers.project_kv(p, h if kv_x is None else kv_x, cfg)
    if kv_x is None:
        q, k = transformer.rope(q, k, tables)
    out = layers.context_parallel_attention(
        q, k, v, group=tp.group, causal=causal and kv_x is None,
        window=cfg.sliding_window)
    return layers.project_out(p, out)


def attention_half(p, h, cfg: ModelConfig, tables, tp: TP,
                   attn_mode: str = "auto", *, causal: bool = True,
                   kv_shard=None, kv_full=None):
    """A block's attention of the normed S-shard h (B, S/m, d), back on
    the stream's S-shard: head-parallel over the gathered sequence (the
    partial outputs reduce-scattered; where the heads do not divide
    `model`, the whole output cut), or with `attn_mode="cp"` context-
    parallel. Cross-attention reads `kv_full`, the whole source sequence
    (head-parallel), or `kv_shard`, this rank's S-shard of it (cp)."""
    if attn_mode == "cp":
        return cp_attention(p.regather(("data", "model")), h, cfg, tables,
                            tp, causal=causal, kv_x=kv_shard)
    return tp.back_to_stream(
        tp_attention(p, tp.seq_gather(h), cfg, tables, tp, causal=causal,
                     kv_x=kv_full),
        cfg.num_heads % tp.size == 0)


def mlp_half(p, h, cfg: ModelConfig, tp: TP):
    """The MLP of the normed S-shard h, ff-parallel over the gathered
    sequence, back on the stream's S-shard."""
    return tp.back_to_stream(layers.mlp_block(p, tp.seq_gather(h), cfg),
                             cfg.d_ff % tp.size == 0)


def moe_exchange(layout, seq_sharded: bool, s_loc: int) -> moe.Exchange:
    """Where this rank's MoE tokens lie in the microbatch: its DP block of
    rows, and its S-shard of them (`seq_sharded`: the rank routes its
    shard) or the whole sequence of them, of which it owns its `model`
    block of `s_loc` positions."""
    rows = tuple(layout.group(a) for a in ("data", "pod")
                 if a in layout.shape)
    row_rank = layout.coord.get("pod", 0) * layout.size("data") \
        + layout.coord.get("data", 0)
    model = layout.group("model") if "model" in layout.shape else None
    t = layout.coord.get("model", 0)
    aux = ((model,) if model is not None else ()) + rows
    dp = layout.size("pod") * layout.size("data")
    if seq_sharded:
        return moe.Exchange(rows, row_rank, dp, seq=model, seq_rank=t,
                            aux=aux)
    return moe.Exchange(rows, row_rank, dp, own=(t * s_loc, s_loc),
                        aux=aux)


def tp_moe_ffn(p, h, cfg: ModelConfig, tp: TP, group_size: int):
    """The MoE FFN of the normed S-shard h (B, S/m, d) -> (its output on
    the stream's S-shard, aux). Experts split over `model` (E divides
    it): the S-shard routes itself and its buffers reach the experts'
    owners by all-to-alls. Otherwise the gathered sequence is routed on
    every rank and each computes its ff columns (a partial output,
    reduce-scattered) or, where ff does not divide either, the whole
    experts (the output cut)."""
    if cfg.num_experts % tp.size == 0:
        return moe.moe_block(p, h, cfg, group_size,
                             moe_exchange(tp.layout, True, h.shape[1]),
                             ep=tp.group)
    out, aux = moe.moe_block(p, tp.seq_gather(h), cfg, group_size,
                             moe_exchange(tp.layout, False, h.shape[1]))
    return tp.back_to_stream(out, cfg.d_ff % tp.size == 0), aux


def tp_decoder_layer(lp, x, cfg: ModelConfig, tables, tp: TP,
                     attn_mode: str = "auto",
                     moe_group: int = moe.GROUP_SIZE):
    """x (B, S/m, d), the rank's S-shard of the stream -> (the same after
    one pre-norm block, the MoE aux: 0 for a dense layer). `tables` are
    RoPE's for the whole sequence, or with cp (sin, cos) of the rank's
    positions."""
    h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
    x = x + attention_half(lp.attn, h, cfg, tables, tp, attn_mode)
    h = layers.rms_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.num_experts:
        ff, aux = tp_moe_ffn(lp.mlp, h, cfg, tp, moe_group)
        return x + ff, aux
    return x + mlp_half(lp.mlp, h, cfg, tp), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def whole_block(fn, p, x, tp: TP, *args):
    """`fn(p, x, *args)` of a block whose heads (or inner channels) do not
    split over `model`: its leaves gathered over `model` at use, run on
    the gathered sequence on every rank, this rank's S-shard of the
    output kept (the gathers' backward sums the ranks' shares)."""
    return tp.seq_shard(fn(p.regather(("data", "model")),
                           tp.seq_gather(x), *args))


def sharded_rms_norm(x, scale, eps: float, tp: TP, width: int):
    """`layers.rms_norm` over a feature dim of `width` split over `model`:
    x (..., width/m) this rank's channels, `scale` the whole leaf; the
    mean of squares summed over the ranks."""
    x32 = x.to(torch.float32)
    ss = fsdp.sum_shared(torch.sum(torch.square(x32), dim=-1, keepdim=True),
                         tp.group)
    y = x32 * torch.rsqrt(ss / width + eps)
    n = x.shape[-1]
    own = scale.narrow(0, tp.rank * n, n)
    return (y * own.to(torch.float32)).to(x.dtype)


def tp_logits(view, x, cfg: ModelConfig, tp: TP, norm=layers.rms_norm):
    """The final norm of the stream's S-shard, gathered over S, times the
    rank's vocab columns: (B, S, V_pad/m) f32."""
    x = tp.seq_gather(norm(x, view.ln_f, cfg.norm_eps))
    return vocab_parallel_logits(view.unembed_table(), x, cfg, tp)


def tp_forward(view, tokens, cfg: ModelConfig, parallel: ParallelConfig,
               tp: TP):
    """The dense and MoE families' forward over `model` ranks: tokens (B,
    S) -> (vocab-sharded logits (B, S, V_pad/m) f32, the MoE aux summed
    over layers)."""
    b, s = tokens.shape
    check_tp(cfg, s, tp)
    layer = transformer.remat(tp_decoder_layer, parallel.remat)
    x = vocab_parallel_embed(view.embed, tokens, cfg, tp)
    if parallel.attn_mode == "cp":
        s_loc = s // tp.size
        pos = torch.arange(tp.rank * s_loc, (tp.rank + 1) * s_loc,
                           dtype=torch.int32, device=x.device)
    else:
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
    tables = transformer.rope_tables(pos, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in view.layers:
        x, a = layer(lp, x, cfg, tables, tp, parallel.attn_mode,
                     parallel.moe_group)
        aux = aux + a
    return tp_logits(view, x, cfg, tp), aux
