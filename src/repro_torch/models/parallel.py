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

Serving over a mesh of `data` and `model` (`ServeMesh`, each family's
`mesh_prefill` and `mesh_decode_step`) lays the parameters out as the
trainer stores them and each cache leaf by its logical axes, as the
reference's dry run places them: the batch rows over `data`, K/V slots
over `model` (`kv_seq`) unless 16 divides the KV heads (`kv_heads`),
the SSM states by heads and channels, a dim that `model` does not
divide whole. The residual stream is whole on every `model` rank (the
reference's `seq_shard=False`: any prompt length serves): each block's
partial output (the rank's heads, ff columns or experts) is all-reduced
over `model`; prefill's K/V reach the slot-split cache by one
all-to-all; a decode step gathers q's heads, takes each rank's
attention over its slots and combines the parts by log-sum-exp; the
greedy token is the vocab-parallel argmax, the first of equal maxima. A
mesh of one rank runs every collective over its one-rank groups and
gives the dense and MoE families' one-card numbers bit for bit.
"""
from __future__ import annotations

import inspect
import math
import types
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as shd
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

    def splits(self, n: int) -> bool:
        """Whether a dim of n splits over `model` (the rules' test)."""
        return n % self.size == 0

    def sum(self, x):
        """A partial result (the rank's heads, ff columns or experts)
        summed over `model` in place: a collective even at one rank."""
        dist.all_reduce(x, group=self.group)
        return x

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


def _vocab_rows(table, tokens, cfg: ModelConfig, tp: TP):
    """The rank's vocab rows (V/m, d) looked up for every token, other
    ranks' tokens zero: (B, S, d) in `cfg.dtype`, a partial sum over
    `model`."""
    v_loc = table.shape[0]
    ids = tokens.long() - tp.rank * v_loc
    inside = (ids >= 0) & (ids < v_loc)
    rows = F.embedding(ids.clamp(0, v_loc - 1), table)
    return torch.where(inside[..., None], rows, 0).to(common.act_dtype(cfg))


def vocab_parallel_embed(table, tokens, cfg: ModelConfig, tp: TP):
    """The rank's vocab rows looked up for every token, summed over
    `model` and S-sharded: (B, S/m, d) in `cfg.dtype`."""
    return tp.seq_scatter(_vocab_rows(table, tokens, cfg, tp))


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


# ---------------------------------------------------------------------------
# serving over a mesh: prefill and greedy decode
# ---------------------------------------------------------------------------


class KVPlace(NamedTuple):
    """This rank's block of a K/V cache leaf (lead, B, slots, KH, hd): its
    slots [s0, s0 + sn) of `slots` and its KV heads [h0, h0 + hn);
    `by_slots`, `by_heads`: whether that dim is split over `model`."""

    s0: int
    sn: int
    slots: int
    by_slots: bool
    h0: int
    hn: int
    by_heads: bool


class ServeMesh:
    """A rank's place in a serving mesh of dims `data` and `model`
    (`launch.mesh.make_host_mesh`) for a global batch of `batch` rows, as
    the reference's `serve_dense` lays it out: the parameters by their
    logical axes (`layout`, `core.fsdp.ParamLayout`), the batch rows
    over `data` (every rank's whole batch where `data` does not divide
    it, as the rules replicate a dim they cannot split), each cache leaf
    by its logical axes; `tp` is the `model` group. Prefill keeps here
    the cache's defs (`defs`) and the places of its K/V and conv leaves
    (`kv`), for the decode steps."""

    def __init__(self, layout, batch: int):
        if set(layout.shape) != {"data", "model"}:
            raise ValueError(f"serving takes a mesh of dims data and model "
                             f"(make_host_mesh), not {layout.shape}")
        self.layout, self.batch = layout, batch
        self.tp = TP(layout)
        dp = layout.size("data")
        self.rows_split = batch % dp == 0
        self.rows = batch // dp if self.rows_split else batch
        self.row0 = layout.coord["data"] * self.rows \
            if self.rows_split else 0
        self.kv: dict = {}
        self.defs = None

    def my_rows(self, x):
        """This rank's rows of a global (B, ...) batch."""
        return x[self.row0:self.row0 + self.rows]

    def exchange(self) -> moe.Exchange:
        """Where this rank's MoE tokens lie: its rows of the batch, every
        position of them (the stream is not S-sharded)."""
        if not self.rows_split:
            return moe.Exchange((), 0, 1)
        return moe.Exchange((self.layout.group("data"),),
                            self.layout.coord["data"],
                            self.layout.size("data"))

    def block(self, d: shd.LeafDef) -> tuple:
        """(start, length) of this rank's block of `d` along each dim."""
        out = []
        for size, s in zip(d.shape, d.spec(self.layout.mesh), strict=True):
            n = size // self.layout.size(s) if s else size
            out.append((self.layout.coord[s] * n if s else 0, n))
        return tuple(out)

    def new_cache(self, defs, device):
        """Zero blocks of a cache's tree of LeafDefs on `device`."""
        self.kv, self.defs = {}, defs
        return transformer.new_cache(defs, device, shd.tree_map(
            lambda d: tuple(n for _, n in self.block(d)), defs))

    def place(self, key, d: shd.LeafDef) -> KVPlace:
        """The place of the K/V cache leaf `d`, kept under `key`."""
        (s0, sn), (h0, hn) = self.block(d)[2:4]
        spec = d.spec(self.layout.mesh)
        self.kv[key] = KVPlace(s0, sn, d.shape[2], spec[2] is not None, h0,
                               hn, spec[3] is not None)
        return self.kv[key]

    def full(self, block, d: shd.LeafDef):
        """The whole leaf `d` from every rank's block (a collective)."""
        return self.layout.gather_spec(block, d.spec(self.layout.mesh))


def serve_embed(table, tokens, cfg: ModelConfig, tp: TP):
    """The token embedding of the replicated stream: the rank's vocab
    rows summed over `model` (the whole table's lookup where the padded
    vocab does not split) -> (b, S, d) in `cfg.dtype`."""
    if not tp.splits(common.padded_vocab(cfg)):
        return common.embed_tokens(table, tokens, cfg)
    return tp.sum(_vocab_rows(table, tokens, cfg, tp))


def serve_logits(view, x, cfg: ModelConfig, tp: TP, norm=layers.rms_norm):
    """The final norm of x (b, s, d) times the rank's vocab columns: (b,
    s, V_pad/m) f32 (the whole vocab where it does not split)."""
    x = norm(x, view.ln_f, cfg.norm_eps)
    if tp.splits(common.padded_vocab(cfg)):
        return vocab_parallel_logits(view.unembed_table(), x, cfg, tp)
    return common.lm_head(view.unembed_table(), x, cfg)


def next_token(logits, cfg: ModelConfig, tp: TP):
    """Greedy tokens (b, 1) int32 of the last position of vocab-sharded
    logits: `jnp.argmax`'s index over the padded vocabulary, the first of
    equal maxima. Each rank takes its first maximum; of equal maxima
    across ranks the lowest global column wins (one all-gather of the b
    (value, column) pairs, exact in f64)."""
    last = logits[:, -1]
    idx = torch.argmax(last, dim=-1)
    if not tp.splits(common.padded_vocab(cfg)):
        return idx[:, None].to(torch.int32)
    val = torch.gather(last, -1, idx[:, None])[:, 0]
    col = idx + tp.rank * last.shape[-1]
    pairs = torch.stack([val.to(torch.float64), col.to(torch.float64)])
    every = fsdp.all_gather_dim(pairs[None], tp.group, 0)   # (m, 2, b)
    vals, cols = every[:, 0], every[:, 1]
    best = torch.amax(vals, dim=0)
    cols = torch.where(vals == best, cols, math.inf)
    return torch.amin(cols, dim=0).to(torch.int32)[:, None]


def attn_out(p, att, cfg: ModelConfig, tp: TP):
    """The output projection of the rank's heads, summed over `model`
    where the heads split (else every rank's whole output)."""
    out = layers.project_out(p, att)
    return tp.sum(out) if tp.splits(cfg.num_heads) else out


def serve_attention(p, h, cfg: ModelConfig, tables, tp: TP, *,
                    causal: bool = True, kv_x=None):
    """Prefill's head-parallel attention of the replicated stream h (b, S,
    d): q of the rank's heads, K/V of its KV heads (all of them where
    they do not split; each q head then takes its KV head), the
    `flash_attention` kernel on the card (causal; non-causal, or
    cross-attention over `kv_x`, with `causal=False`; a sliding window
    takes the blocked schedule), the output summed over `model`. Returns
    (out (b, S, d), k, v: the projection's K/V heads)."""
    q = layers.project_q(p, h, cfg)
    k, v = layers.project_kv(p, h if kv_x is None else kv_x, cfg)
    if kv_x is None:
        q, k = transformer.rope(q, k, tables)
    kq, vq = _local_kv(k, v, cfg, tp, q.shape[2])
    if causal and kv_x is None:
        att = layers.causal_self_attention(q, kq, vq,
                                           window=cfg.sliding_window)
    else:
        att = layers.bidirectional_attention(q, kq, vq)
    return attn_out(p, att, cfg, tp), k, v


def prefill_kv_block(k, place: KVPlace, cfg: ModelConfig, tp: TP,
                     window: int = 0):
    """Prefill's K (or V) of a layer, k (b, S, KH', hd) for the KV heads
    of the projection (the rank's where they split over `model`), ->
    this rank's block of the cache over its first n slots (b, n, hn, hd):
    slot j holds position j, or under a window position S - slots + j
    (the ring). K split by heads into a cache whole on heads (the
    `kv_seq` rule) takes one all-to-all over `model` (each rank sends
    every other its heads of that rank's slots), or an all-gather where
    the slots do not split either."""
    s = k.shape[1]
    fill = min(s, place.slots) if window else s
    src = k[:, s - fill:]
    if not place.by_heads and tp.splits(cfg.num_kv_heads):
        if not place.by_slots:
            return fsdp.all_gather_dim(src, tp.group, 2)
        b, _, kh, hd = src.shape
        src = F.pad(src, (0, 0, 0, 0, 0, place.slots - fill))
        blocks = src.reshape(b, tp.size, place.sn, kh, hd).transpose(0, 1)
        got = fsdp.all_to_all(blocks, tp.group)      # (m, b, sn, kh, hd)
        return got.permute(1, 2, 0, 3, 4).reshape(b, place.sn, -1, hd)
    if place.by_heads and src.shape[2] != place.hn:
        src = src[:, :, place.h0:place.h0 + place.hn]
    return src[:, place.s0:min(place.s0 + place.sn, fill)]


def decode_kv_write(cache, k_new, slot, place: KVPlace, cfg: ModelConfig,
                    tp: TP):
    """Decode's K (or V) k_new (b, 1, KH', hd) into this rank's block of
    a layer's cache (b, sn, hn, hd) IN PLACE, at the global slot `slot`
    (b,): the rank that owns each row's slot writes every KV head of it
    (gathered over `model` where the projection splits them and the
    cache does not), or under the `kv_heads` layout its own heads."""
    kn = k_new[:, 0]
    if not place.by_heads and tp.splits(cfg.num_kv_heads):
        kn = fsdp.all_gather_dim(kn, tp.group, 1)
    elif place.by_heads and kn.shape[1] != place.hn:
        kn = kn[:, place.h0:place.h0 + place.hn]
    rows = torch.arange(kn.shape[0], device=kn.device)
    local = slot - place.s0
    if not place.by_slots:
        cache[rows, local] = kn
        return
    mine = (local >= 0) & (local < place.sn)
    local = torch.clamp(local, 0, place.sn - 1)
    cache[rows, local] = torch.where(mine[:, None, None], kn,
                                     cache[rows, local])


def local_decode_attention(q, k_cache, v_cache, length, cfg: ModelConfig,
                           tp: TP, window: int = 0):
    """Decode attention of the rank's q heads against a cache that holds
    their KV heads (the `kv_heads` layout; whisper's cross K/V) or all of
    them (each q head then takes its KV head), over every slot."""
    k_cache, v_cache = _local_kv(k_cache, v_cache, cfg, tp, q.shape[2])
    return layers.decode_attention(q, k_cache, v_cache, length,
                                   window=window)


def decode_self_attention(q, k_cache, v_cache, length, place: KVPlace,
                          cfg: ModelConfig, tp: TP, window: int = 0):
    """Decode attention of q (b, 1, H', hd), the rank's heads, against
    this rank's block of the cache -> (b, 1, H', hd). Under the `kv_heads`
    layout each rank attends with its own heads over every slot. Under
    `kv_seq` q's heads are gathered over `model`, each rank takes the
    partial over its slots (`layers.decode_attention_part`, the mask by
    global slot), the parts are combined by log-sum-exp over `model`
    (`layers.decode_combine`), and each rank keeps its heads."""
    if place.by_heads:
        return local_decode_attention(q, k_cache, v_cache, length, cfg, tp,
                                      window)
    heads = q.shape[2]
    split = tp.splits(cfg.num_heads)
    if split:
        q = fsdp.all_gather_dim(q, tp.group, 2)
    o, m, l = layers.decode_attention_part(q, k_cache, v_cache, length,
                                           slot0=place.s0,
                                           slots=place.slots, window=window)
    if place.by_slots:
        o, l = layers.decode_combine(o, m, l, tp.group)
    out = layers.decode_finish(o, l, q.dtype)
    if split:
        out = out[:, :, tp.rank * heads:(tp.rank + 1) * heads]
    return out


def serve_mlp(p, h, cfg: ModelConfig, tp: TP):
    """The MLP of the replicated stream, the rank's ff columns summed over
    `model` (whole where ff does not split)."""
    out = layers.mlp_block(p, h, cfg)
    return tp.sum(out) if tp.splits(cfg.d_ff) else out


def serve_moe_ffn(p, h, cfg: ModelConfig, sm: ServeMesh):
    """The MoE FFN of the replicated stream h (b, S, d), this rank's rows:
    routed over the batch's rows on every `data` rank
    (`moe.route_exchanged`: a group may span them; the kept and dropped
    pairs are the reference's), then each rank's experts (where they
    split over `model`) or ff columns applied to the buffers of its own
    tokens, which every `model` rank holds, and the f32 partial outputs
    summed over `model`: the reference's layout of a replicated stream,
    where the dispatch of each rank's experts is local."""
    tp = sm.tp
    b, s, d = h.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n = b * s
    r = moe.route_exchanged(p, h, cfg, moe.GROUP_SIZE, sm.exchange())
    local = (tp.rank * (e // tp.size), e // tp.size) if tp.splits(e) \
        else None
    out = moe.dispatch_combine(
        p, h.reshape(n, d), r.idx.reshape(n, k), r.gates.reshape(n, k),
        r.keep.reshape(n, k), r.pos.reshape(n, k), r.group.reshape(n),
        r.groups, r.capacity, e, local=local, cast=False)
    if tp.splits(e) or tp.splits(cfg.d_ff):
        tp.sum(out)
    return out.to(h.dtype).reshape(b, s, d)


def serve_ffn(p, h, cfg: ModelConfig, sm: ServeMesh):
    if cfg.num_experts:
        return serve_moe_ffn(p, h, cfg, sm)
    return serve_mlp(p, h, cfg, sm.tp)


def decode_attention_layer(p, h, k_cache, v_cache, pos, slot, tables,
                           place: KVPlace, cfg: ModelConfig, tp: TP):
    """A decode step's attention of the normed token h (b, 1, d): q, K/V
    of the rank's heads, RoPE at `pos`, K/V written at `slot`
    (`decode_kv_write`), `decode_self_attention`, the output summed over
    `model`."""
    q = layers.project_q(p, h, cfg)
    k_new, v_new = layers.project_kv(p, h, cfg)
    q, k_new = transformer.rope(q, k_new, tables)
    decode_kv_write(k_cache, k_new, slot, place, cfg, tp)
    decode_kv_write(v_cache, v_new, slot, place, cfg, tp)
    att = decode_self_attention(q, k_cache, v_cache, pos + 1, place, cfg,
                                tp, cfg.sliding_window)
    return attn_out(p, att, cfg, tp)


def decode_slot(pos, place: KVPlace, window: int):
    """The global cache slot of each row's new token: the ring's pos %
    slots under a window, else pos (the last slot once full)."""
    if window:
        return (pos % place.slots).long()
    return torch.clamp(pos, max=place.slots - 1).long()


@torch.inference_mode()
def mesh_prefill(view, tokens, cfg: ModelConfig, sm: ServeMesh):
    """The dense and MoE families' prefill over a mesh
    (`transformer.prefill` laid out as `ServeMesh` says): tokens (b, S),
    this rank's rows, -> (the last position's vocab-sharded logits (b, 1,
    V_pad/m) f32, this rank's blocks of the cache). The stream is
    replicated over `model` (the reference's `seq_shard=False`), so any
    prompt length serves."""
    b, s = tokens.shape
    w = cfg.sliding_window
    tp = sm.tp
    defs = transformer.cache_defs(cfg, sm.batch, min(s, w) if w
                                  else s + transformer.PREFILL_EXTRA)
    cache = sm.new_cache(defs, tokens.device)
    cache["length"].fill_(s)
    place = sm.place("kv", defs["k"])
    x = serve_embed(view.embed, tokens, cfg, tp)
    tables = transformer.rope_tables(torch.arange(
        s, dtype=torch.int32, device=x.device), cfg)
    for i, lp in enumerate(view.layers):
        h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
        att, k, v = serve_attention(lp.attn, h, cfg, tables, tp)
        x = x + att
        x = x + serve_ffn(lp.mlp, layers.rms_norm(x, lp.ln2, cfg.norm_eps),
                          cfg, sm)
        for name, t in (("k", k), ("v", v)):
            blk = prefill_kv_block(t, place, cfg, tp, w)
            cache[name][i, :, :blk.shape[1]] = blk
    return serve_logits(view, x[:, -1:], cfg, tp), cache


@torch.inference_mode()
def mesh_decode_step(view, cache: dict, tokens, cfg: ModelConfig,
                     sm: ServeMesh):
    """One decode step over a mesh, tokens (b, 1) of this rank's rows;
    its cache blocks updated IN PLACE. Returns (vocab-sharded logits (b,
    1, V_pad/m) f32, cache)."""
    tp, place = sm.tp, sm.kv["kv"]
    pos = cache["length"]
    x = serve_embed(view.embed, tokens, cfg, tp)
    slot = decode_slot(pos, place, cfg.sliding_window)
    tables = transformer.rope_tables(pos[:, None], cfg)
    for i, lp in enumerate(view.layers):
        h = layers.rms_norm(x, lp.ln1, cfg.norm_eps)
        x = x + decode_attention_layer(lp.attn, h, cache["k"][i],
                                       cache["v"][i], pos, slot, tables,
                                       place, cfg, tp)
        x = x + serve_ffn(lp.mlp, layers.rms_norm(x, lp.ln2, cfg.norm_eps),
                          cfg, sm)
    logits = serve_logits(view, x, cfg, tp)
    cache["length"] += 1
    return logits, cache
