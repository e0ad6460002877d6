"""Logical-axis -> mesh-axis sharding rules: the counterpart of
`repro.sharding`.

Every parameter dim has a *logical* axis name (`embed`, `heads`, `ff`,
`vocab`, ...); `logical_to_spec` turns those into a spec for a concrete
mesh: per dim, a mesh dim name, a tuple of them, or None (replicated),
dropping any mapping that does not divide the dim (8 KV heads cannot
shard over a 16-way `model` dim, so they stay whole). The dense face of
DPMR is the rule `embed`/`mlp_embed` -> `data`: parameters are sharded
over the ranks that hold the samples (FSDP), and `heads`, `kv_heads`,
`ff` and `vocab` go over `model` (tensor parallelism).

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` or a mapping
of dim names to sizes in mesh order (`{"data": 8, "model": 1}`): the
rules are arithmetic and need no process group.

The reference declares its parameters as `Annotated(shape, dtype,
logical)` defs; the port builds `nn.Module`s, so `param_logical` gives
each of a model's parameters (by its `named_parameters` name) the
logical axes of the reference's def at the same tree path, less the
reference's leading `layers` stack dim, which the rules never shard.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import NamedTuple

AxisNames = tuple  # of str | None, one per dim

# logical axis -> preference-ordered mesh axes (the reference's own)
DEFAULT_RULES = {
    "batch": ("pod", "data"),       # data parallel
    "seq": (),                      # replicated (sequence parallelism is
    #                                 explicit)
    "embed": ("data",),             # FSDP / dense-DPMR shard axis
    "mlp_embed": ("data",),
    "vocab": ("model",),            # sparse-face owner axis
    "heads": ("model",),            # tensor parallel
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "experts": ("model",),          # expert parallel
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "layers": (),                   # stack dim, never sharded
    "stack": (),
    "feature_shard": ("model",),    # DPMR sparse face: feature-owner axis
    "kv_seq": ("model",),           # cache slots when kv_heads can't shard
}


def mesh_shape(mesh) -> dict[str, int]:
    """{dim name: size} of a `DeviceMesh` or of a mapping, in mesh order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape),
                    strict=True))


def mesh_axis_size(mesh, names: str | Sequence[str] | None) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    shape = mesh_shape(mesh)
    size = 1
    for n in names:
        size *= shape[n]
    return size


def logical_to_spec(logical: AxisNames, shape: Sequence[int], mesh,
                    rules: dict | None = None) -> tuple:
    """Translate logical axis names to a spec for `mesh`: each dim maps to
    the rule axes (in preference order) that exist in the mesh, are not
    used by another dim of this array, and together divide the dim; one
    axis as its name, several as a tuple, none as None."""
    rules = rules or DEFAULT_RULES
    names = mesh_shape(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical, strict=True):
        if name is None:
            out.append(None)
            continue
        picked: list = []
        for ax in rules.get(name, ()):
            if ax not in names or ax in used:
                continue
            trial = picked + [ax]
            if dim % mesh_axis_size(mesh, trial) == 0:
                picked = trial
        if picked:
            used.update(picked)
            out.append(tuple(picked) if len(picked) > 1 else picked[0])
        else:
            out.append(None)
    return tuple(out)


def batch_spec(mesh, *trailing) -> tuple:
    """Spec with the batch dim over all DP axes present in the mesh."""
    dp = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    lead = dp if len(dp) > 1 else (dp[0] if dp else None)
    return (lead, *trailing)


def shard_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """The per-rank block of an array of `shape` laid out by `spec`."""
    return tuple(int(d) // mesh_axis_size(mesh, s)
                 for d, s in zip(shape, spec, strict=True))


class LeafDef(NamedTuple):
    """A (shape, dtype, logical axes) declaration: the reference's
    `Annotated`."""

    shape: tuple
    dtype: str
    logical: AxisNames

    def spec(self, mesh, rules=None) -> tuple:
        return logical_to_spec(self.logical, self.shape, mesh, rules)

    def nbytes(self, mesh=None, rules=None) -> int:
        """Bytes of one rank's block (of the whole array without a mesh)."""
        import torch

        shape = self.shape if mesh is None else \
            shard_shape(self.shape, self.spec(mesh, rules), mesh)
        n = 1
        for d in shape:
            n *= int(d)
        return n * getattr(torch, self.dtype).itemsize


# ---------------------------------------------------------------------------
# the logical axes of every family's parameters, as the reference's defs
# give them (`repro.models.layers.attn_defs`/`mlp_defs`,
# `common.embed_defs`, `moe.moe_defs`, `mamba`, `xlstm`, `encdec`), less
# the `layers` stack dim
# ---------------------------------------------------------------------------

_ATTN = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
         "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed"),
         "q_norm": (None,), "k_norm": (None,)}
_MLP = {"wi_gate": ("mlp_embed", "ff"), "wi_up": ("mlp_embed", "ff"),
        "wi": ("mlp_embed", "ff"), "wo": ("ff", "mlp_embed")}
_MOE = {"router": ("mlp_embed", None),
        "wi_gate": ("experts", "mlp_embed", "ff"),
        "wi_up": ("experts", "mlp_embed", "ff"),
        "wo": ("experts", "ff", "mlp_embed")}
_MAMBA = {"norm": (None,), "wx": ("embed", "ssm_inner"),
          "wz": ("embed", "ssm_inner"), "wB": ("embed", None),
          "wC": ("embed", None), "wdt": ("embed", "ssm_heads"),
          "dt_bias": (None,), "A_log": (None,), "D_skip": (None,),
          "conv": (None, "ssm_inner"), "out_norm": (None,),
          "wo": ("ssm_inner", "embed")}
_MLSTM = {"norm": (None,), "wu": ("embed", "ssm_inner"),
          "wz": ("embed", "ssm_inner"), "conv": (None, "ssm_inner"),
          "wq": ("ssm_inner", None), "wk": ("ssm_inner", None),
          "wv": ("ssm_inner", None), "wi": ("ssm_inner", None),
          "wf": ("ssm_inner", None), "f_bias": (None,),
          "out_norm": (None,), "wo": ("ssm_inner", "embed")}
_SLSTM = {"norm": (None,), "w_gates": ("embed", None, "heads", None),
          "r_gates": ("heads", None, None, None),
          "b_gates": (None, "heads", None), "out_norm": (None,),
          "w_up1": ("embed", "ff"), "w_up2": ("embed", "ff"),
          "w_down": ("ff", "embed")}
_TOP = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab")}


def path_logical(path: tuple, cfg) -> AxisNames:
    """Logical axes of the leaf at `path` in the reference's params tree
    (`convert`'s paths: `("layers", "attn", "wq")`, `("embed",)`,
    `("blocks", i, "kind_mlstm", "wq")`, ...), without the stack dim."""
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else None
    if path[0] == "blocks":
        return (_MLSTM if path[2] == "kind_mlstm" else _SLSTM)[leaf]
    if parent in ("attn", "xattn"):
        return _ATTN[leaf]
    if parent == "mlp":
        return (_MOE if cfg.num_experts and path[0] == "layers"
                else _MLP)[leaf]
    if cfg.family == "hybrid" and path[0] == "layers":
        return _MAMBA[leaf]
    if leaf in _TOP:
        return _TOP[leaf]
    return (None,)          # norm scales: ln1, ln2, lnx, ln_f, ln_enc


def param_logical(model, cfg) -> dict[str, AxisNames]:
    """{parameter name: logical axes} of a port model of `cfg` (its
    `named_parameters` names and shapes; a model on the `meta` device
    costs nothing)."""
    from repro_torch.convert import _pairs

    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    out = {}
    for name, path, _ in _pairs(model):
        logical = path_logical(path, cfg)
        if len(logical) != len(shapes[name]):
            raise ValueError(f"{name}: logical axes {logical} do not fit "
                             f"its shape {shapes[name]}")
        out[name] = logical
    return out


def meta_model(spec, cfg):
    """`cfg`'s training model on the `meta` device: names and shapes, no
    storage."""
    return spec.model(cfg, device="meta", train=True)


def param_defs(spec, cfg, model=None) -> dict[str, LeafDef]:
    """{parameter name: LeafDef} of `cfg`'s training model, in
    `named_parameters` order."""
    model = meta_model(spec, cfg) if model is None else model
    logical = param_logical(model, cfg)
    return {name: LeafDef(tuple(p.shape), cfg.param_dtype, logical[name])
            for name, p in model.named_parameters()}


def tree_map(fn, defs):
    """`fn` of every LeafDef of a tree of dicts, lists and tuples (an
    xlstm cache's blocks), in the same tree."""
    if isinstance(defs, LeafDef):
        return fn(defs)
    if isinstance(defs, (list, tuple)):
        return type(defs)(tree_map(fn, v) for v in defs)
    return {k: tree_map(fn, v) for k, v in defs.items()}


def tree_leaves(defs) -> list:
    """The LeafDefs of a tree, in its order."""
    out: list = []
    tree_map(out.append, defs)
    return out


def tree_specs(defs, mesh, rules=None):
    """A tree of LeafDefs -> the same tree of specs."""
    return tree_map(lambda d: d.spec(mesh, rules), defs)


def tree_shard_shapes(defs, mesh, rules=None):
    """A tree of LeafDefs -> the same tree of per-rank block shapes."""
    return tree_map(lambda d: shard_shape(d.shape, d.spec(mesh, rules),
                                          mesh), defs)


def tree_nbytes(defs, mesh=None, rules=None) -> int:
    """Bytes of one rank's blocks of every leaf of a tree of LeafDefs."""
    return sum(d.nbytes(mesh, rules) for d in tree_leaves(defs))


def kv_cache_logical(num_kv_heads: int, lead: str | None = "layers"
                     ) -> AxisNames:
    """The logical axes of a K/V cache (lead, B, slots, KH, hd), the
    reference's rule (`repro.models.transformer.cache_defs`): the KV
    heads over `model` where 16 divides them (its production meshes'
    width), else the slots (`kv_seq`), so that a GQA cache of 1, 4 or 8
    heads is not replicated."""
    if num_kv_heads % 16 == 0:
        return (lead, "batch", None, "kv_heads", None)
    return (lead, "batch", "kv_seq", None, None)
