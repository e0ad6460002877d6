"""The port's logical-axis rules and the dense trainer's layout against
`repro.sharding` and `repro.train.trainer.state_defs`, on the CPU (no
devices: both sides' rules are arithmetic over axis names and sizes).

- Every leaf of all ten arch ids: the port's logical axes (by
  `named_parameters` name) equal the reference's `Annotated.logical`
  at the same tree path, less the `layers` stack dim.
- `logical_to_spec` gives the reference's spec for every leaf, at the
  smoke config and at full size, at the meshes (data 4), (data 2,
  model 2), (pod 2, data 2), (data 8) and (data 2, model 4); the
  reference only reads a mesh's axis names and sizes, so no ranks run.
- The per-rank bytes of the whole train state (f32 params, adamw's
  moments, counters) equal the reference's `shard_shape` bytes for
  every arch at those meshes; yi-6b's 72,732,426,248 bytes are
  18,185,502,728 a rank at (data 4) and 9,094,348,808 at (data 8) and
  (data 2, model 4); llama3-405b's 2,435,120,332,808 are
  304,411,803,656 a rank at (data 8).
"""
import types

import jax
import numpy as np
import pytest

from repro import sharding as jshd
from repro.configs import ARCH_IDS
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.models import registry as jregistry
from repro.sharding import Annotated
from repro.train import trainer as jtrainer
from repro_torch import sharding as shd
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.convert import _pairs
from repro_torch.models import registry
from repro_torch.train import trainer

# the three meshes of 4 ranks that cover every axis, and two of 8
MESHES = {"data4": {"data": 4, "model": 1},
          "data2-model2": {"data": 2, "model": 2},
          "pod2-data2": {"pod": 2, "data": 2, "model": 1},
          "data8": {"data": 8, "model": 1},
          "data2-model4": {"data": 2, "model": 4}}


def _fake_mesh(shape: dict):
    """What `repro.sharding` reads of a Mesh: its axis names and sizes."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _reference_leaves(arch, cfg):
    """{port name: reference Annotated with the stack dim dropped}."""
    defs = jregistry.get_spec(arch).defs(cfg)
    by_path = {}
    for path, a in jax.tree_util.tree_flatten_with_path(
            defs, is_leaf=lambda x: isinstance(x, Annotated))[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        by_path[keys] = a
    model = shd.meta_model(registry.get_spec(arch), cfg)
    out = {}
    for name, path, layer in _pairs(model):
        a = by_path[path]
        if layer is not None:
            assert a.logical[0] == "layers"
            a = Annotated(a.shape[1:], a.dtype, a.logical[1:])
        out[name] = a
    assert len(out) == len(dict(model.named_parameters()))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_reference(arch):
    cfg = registry.smoke_config(arch)
    want = _reference_leaves(arch, jregistry.smoke_config(arch))
    got = shd.param_defs(registry.get_spec(arch), cfg)
    assert list(got) == list(want)
    for name, d in got.items():
        assert d.logical == want[name].logical, name
        assert d.shape == want[name].shape, name


def _reference_state_specs(arch, cfg, shape):
    """{(section, port name or key): the reference's spec of that leaf of
    its whole train state (adamw, `compress_pod_grads`), the stack dim
    dropped}."""
    spec = jregistry.get_spec(arch)
    specs = jshd.tree_specs(
        jtrainer.state_defs(spec, cfg, JTrain(optimizer="adamw"),
                            JParallel(compress_pod_grads=True)),
        _fake_mesh(shape))
    model = shd.meta_model(registry.get_spec(arch), cfg)
    out = {("step",): tuple(specs["step"]),
           ("opt", "count"): tuple(specs["opt"]["count"])}
    for section in (("params",), ("opt", "m"), ("opt", "v"), ("err",)):
        tree = specs
        for key in section:
            tree = tree[key]
        for name, path, layer in _pairs(model):
            sp = tree
            for key in path:
                sp = sp[key]
            sp = tuple(sp)
            if layer is not None:           # the stack dim, never sharded
                assert sp[0] is None
                sp = sp[1:]
            out[(*section, name)] = sp
    return out


def _port_state_specs(arch, cfg, shape):
    spec = registry.get_spec(arch)
    sh = trainer.shardings_for_state(
        trainer.state_defs(spec, cfg, TrainConfig(optimizer="adamw"),
                           ParallelConfig(compress_pod_grads=True)), shape)
    out = {}

    def walk(node, prefix):
        if isinstance(node, trainer.Sharding):
            out[prefix] = node.spec
            return
        for k, v in node.items():
            walk(v, (*prefix, k))

    walk(sh, ())
    return out


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, mesh, size):
    """`shardings_for_state` of the whole train state against the
    reference's `tree_specs` of its `state_defs`, leaf for leaf."""
    shape = MESHES[mesh]
    cfg = registry.smoke_config(arch) if size == "smoke" else \
        registry.get_spec(arch).cfg
    jcfg = jregistry.smoke_config(arch) if size == "smoke" else \
        jregistry.get_spec(arch).cfg
    want = _reference_state_specs(arch, jcfg, shape)
    got = _port_state_specs(arch, cfg, shape)
    assert sorted(got) == sorted(want)
    for key, sp in got.items():
        assert sp == want[key], key
    assert any(s is not None for sp in got.values() for s in sp) or \
        size == "smoke"


def _reference_state_bytes(arch, shape):
    spec = jregistry.get_spec(arch)
    defs = jtrainer.state_defs(spec, spec.cfg, JTrain(optimizer="adamw"),
                               JParallel())
    mesh = _fake_mesh(shape)
    total = 0
    for a in jax.tree.leaves(defs, is_leaf=lambda x: isinstance(x,
                                                                Annotated)):
        sp = tuple(a.spec(mesh))
        n = 1
        for dim, s in zip(a.shape, sp, strict=True):
            n *= dim // jshd.mesh_axis_size(mesh, s)
        total += n * np.dtype(jax.numpy.dtype(a.dtype)).itemsize
    return total


def _port_state_bytes(arch, shape):
    spec = registry.get_spec(arch)
    defs = trainer.state_defs(spec, spec.cfg, TrainConfig(optimizer="adamw"),
                              ParallelConfig())
    return shd.tree_nbytes(defs, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_bytes_match_reference(arch):
    for shape in MESHES.values():
        assert _port_state_bytes(arch, shape) == \
            _reference_state_bytes(arch, shape), shape


def test_state_bytes_of_the_large_configs():
    assert _port_state_bytes("yi-6b", {}) == 72_732_426_248
    assert _port_state_bytes("yi-6b", {"data": 4, "model": 1}) \
        == 18_185_502_728
    for shape in ({"data": 8, "model": 1}, {"data": 2, "model": 4}):
        assert _port_state_bytes("yi-6b", shape) == 9_094_348_808
    assert _port_state_bytes("llama3-405b", {}) == 2_435_120_332_808
    assert _port_state_bytes("llama3-405b", {"data": 8, "model": 1}) \
        == 304_411_803_656


def test_shardings_and_batch_spec():
    spec = registry.get_spec("yi-6b")
    defs = trainer.state_defs(spec, spec.cfg, TrainConfig(),
                              ParallelConfig(compress_pod_grads=True))
    mesh = {"pod": 2, "data": 2, "model": 2}
    sh = trainer.shardings_for_state(defs, mesh)
    wq = sh["params"]["layers.0.attn.wq"]
    assert wq.spec == ("data", "model", None)
    assert wq.shard_shape == (2048, 16, 128)
    assert sh["err"]["layers.0.attn.wq"] == wq
    assert sh["opt"]["count"] == trainer.Sharding((), ())
    batch = {"tokens": shd.LeafDef((8, 16), "int32", ("batch", None))}
    assert trainer.batch_shardings(batch, mesh)["tokens"].shard_shape == \
        (2, 16)
    assert shd.batch_spec(mesh, None) == (("pod", "data"), None)
    assert shd.batch_spec({"data": 4, "model": 1}) == ("data",)
    assert tuple(jshd.batch_spec(_fake_mesh(mesh), None)) == \
        shd.batch_spec(mesh, None)
