"""The port's spans and counters (`repro_torch.obs`) on the CPU.

- Off (the default), the sparse and the dense train step enter no
  `record_function`, and `obs` touches neither torch nor the clock.
- On, under `torch.profiler`, the spans have the names and parents their
  layers give them, a seam function inside another opens no span, and
  the aggregates hold calls, host ns and self ns.
- `optimizer.rows_given_grad` is the batch's distinct cold ids plus its
  distinct hot slots. `optimizer.rows_passed` is, on a2a's row path, the
  distinct cold rows (device: the rows the row update writes) plus
  `max_hot` (host: the hot set's dense update), so the table's useful
  share is 100%; on a dense path (allgather) the table's rows plus
  `max_hot`. `optimizer.row_updates` and `optimizer.dense_updates` count
  the `optimize` calls by path; `host_reads` 3 a `train_step`.
- `scripts/obs_trace.py`'s `read_trace` gives `model.attention` the
  autograd engine's work for the ops made under it (remat full and
  none), by sequence number.
- `launch_counts()` reads the `launch.<kernel>` counters as before; the
  loader counts its wait and batches.
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import DPMRConfig, DPMREngine, get_source, obs
from repro_torch.api import hot_ids_from_corpus
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.train import trainer

_spec = importlib.util.spec_from_file_location(
    "obs_trace",
    pathlib.Path(__file__).resolve().parents[1] / "scripts" / "obs_trace.py")
obs_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(obs_trace)

F, K, B, MAX_HOT = 1 << 10, 8, 32, 8
# a2a's row path: the table's run totals come from sorted_run_totals at
# the top level; owner_accumulate opens its span on a dense path
SEAM = {"seam.sigmoid_grad": "dpmr.step",
        "seam.sorted_run_totals": "dpmr.step",
        "seam.segment_sum_sorted": "routing.combine_grads"}


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    obs.reset()


def _sparse(distribution: str = "a2a"):
    cfg = DPMRConfig(num_features=F, max_features_per_sample=K,
                     max_hot=MAX_HOT, learning_rate=1.0, hot_threshold=0.01,
                     distribution=distribution)
    src = get_source("zipf_sparse", batch_size=B, num_batches=4,
                     num_features=F, features_per_sample=K)
    batches = [src.batch(i) for i in range(4)]
    hot = hot_ids_from_corpus(cfg, batches[:2], device="cpu")
    eng = DPMREngine(cfg, device="cpu", hot_ids=hot)
    eng.train_step(batches[0])          # builds the step functions
    return eng, batches


def _dense(layers: int = 2, remat: str = "full"):
    arch = "yi-6b"
    spec = registry.get_spec(arch)
    cfg = dataclasses.replace(registry.smoke_config(arch),
                              num_layers=layers)
    tc = TrainConfig(learning_rate=1e-3, optimizer="adamw")
    pc = ParallelConfig(remat=remat)
    state = trainer.init_state(spec, cfg, tc, pc,
                               torch.Generator().manual_seed(0), "cpu")
    step = trainer.make_train_step(spec, cfg, tc, pc)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    return state, step, batch, cfg


def _run(face: str, steps: int = 1):
    """One warm-up step untraced, then `steps` steps: the sparse engine's
    `train_step` or the dense trainer's step."""
    if face == "sparse":
        eng, batches = _sparse()
        return lambda: [eng.train_step(batches[1 + i % 3])
                        for i in range(steps)]
    state, step, batch, _ = _dense()

    def go():
        for _ in range(steps):
            step(state, batch)

    return go


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"obs touched {name!r} with tracing off")


@pytest.mark.parametrize("face", ["sparse", "dense"])
def test_off_enters_no_record_function_and_makes_no_tensor(face,
                                                           monkeypatch):
    go = _run(face)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(obs, "torch", _Untouchable())
    monkeypatch.setattr(obs, "time", _Untouchable())
    go()
    monkeypatch.undo()
    snap = obs.snapshot()
    assert snap["spans"] == {} and snap["device"] == {}


def _parents(events, names):
    """{span: {nearest enclosing span or ""}} from a profiler's events."""
    out = {}
    for e in events:
        if e.name not in names:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        out.setdefault(e.name, set()).add("" if p is None else p.name)
    return out


@pytest.mark.parametrize("face", ["sparse", "dense"])
def test_on_spans_have_their_layers_names_and_parents(face):
    go = _run(face, steps=2)
    with obs.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        go()
    snap = obs.snapshot()
    got = {name: set(by) for name, by in snap["spans"].items()}
    if face == "sparse":
        want = {"dpmr.step": {""}, "optimizer.update": {"dpmr.step"},
                **{f"routing.{n}": {"dpmr.step"} for n in (
                    "route_build", "owner_apply", "route_return",
                    "combine_grads")},
                **{k: {v} for k, v in SEAM.items()}}
        calls = {"dpmr.step": 2, "optimizer.update": 4,
                 "seam.sorted_run_totals": 4, "seam.segment_sum_sorted": 2}
    else:
        # remat full: each layer's attention again in the backward
        want = {"model.attention": {""}, "train.clip": {""},
                "train.optimizer": {""}}
        calls = {"model.attention": 2 * 2 * 2, "train.clip": 2,
                 "train.optimizer": 2}
    assert got == want
    assert _parents(prof.events(), set(want)) == want
    for name, n in calls.items():
        assert sum(v["calls"] for v in snap["spans"][name].values()) == n
    for by in snap["spans"].values():
        for v in by.values():
            assert 0 <= v["self_ns"] <= v["host_ns"]
    if face == "sparse":
        step = snap["spans"]["dpmr.step"][""]
        inner = sum(v["host_ns"] for by in snap["spans"].values()
                    for p, v in by.items() if p == "dpmr.step")
        assert step["self_ns"] == step["host_ns"] - inner


def test_span_groups_open_only_at_the_top_level():
    with obs.enabled():
        with obs.span("outer", group="g"):
            with obs.span("inner", group="g"):
                with obs.span("free"):
                    pass
        with obs.span("inner", group="g"):
            pass
    spans = obs.snapshot()["spans"]
    assert set(spans) == {"outer", "inner", "free"}
    assert spans["free"] == {"outer": spans["free"]["outer"]}
    assert set(spans["inner"]) == {""}
    assert spans["inner"][""]["calls"] == 1
    with obs.span("after"):       # tracing is off again
        pass
    assert "after" not in obs.snapshot()["spans"]


def test_counters_and_device_counters():
    obs.count("a")
    obs.count("a", 4)
    obs.count_device("d", torch.tensor([True, False, True]))
    assert obs.snapshot()["device"] == {}
    with obs.enabled():
        obs.count_device("d", torch.tensor([True, False, True]))
        obs.count_device("d", torch.tensor(5))
        obs.count_device("f", torch.tensor([0.5, 0.25]))
    snap = obs.snapshot()
    assert snap["counts"]["a"] == 5
    assert snap["device"] == {"d": 7, "f": 0.75}
    obs.reset()
    assert obs.snapshot() == {"spans": {}, "counts": {}, "device": {}}


def test_optimizer_rows_given_grad_and_rows_passed():
    eng, batches = _sparse()
    batch = batches[1]
    ids = torch.as_tensor(batch["ids"]).reshape(-1)
    ids = ids[ids >= 0]
    hot = eng.state.hot_ids
    is_hot = torch.isin(ids, hot)
    want = torch.unique(ids[~is_hot]).numel() + \
        torch.unique(ids[is_hot]).numel()
    assert 0 < torch.unique(ids[is_hot]).numel() < want
    cold = torch.unique(ids[~is_hot]).numel()
    obs.reset()
    with obs.enabled():
        eng.train_step(batch)
    snap = obs.snapshot()
    assert snap["device"]["optimizer.rows_given_grad"] == want
    # a2a's row path: the table's row update passes over the distinct
    # cold rows alone (each gets a gradient: 100% useful), the hot set's
    # dense update over its max_hot slots
    assert snap["device"]["optimizer.rows_passed"] == cold
    assert snap["counts"]["optimizer.rows_passed"] == MAX_HOT
    assert snap["counts"]["optimizer.row_updates"] == 1
    assert snap["counts"]["optimizer.dense_updates"] == 1
    obs.reset()
    eng.train_step(batch)     # the host counts count with tracing off
    assert obs.snapshot()["counts"] == {"optimizer.rows_passed": MAX_HOT,
                                        "optimizer.row_updates": 1,
                                        "optimizer.dense_updates": 1,
                                        "host_reads": 3}
    assert obs.snapshot()["device"] == {}


def test_optimizer_path_counters_on_a_dense_path():
    """allgather has no row reduce: the table and the hot set both take
    the dense update, which passes over every row."""
    eng, batches = _sparse("allgather")
    obs.reset()
    with obs.enabled():
        eng.train_step(batches[1])
    counts = obs.snapshot()["counts"]
    assert counts["optimizer.dense_updates"] == 2
    assert "optimizer.row_updates" not in counts
    assert counts["optimizer.rows_passed"] == F + MAX_HOT
    assert "optimizer.rows_passed" not in obs.snapshot()["device"]
    spans = obs.snapshot()["spans"]
    assert spans["seam.owner_accumulate"]["dpmr.step"]["calls"] == 1


@pytest.mark.parametrize("call", ["train_step", "fit"])
def test_host_reads(call):
    eng, batches = _sparse()
    obs.reset()
    if call == "train_step":
        for b in batches[1:]:
            eng.train_step(b)
        assert obs.counts()["host_reads"] == 3 * len(batches[1:])
    else:
        eng.fit(lambda: iter(batches), iterations=2)
        # two reads a batch, and the learning rate once an iteration
        assert obs.counts()["host_reads"] == 2 * (2 * len(batches) + 1)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_attention_backward_is_attributed_to_its_span(remat):
    state, step, batch, _ = _dense(layers=1, remat=remat)
    step(state, batch)
    with obs.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = prof.events()
    got = obs_trace.read_trace(events, obs.snapshot()["spans"], clock="cpu")
    back = got["backward_s"]["model.attention"]
    total = got["span_s"]["model.attention"]
    forward = sum(e.cpu_time_total for e in events
                  if e.name == "model.attention") * 1e-6
    assert back > 0 and total == pytest.approx(back + forward, rel=1e-9)
    assert set(got["backward_s"]) == {"model.attention"}
    assert got["gaps_s"] == {}


def test_read_trace_links_backward_nodes_by_sequence_number():
    """Outside the span: a tanh and the first product; inside: a scale,
    the softmax and the second product. The backward's time under the
    span is exactly their backward nodes'."""
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8)
    with obs.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        y = x @ w
        with obs.span("model.attention"):
            z = torch.softmax(y * 2.0, -1) @ w
        (z + y).tanh().sum().backward()
    events = prof.events()
    got = obs_trace.read_trace(events, ["model.attention"], clock="cpu")
    inside = {"MulBackward0", "SoftmaxBackward0"}
    mm = sorted((e.sequence_nr, e) for e in events
                if e.name == obs_trace.BACKWARD + "MmBackward0")
    want = sum(e.cpu_time_total for e in events
               if e.name[len(obs_trace.BACKWARD):] in inside) \
        + mm[-1][1].cpu_time_total
    assert got["backward_s"]["model.attention"] == \
        pytest.approx(want * 1e-6, rel=1e-9)


def test_launch_counts_read_the_launch_counters():
    ops.reset_launch_counts()
    obs.count("host_reads")
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    obs.count("launch.sigmoid_grad", 2)
    obs.count("launch.flash_attention")
    got = ops.launch_counts()
    assert got == {"sigmoid_grad": 2, "segment_sum_sorted": 0,
                   "select_pack": 0, "flash_attention": 1, "row_update": 0}
    assert all(type(v) is int for v in got.values())
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert obs.counts() == {"host_reads": 1}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_counts_its_wait_and_batches(prefetch):
    from repro_torch.data import ShardedLoader

    src = get_source("zipf_sparse", batch_size=B, num_batches=5,
                     num_features=F, features_per_sample=K)
    loader = ShardedLoader(src, device="cpu", prefetch=prefetch)
    assert not hasattr(loader, "wait_s")
    assert len(list(loader.epoch())) == 5
    got = obs.counts("loader.")
    if prefetch:
        assert got["loader.batches"] == 5 and got["loader.wait_s"] >= 0
    else:
        assert got == {}
