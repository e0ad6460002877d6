"""What the port promises about itself: it never imports the JAX package,
it runs on the card unless told otherwise, and it never falls back."""
import ast
import os
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return [*files, ROOT / "chip_smoke.py",
            ROOT / "tests" / "test_torch_cuda.py"]


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_engine_without_device_needs_a_card():
    from repro_torch import DPMRConfig, DPMREngine

    if torch.cuda.is_available():
        pytest.skip("a card is present: DPMREngine(cfg) runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPMREngine(DPMRConfig(num_features=64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DPMREngine(DPMRConfig(num_features=64), device="cuda")
    eng = DPMREngine(DPMRConfig(num_features=64), device="cpu")
    assert eng.state.cold.device.type == "cpu"


@pytest.mark.parametrize("dist", ["overlap_a2a", "hier_a2a", "auto",
                                  "no_such_strategy"])
def test_other_distributions_raise(dist):
    """`auto` (the autotuner, not ported) and an unknown name raise;
    overlap_a2a and hier_a2a, which differ from a2a only across ranks or
    tiers, build and train bit for bit as a2a at P = 1."""
    from repro_torch import DPMRConfig, DPMREngine, get_source

    kw = dict(num_features=1 << 10, max_features_per_sample=8, max_hot=8,
              learning_rate=1.0)
    if dist in ("auto", "no_such_strategy"):
        with pytest.raises(KeyError, match=f"{dist}.*ROADMAP queue A"):
            DPMREngine(DPMRConfig(distribution=dist, **kw), device="cpu")
        return
    src = get_source("zipf_sparse", batch_size=32, num_batches=2,
                     num_features=1 << 10, features_per_sample=8)
    got = DPMREngine(DPMRConfig(distribution=dist, **kw), device="cpu")
    want = DPMREngine(DPMRConfig(distribution="a2a", **kw), device="cpu")
    assert [h["loss"] for h in got.fit_sgd(src)] == \
        [h["loss"] for h in want.fit_sgd(src)]
    for a, b in zip(got.state, want.state, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("field", ["kernel_impl", "topk_frac", "seed"])
def test_config_has_no_field_the_port_ignores(field):
    """The reference's fields that nothing in the port reads are absent, so
    passing one fails instead of being silently ignored; `topk_frac` is
    read by topk_reduce and reaches the steps' strategy context."""
    from repro_torch import DPMRConfig

    if field == "topk_frac":
        from repro_torch.core import dpmr

        fns = dpmr.make_step_fns(DPMRConfig(num_features=64, topk_frac=0.05),
                                 8)
        assert fns.ctx.topk_frac == 0.05
        return
    with pytest.raises(TypeError, match=field):
        DPMRConfig(**{field: 0})


def test_multi_rank_all_to_all_raises():
    from repro_torch.api.strategies import StrategyContext, _all_to_all

    x = torch.zeros((2, 4))
    assert _all_to_all(x, StrategyContext(1, 8, 4)) is x
    with pytest.raises(NotImplementedError, match="needs a process group"):
        _all_to_all(x, StrategyContext(2, 8, 4))


def test_kernel_build_without_nvcc_raises(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("nvcc is installed here")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The wrappers' checks run before any build or launch."""
    from repro_torch.kernels import (
        flash_attention,
        segment_sum,
        select_pack,
        sigmoid_grad,
    )

    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        sigmoid_grad._check(meta, meta, torch.empty((4,), device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        segment_sum._check(torch.empty((4,), dtype=torch.int32,
                                       device="meta"),
                           torch.empty((4,), device="meta"))
    ids = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        select_pack._check(meta[:2], ids, meta[:2], 3)
    q = torch.empty((1, 8, 4, 64), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention._check_cuda(q, kv, kv)


def test_serving_without_device_needs_a_card():
    """The serve CLI and greedy_decode run on the card unless told
    device='cpu', and raise without one."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry, transformer
    from repro_torch.train import serve

    if torch.cuda.is_available():
        pytest.skip("a card is present: serving runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "yi-6b", "--decode-steps", "2"])
    spec = registry.get_spec("yi-6b")
    cfg = registry.smoke_config("yi-6b")
    model = transformer.Transformer(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.greedy_decode(spec, cfg, model, batch, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.Transformer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.greedy_decode(spec, cfg, model, batch, 2, device="cuda")


def test_unported_model_features_raise(capsys):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import layers, registry, transformer

    cfg = registry.smoke_config("yi-6b")
    for field in ("num_experts", "sliding_window"):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            transformer.Transformer(dataclasses.replace(cfg, **{field: 4}),
                                    device="cpu")
    q = torch.zeros((1, 4, 4, 16))
    kv = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        layers.causal_self_attention(q, kv, kv, window=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        layers.decode_attention(q[:, :1], kv, kv, torch.tensor([4]),
                                window=2)
    for arch in ("mixtral-8x22b", "zamba2-2.7b", "whisper-small"):
        with pytest.raises(KeyError, match="ROADMAP A12"):
            get_config(arch)
    with pytest.raises(SystemExit):
        launch_serve.main(["--sparse"])
    assert "ROADMAP A8" in capsys.readouterr().err
