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
    return [*files, ROOT / "chip_smoke.py"]


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
    from repro_torch import DPMRConfig, DPMREngine

    with pytest.raises(KeyError, match=f"{dist}.*ROADMAP queue A"):
        DPMREngine(DPMRConfig(num_features=64, distribution=dist),
                   device="cpu")


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
    with pytest.raises(NotImplementedError, match="queue A"):
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
    from repro_torch.kernels import segment_sum, select_pack, sigmoid_grad

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
