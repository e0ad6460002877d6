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
    """An unknown name raises; `auto` resolves, through the autotuner, to
    the strategy the reference resolves it to at P = 1; overlap_a2a and
    hier_a2a, which differ from a2a only across ranks or tiers, build and
    train bit for bit as a2a at P = 1."""
    from repro_torch import DPMRConfig, DPMREngine, get_source
    from repro_torch.core import dpmr

    kw = dict(num_features=1 << 10, max_features_per_sample=8, max_hot=8,
              learning_rate=1.0)
    if dist == "no_such_strategy":
        with pytest.raises(KeyError, match=f"unknown distribution strategy "
                                           f".*{dist}.*; registered"):
            DPMREngine(DPMRConfig(distribution=dist, **kw), device="cpu")
        return
    if dist == "auto":
        from repro.configs.base import DPMRConfig as JaxConfig
        from repro.core import dpmr as jax_dpmr
        from repro.launch.mesh import make_host_mesh

        want = jax_dpmr.resolve_distribution(JaxConfig(distribution=dist,
                                                       **kw),
                                             make_host_mesh(1, 1))
        eng = DPMREngine(DPMRConfig(distribution=dist, **kw), device="cpu")
        assert dpmr.resolve_distribution(eng.cfg) == want
        assert eng.step_fns(32).strategy == want
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
    """Every arch of the reference resolves; an unknown id and a dense
    arch under --sparse raise; context-parallel attention without a mesh
    is the blocked attention (the reference's fallback without a `model`
    dim), bit for bit."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import common, layers, registry

    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        spec = registry.get_spec(arch)
        assert spec.cfg == get_config(arch)
        assert registry.model_class(spec.cfg) is spec.model
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("not-an-arch")
    cfg = registry.smoke_config("zamba2-2.7b")
    spec = registry.get_spec("zamba2-2.7b")
    model = common.init_params(spec.model(cfg, device="cpu"),
                               torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    blocks = {mode: layers.attention_block(model.shared.attn, x, cfg, None,
                                           attn_mode=mode)
              for mode in ("auto", "cp")}
    assert torch.equal(blocks["cp"], blocks["auto"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--sparse", "--arch", "yi-6b"])
    assert "is a dense LM config" in capsys.readouterr().err
