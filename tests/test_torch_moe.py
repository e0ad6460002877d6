"""The port's MoE layer (`models.moe`) against the JAX package's, on the CPU.

- `moe_block` at the smoke sizes of phi3.5-moe (no window) and mixtral
  (top-2 of 4 experts, d 64, d_ff 128), in f32, with the default group
  (one group of all tokens) and with groups of 16 tokens where capacity
  binds (a router skewed towards expert 0 fills its 12 rows): the experts,
  capacity positions and kept mask equal to the reference's bit for bit
  (the reference's own routing lines, run in JAX on its router
  probabilities), `out` and `aux` within 1e-5, and the gradients of
  sum(out * r) + aux with respect to x and the four leaves within 1e-5 of
  `jax.grad`'s;
- ties in the router: duplicated router columns give the reference's
  order (the lower expert index first), and a zero router ranks experts
  0 and 1 for every token;
- a number of tokens the group does not divide raises in both packages;
- `expert_capacity` equals the reference's over a grid of (g, E, k, cf);
- bf16: `moe_block` in bf16 within 2e-2 (the reference's bf16
  tolerance, tests/test_models.py) of the reference in f32 on the same
  bf16 values, where both route a token alike, and the routes of at
  least 95% of the tokens equal;
- the params of an MoE tree round-trip through `convert` both ways, and
  a wrong expert shape is refused;
- `launch.train --arch phi3.5-moe-42b-a6.6b --smoke --device cpu` resumes
  the reference CLI's dense checkpoint after 2 steps and trains to step
  3 within 1e-5 of the reference's 3 uninterrupted steps; the port's
  checkpoint of that state is restored by the reference's `Checkpointer`
  leaf for leaf; `launch.serve --arch mixtral-8x22b --device cpu` decodes.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpointer as jckpt
from repro.launch import train as jtrain
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro_torch import convert
from repro_torch.ckpt.checkpointer import Checkpointer
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train
from repro_torch.models import moe, registry

ARCHS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b"]
TOL = 1e-5
BF16_TOL = 2e-2
B, S = 4, 16


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _inputs(cfg, seed, skew=False):
    """x (B, S, d) and the four leaves as numpy f32; `skew` adds a common
    direction to x and points expert 0's router column along it, so that
    nearly every token ranks expert 0 first."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    p = {"router": rng.normal(size=(d, e)) * 0.3,
         "wi_gate": rng.normal(size=(e, d, f)) * 0.1,
         "wi_up": rng.normal(size=(e, d, f)) * 0.1,
         "wo": rng.normal(size=(e, f, d)) * 0.1}
    if skew:
        u = rng.normal(size=d)
        x = x + u.astype(np.float32)
        p["router"][:, 0] = u / np.linalg.norm(u) * 2.0
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _port_leaves(p, dtype=torch.float32, grad=False):
    return SimpleNamespace(**{k: _t(v).to(dtype).requires_grad_(grad)
                              for k, v in p.items()})


def _jax_routing(p, x, cfg, group_size):
    """The reference's routing, its own lines of `moe_block` (moe.py:78-98)
    on its inputs: (idx, pos at each chosen expert, keep)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    g = min(group_size, b * s)
    ng = b * s // g
    cap = jmoe.expert_capacity(cfg, g)
    xg = x.reshape(ng, g, d)
    logits = jnp.einsum("ngd,de->nge", xg, p["router"].astype(x.dtype),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flat = sel.reshape(ng, g * k, e)
    pos = jnp.cumsum(flat, axis=1) - 1
    keep = (pos < cap) & (flat > 0)
    chosen = idx.reshape(ng, g * k, 1)
    pos_c = jnp.take_along_axis(pos, chosen, -1).reshape(ng, g, k)
    keep_c = jnp.take_along_axis(keep, chosen, -1).reshape(ng, g, k)
    return np.asarray(idx), np.asarray(pos_c), np.asarray(keep_c)


@pytest.mark.parametrize("group", [moe.GROUP_SIZE, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, group):
    cfg = registry.smoke_config(arch)
    jcfg = jregistry.smoke_config(arch)
    x, p = _inputs(cfg, seed=len(arch) + group, skew=group == 16)
    r = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jloss(x, p):
        out, aux = jmoe.moe_block(p, x, jcfg, group_size=group)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                              jax.tree.map(jnp.asarray, p))
    jidx, jpos, jkeep = _jax_routing(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), jcfg, group)

    leaves = _port_leaves(p, grad=True)
    tx = _t(x).requires_grad_()
    routing = moe.route(leaves, tx, cfg, group)
    assert np.array_equal(routing.idx.numpy(), jidx)
    assert np.array_equal(routing.pos.numpy(), jpos)
    assert np.array_equal(routing.keep.numpy(), jkeep)
    if group == 16:
        assert routing.capacity == 12 and not jkeep.all()
    else:
        assert jkeep.all()
    out, aux = moe.moe_block(leaves, tx, cfg, group_size=group)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert aux.shape == () and aux.dtype == torch.float32
    _close(out.detach(), jout)
    _close(aux.detach(), jaux)
    names = sorted(p)
    grads = torch.autograd.grad(torch.sum(out * _t(r)) + aux,
                                [tx] + [getattr(leaves, k) for k in names])
    _close(grads[0], jgrads[0])
    for name, got in zip(names, grads[1:], strict=True):
        _close(got, jgrads[1][name])


def test_router_ties_take_the_lower_expert_first():
    cfg = registry.smoke_config("phi3.5-moe-42b-a6.6b")
    x, p = _inputs(cfg, seed=3)
    p["router"][:, 2] = p["router"][:, 0]     # expert 2 ties expert 0
    p["router"][:, 3] = p["router"][:, 1]     # expert 3 ties expert 1
    jidx, _, _ = _jax_routing(p, jnp.asarray(x), cfg, moe.GROUP_SIZE)
    routing = moe.route(_port_leaves(p), _t(x), cfg)
    probs = routing.probs.numpy()
    assert np.array_equal(probs[..., 2], probs[..., 0])
    assert np.array_equal(routing.idx.numpy(), jidx)
    # the top two are always a tied pair, the lower index first
    rows = {tuple(r) for r in jidx.reshape(-1, 2).tolist()}
    assert rows == {(0, 2), (1, 3)}
    p["router"][:] = 0.0                      # four-way tie everywhere
    routing = moe.route(_port_leaves(p), _t(x), cfg)
    assert (routing.idx.numpy() == [0, 1]).all()
    jidx, _, _ = _jax_routing(p, jnp.asarray(x), cfg, moe.GROUP_SIZE)
    assert np.array_equal(routing.idx.numpy(), jidx)


def test_groups_must_divide_the_tokens():
    cfg = registry.smoke_config("mixtral-8x22b")
    x, p = _inputs(cfg, seed=4)
    x = x[:, :5]                               # 20 tokens, groups of 8
    with pytest.raises(ValueError, match="groups of 8"):
        moe.moe_block(_port_leaves(p), _t(x), cfg, group_size=8)
    with pytest.raises(AssertionError):
        jmoe.moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg,
                       group_size=8)


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_expert_capacity_matches_reference(cf):
    cfg = registry.smoke_config("phi3.5-moe-42b-a6.6b")
    for g in (1, 2, 8, 24, 100, 512, 4096):
        for e in (4, 8, 16, 64):
            for k in (1, 2, 4):
                c = dataclasses.replace(cfg, num_experts=e,
                                        experts_per_token=k,
                                        capacity_factor=cf)
                assert moe.expert_capacity(c, g) == \
                    jmoe.expert_capacity(c, g)
    full = {a: registry.get_spec(a).cfg for a in ARCHS}
    assert [moe.expert_capacity(full[a], g) for a in ARCHS
            for g in (512, 8)] == [80, 4, 160, 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bf16_matches_reference(arch):
    """The port in bf16 against the reference in f32 on the same bf16
    values (JAX's CPU backend has no bf16 x bf16 -> f32 batched product,
    so the reference cannot run this block in bf16 here)."""
    cfg = registry.smoke_config(arch)
    x, p = _inputs(cfg, seed=5)
    leaves = _port_leaves(p, torch.bfloat16)
    tx = _t(x).to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy())
    jp = {k: jnp.asarray(getattr(leaves, k).float().numpy()) for k in p}
    jout, jaux = jmoe.moe_block(jp, jx, cfg)
    jidx, _, _ = _jax_routing(jp, jx, cfg, moe.GROUP_SIZE)
    out, aux = moe.moe_block(leaves, tx, cfg)
    assert out.dtype == torch.bfloat16
    same = (moe.route(leaves, tx, cfg).idx.numpy() == jidx).all(-1)[0]
    assert same.mean() >= 0.95
    _close(out.float()[same.reshape(B, S)],
           np.asarray(jout, np.float32)[same.reshape(B, S)], BF16_TOL)
    _close(aux, jaux, BF16_TOL)


def _moe_tree(arch, seed=0):
    from repro.models.common import embed_init_scale
    from repro.sharding import init_from_defs

    cfg = jregistry.smoke_config(arch)
    return jax.tree.map(np.asarray, init_from_defs(
        jregistry.get_spec(arch).defs(cfg), jax.random.PRNGKey(seed),
        scale_fn=embed_init_scale))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_round_trip(arch):
    cfg = registry.smoke_config(arch)
    tree = _moe_tree(arch)
    mlp = tree["layers"]["mlp"]
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert {k: v.shape for k, v in mlp.items()} == {
        "router": (2, d, e), "wi_gate": (2, e, d, f), "wi_up": (2, e, d, f),
        "wo": (2, e, f, d)}
    for train_ in (False, True):
        back = convert.params_to_numpy(
            convert.params_from_numpy(tree, cfg, "cpu", train=train_))
        for (gp, got), (wp, want) in zip(convert.tree_leaves(back),
                                         convert.tree_leaves(tree),
                                         strict=True):
            assert gp == wp
            np.testing.assert_array_equal(got, want)
    mlp["wi_up"] = mlp["wi_up"][:, :, :, :1]
    with pytest.raises(ValueError, match="layers/mlp/wi_up"):
        convert.params_from_numpy(tree, cfg, "cpu")


ARGS = ["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--batch", "4",
        "--seq", "16", "--log-every", "0", "--no-preemption-guard",
        "--prefetch", "1"]


def _args(parser, steps, ckpt=""):
    argv = [*ARGS, "--steps", str(steps)]
    if ckpt:
        argv += ["--ckpt", str(ckpt), "--save-every", "2"]
    return parser().parse_args(argv)


def test_moe_checkpoints_cross_packages(tmp_path):
    whole = jtrain.train_loop(_args(jtrain.build_parser, 3))
    jtrain.train_loop(_args(jtrain.build_parser, 2, tmp_path / "jax"))
    got = train.train_loop(train.build_parser().parse_args(
        [*ARGS, "--steps", "3", "--ckpt", str(tmp_path / "jax"),
         "--save-every", "2", "--device", "cpu"]))
    assert got["last_step"] == 3 and len(got["losses"]) == 1
    _close(got["losses"], whole["losses"][2:])
    want = jax.tree.map(np.asarray, whole["state"]["params"])
    for (gp, g), (wp, w) in zip(
            convert.tree_leaves(convert.params_to_numpy(
                got["state"]["params"])),
            convert.tree_leaves(want), strict=True):
        assert gp == wp
        _close(g, w)
    # the port's checkpoint of that state, read by the reference
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(3, got["state"])
    template = jax.tree.map(lambda a: np.zeros_like(np.asarray(a)),
                            whole["state"])
    restored, _ = jckpt.Checkpointer(str(tmp_path / "port")).restore(
        template, 3)
    ours = convert.train_state_to_numpy(got["state"])
    theirs = jax.tree.map(np.asarray, restored)
    for (gp, g), (wp, w) in zip(convert.tree_leaves(ours),
                                convert.tree_leaves(theirs), strict=True):
        assert gp == wp
        np.testing.assert_array_equal(g, w)


def test_launch_serve_mixtral_on_the_cpu(capsys):
    toks = launch_serve.main(["--arch", "mixtral-8x22b", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "16",
                              "--decode-steps", "4"])
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
    assert "decoded (2, 4) on cpu" in capsys.readouterr().out
