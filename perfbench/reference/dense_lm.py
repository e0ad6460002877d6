"""Plain decoder-only transformer training (the LLaMA architecture that
Yi-6B publishes), in float32 with TF32 off.

Configuration keys are the published `config.json`'s (`hidden_size`,
`num_attention_heads`, ...). A layer is pre-norm: RMSNorm, attention
with rotary positions (the rotate-half form, theta `rope_theta`) and
grouped KV heads (query head j reads KV head j // (H / KH)), causal,
scaled by 1/sqrt(head_dim); then RMSNorm and the SwiGLU MLP
silu(x W_gate) * (x W_up) W_down; residual adds around both. A final
RMSNorm and the untied output matrix give the logits; the loss is the
mean cross-entropy of the next tokens. The step is the configuration's
`training` group: adamw (bias-corrected moments, eps 1e-8, decoupled
weight decay on every leaf), the gradients clipped to a global norm,
and a linear warmup into a cosine decay.

Parameter names and layouts are the benchmark's (`param_shapes`); the
runner hands the program the same weights under the same names. Each
layer runs under activation checkpointing and the attention one query
block at a time, which changes no number, only the memory.

`precision` "float32" is the reference. "fp8" is the control: every
matrix product takes its two operands rounded to float8 e4m3 with a
per-tensor scale (its amax to 448), forward and backward, the nearest
precision below the configuration's bfloat16 activations.
"""
from __future__ import annotations

import contextlib
import math

E4M3_MAX = 448.0


def dims(c: dict) -> dict:
    d, h = c["hidden_size"], c["num_attention_heads"]
    return {"d": d, "f": c["intermediate_size"], "h": h,
            "kh": c["num_key_value_heads"], "hd": d // h,
            "layers": c["num_hidden_layers"], "vocab": c["vocab_size"],
            "eps": c["rms_norm_eps"], "theta": c["rope_theta"]}


def param_shapes(c: dict) -> list:
    """(name, shape) of every parameter, in the order the weights are
    drawn."""
    n = dims(c)
    d, f, h, kh, hd = n["d"], n["f"], n["h"], n["kh"], n["hd"]
    out = [("embed", (n["vocab"], d))]
    for i in range(n["layers"]):
        p = f"layers.{i}."
        out += [(p + "attn.wq", (d, h, hd)), (p + "attn.wk", (d, kh, hd)),
                (p + "attn.wv", (d, kh, hd)), (p + "attn.wo", (h, hd, d)),
                (p + "mlp.wi_gate", (d, f)), (p + "mlp.wi_up", (d, f)),
                (p + "mlp.wo", (f, d)), (p + "ln1", (d,)), (p + "ln2", (d,))]
    out += [("ln_f", (d,)), ("unembed", (d, n["vocab"]))]
    return out


def product_params(c: dict) -> int:
    """Parameters that enter matrix products: all but the input
    embedding (a lookup) and the norm scales."""
    return sum(math.prod(s) for name, s in param_shapes(c)
               if len(s) > 1 and name != "embed")


def make_params(torch, c: dict, draw) -> dict:
    """The weights: every matrix N(0, initializer_range^2) from one call
    of `draw(n)` (n values on the device), every norm scale ones.
    Returns {name: f32 tensor} (views of one buffer)."""
    shapes = param_shapes(c)
    total = sum(math.prod(s) for _, s in shapes if len(s) > 1)
    flat = draw(total).mul_(c["initializer_range"])
    out, at = {}, 0
    for name, s in shapes:
        if len(s) > 1:
            n = math.prod(s)
            out[name] = flat[at:at + n].view(s)
            at += n
        else:
            out[name] = torch.ones(s, dtype=torch.float32,
                                   device=flat.device)
    return out


def _q8(torch, t):
    amax = torch.clamp(t.detach().abs().amax(), min=1e-30)
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s


def _fp8_product(torch):
    class Fp8MatMul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return torch.matmul(_q8(torch, a), _q8(torch, b))

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            gq, aq, bq = _q8(torch, g), _q8(torch, a), _q8(torch, b)
            da = torch.matmul(gq, bq.transpose(-1, -2))
            if b.dim() == 2:
                db = aq.reshape(-1, a.shape[-1]).T @ gq.reshape(
                    -1, g.shape[-1])
            else:
                db = torch.matmul(aq.transpose(-1, -2), gq)
            return da, db

    return Fp8MatMul.apply


def _rms(torch, x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + eps) * w


def _rope(torch, x, sin, cos):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(torch, q, k, v, mm, block: int):
    """Causal attention, (B, S, H, hd) -> (B, S, H, hd): the exact
    softmax of each query over the keys up to its own position, one
    block of `block` queries at a time."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(0, s, block):
        end = min(i + block, s)
        sc = mm(qt[:, :, i:end], kt[:, :, :end].transpose(-1, -2)) * scale
        qpos = torch.arange(i, end, device=q.device)[:, None]
        kpos = torch.arange(end, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        outs.append(mm(torch.softmax(sc, dim=-1), vt[:, :, :end]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def _layer(torch, p, i, x, n, sin, cos, mm, block):
    pre = f"layers.{i}."
    b, s, d = x.shape
    h = _rms(torch, x, p[pre + "ln1"], n["eps"])
    q = mm(h, p[pre + "attn.wq"].reshape(d, -1)).view(b, s, n["h"], n["hd"])
    k = mm(h, p[pre + "attn.wk"].reshape(d, -1)).view(b, s, n["kh"],
                                                       n["hd"])
    v = mm(h, p[pre + "attn.wv"].reshape(d, -1)).view(b, s, n["kh"],
                                                       n["hd"])
    q, k = _rope(torch, q, sin, cos), _rope(torch, k, sin, cos)
    att = _attention(torch, q, k, v, mm, block).reshape(b, s, -1)
    x = x + mm(att, p[pre + "attn.wo"].reshape(-1, d))
    h = _rms(torch, x, p[pre + "ln2"], n["eps"])
    gate = mm(h, p[pre + "mlp.wi_gate"])
    up = mm(h, p[pre + "mlp.wi_up"])
    return x + mm(torch.nn.functional.silu(gate) * up, p[pre + "mlp.wo"])


def loss_fn(torch, p: dict, tokens, labels, c: dict, mm, block: int = 1024,
            loss_chunk: int = 2048):
    """Mean next-token cross-entropy (0-d f32)."""
    from torch.utils.checkpoint import checkpoint

    n = dims(c)
    s = tokens.shape[1]
    half = n["hd"] // 2
    freqs = n["theta"] ** (-torch.arange(0, half, dtype=torch.float32,
                                         device=tokens.device) / half)
    ang = torch.arange(s, dtype=torch.float32,
                       device=tokens.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[None, :, None, :], torch.cos(ang)[None, :,
                                                                None, :]
    x = p["embed"][tokens.long()]
    for i in range(n["layers"]):
        x = checkpoint(_layer, torch, p, i, x, n, sin, cos, mm, block,
                       use_reentrant=False)

    def head(xc, yc):
        xn = _rms(torch, xc, p["ln_f"], n["eps"])
        logits = mm(xn, p["unembed"])
        return torch.sum(torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, yc.long()[..., None])[..., 0])

    xf = x.reshape(-1, x.shape[-1])
    yf = labels.reshape(-1)
    total = sum(checkpoint(head, xf[i:i + loss_chunk], yf[i:i + loss_chunk],
                           use_reentrant=False)
                for i in range(0, xf.shape[0], loss_chunk))
    return total / xf.shape[0]


@contextlib.contextmanager
def no_tf32(torch):
    """Full float32 products while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def lr_at(tc: dict, step: int) -> float:
    """Linear warmup to `learning_rate` over `warmup_steps`, then a cosine
    down to `final_lr_fraction` of it at `total_steps` (`step` counts
    the updates before this one)."""
    lr, w, total = tc["learning_rate"], tc["warmup_steps"], \
        tc["total_steps"]
    if step < w:
        return lr * step / max(w, 1)
    prog = min(max((step - w) / max(total - w, 1), 0.0), 1.0)
    frac = tc["final_lr_fraction"]
    return frac * lr + (1 - frac) * lr * 0.5 * (1 + math.cos(math.pi * prog))


def train(torch, c: dict, make, batches, precision: str = "float32"
          ) -> dict:
    """Adamw steps over `batches` from the weights `make()` returns.
    Returns each step's loss, the first step's clipped gradient norm by
    leaf and the norm of each leaf's change after the last step."""
    tc = c["training"]
    mm = torch.matmul if precision == "float32" else _fp8_product(torch)
    with no_tf32(torch):
        p = {k: t.detach().requires_grad_() for k, t in make().items()}
        names = list(p)
        m = {k: torch.zeros_like(t) for k, t in p.items()}
        v = {k: torch.zeros_like(t) for k, t in p.items()}
        b1, b2 = tc["beta1"], tc["beta2"]
        losses, grad_norms = [], None
        for s, batch in enumerate(batches):
            loss = loss_fn(torch, p, batch["tokens"], batch["labels"], c, mm)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(tc["grad_clip"] / torch.clamp(
                    norm, min=1e-9), max=1.0)
                grads = [g * scale for g in grads]
                if grad_norms is None:
                    grad_norms = {k: float(torch.linalg.vector_norm(
                        g.to(torch.float64))) for k, g in zip(names, grads)}
                lr = lr_at(tc, s)
                bc1, bc2 = 1 - b1 ** (s + 1), 1 - b2 ** (s + 1)
                for k, g in zip(names, grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).add_(g * g, alpha=1 - b2)
                    upd = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + 1e-8) \
                        + tc["weight_decay"] * p[k]
                    p[k].sub_(lr * upd)
            del grads, loss
        del m, v
        start = make()
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(
                (p[k] - start[k]).to(torch.float64))) for k in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
