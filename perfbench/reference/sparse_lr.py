"""Plain sparse logistic regression with adagrad (the paper's LR).

One whole table of F weights. A step over a batch of padded-CSR samples
(ids (B, K), -1 = padding; vals (B, K); labels (B,)):

    z_b     = sum_k vals[b,k] * theta[ids[b,k]]
    loss    = mean_b -(y_b log s(z_b) + (1 - y_b) log s(-z_b))
    g_f     = sum over the slots (b, k) with ids[b,k] = f of
              vals[b,k] * (s(z_b) - y_b) / B
    acc_f  += g_f^2
    theta_f -= lr * g_f / sqrt(acc_f + eps)

Rows the batch does not touch have g_f = 0 and keep their values, so
only the rows that the batches touch are computed. `dtype` is the
arithmetic's: float64 for the reference, bfloat16 for the control (the
nearest precision below the configuration's float32); the loss is
taken in float64 from the logits either way.

The hot set (the features the program replicates) is worked out here
from the benchmark's batches by the configuration's rule: count each
feature's slots over the sample batches, keep those whose share of all
slots is at least `hot_threshold`, at most `max_hot` of them by
descending count, ties to the lower id. It splits the table into the
two leaves the numbers are taken over: the hot rows and the rest.
"""
from __future__ import annotations

import math


def hot_set(torch, ids_batches, num_features: int, threshold: float,
            max_hot: int):
    """Sorted int64 ids of the hot set."""
    flat = torch.cat([ids.reshape(-1).to(torch.int64) for ids in ids_batches])
    flat = flat[(flat >= 0) & (flat < num_features)]
    ids, counts = torch.unique(flat, return_counts=True)
    # the share in float32, the configuration's precision
    total = torch.tensor(float(max(int(counts.sum()), 1)),
                         dtype=torch.float32, device=counts.device)
    share = counts.to(torch.float32) / total
    keep = share >= torch.tensor(threshold, dtype=torch.float32,
                                 device=counts.device)
    ids, counts = ids[keep], counts[keep]
    # descending count, ties to the lower id: the ids come sorted, so a
    # stable sort by count
    order = torch.sort(counts, descending=True, stable=True).indices
    return torch.sort(ids[order][:max_hot]).values


def train(torch, theta0, batches, *, lr: float, eps: float, dtype,
          hot_ids) -> dict:
    """Adagrad steps over `batches` (dicts of ids, vals, labels) from the
    table `theta0`. Returns each step's loss, the first step's gradient
    norm by leaf ("hot", "cold"), and the norm of each leaf's change
    after the last step, all in float64 Python floats. Only the rows
    that the batches or the hot set name are taken from the table."""
    dev = theta0.device
    named = torch.cat([b["ids"].reshape(-1).to(torch.int64)
                       for b in batches] + [hot_ids.to(torch.int64)])
    rows_u = torch.unique(named[named >= 0])
    theta = theta0[rows_u].to(dtype)
    start = theta.clone()
    acc = torch.zeros_like(theta)
    is_hot = torch.isin(rows_u, hot_ids.to(torch.int64))
    touched = torch.zeros_like(is_hot)
    losses, grad_norms = [], None
    for batch in batches:
        ids = batch["ids"].to(torch.int64)
        vals = batch["vals"].to(dtype)
        y = batch["labels"].to(dtype)
        rows = ids.shape[0]
        valid = ids >= 0
        loc = torch.searchsorted(rows_u, torch.clamp(ids, min=0))
        th = torch.where(valid, theta[torch.clamp(loc, max=rows_u.numel()
                                                  - 1)], 0.0)
        z = torch.sum(vals * th, dim=1)
        z64 = z.to(torch.float64)
        y64 = y.to(torch.float64)
        nll = -(y64 * torch.nn.functional.logsigmoid(z64)
                + (1 - y64) * torch.nn.functional.logsigmoid(-z64))
        losses.append(float(nll.mean()))
        g_slot = vals * (torch.sigmoid(z) - y)[:, None]
        g_slot = g_slot / torch.tensor(float(rows), dtype=dtype, device=dev)
        u, inv = torch.unique(loc[valid], return_inverse=True)
        g = torch.zeros((u.numel(),), dtype=dtype, device=dev).index_add_(
            0, inv, g_slot[valid])
        if grad_norms is None:
            g64 = g.to(torch.float64)
            hot_u = is_hot[u]
            grad_norms = {
                "hot": math.sqrt(float(torch.sum(g64[hot_u] ** 2))),
                "cold": math.sqrt(float(torch.sum(g64[~hot_u] ** 2)))}
        a = acc[u] + g * g
        acc[u] = a
        theta[u] = theta[u] - lr * g * torch.rsqrt(a + eps)
        touched[u] = True
    change = (theta[touched] - start[touched]).to(torch.float64)
    hot_t = is_hot[touched]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": {
                "hot": math.sqrt(float(torch.sum(change[hot_t] ** 2))),
                "cold": math.sqrt(float(torch.sum(change[~hot_t] ** 2)))}}
