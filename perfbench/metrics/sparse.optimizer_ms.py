"""sparse.optimizer_ms: device ms a step under the optimizer's span (the
update `core.dpmr.optimize` takes from `optim.get_sparse_optimizer`, on
the table and on the hot set)."""


def read(r: dict):
    s = r["span_device_s"].get("optimizer.update", 0.0)
    return s / r["traced_steps"] * 1e3 if s > 0 else None
