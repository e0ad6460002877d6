"""sparse.host_ops: top-level host operations a step (the torch and c10d
calls `DPMREngine.fit_sgd` makes on its main thread, not those they make
in turn), counted in a host-only profile of the traced batches."""


def read(r: dict):
    n = r.get("host_ops_per_step")
    return n if n else None
