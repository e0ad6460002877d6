"""dense.gemm_share: the share of the device's busy time in the traced
pass spent in cuBLAS or CUTLASS matrix products (matched by kernel
name, `tracing.GEMM_MARKS`), in %: the model's products
(`models/transformer.py`, `models/layers.py`)."""

from pb import tracing


def read(r: dict):
    g = tracing.gemm_seconds(r["by_name"])
    if g <= 0 or r["busy_s"] <= 0:
        return None
    return g / r["busy_s"] * 100.0
