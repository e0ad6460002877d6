"""sparse_kernels_roofline: the kernel seam's share of its roofline, in %.

Numerator: the least time of the work of every top-level call of the
seam (`kernels/ops.py`: sigmoid_grad, segment_sum_sorted,
sorted_run_totals, owner_accumulate, row_update) over the traced
batches, each call's bytes counted from its arguments' shapes
(`roofline.seam_call_work`) over 3.35 TB/s. Denominator: the device time under
those calls' spans in the traced pass."""


def read(r: dict):
    dev = r["seam_device_s"]
    if dev <= 0 or r["seam_least_s"] <= 0:
        return None
    return r["seam_least_s"] / dev * 100.0
