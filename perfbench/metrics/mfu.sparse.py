"""mfu.sparse: the whole step's share of the card's peak, in %: the sum
over the untraced window's steps of each step's least time on the
roofline (`roofline.sparse_step_work` of its batch: ids, values and
labels read once, the touched parameter and adagrad rows read and
written once; the larger of bytes / 3.35 TB/s and FLOPs / 67 TFLOP/s),
over the window's length."""


def read(r: dict):
    if r["window_least_s"] <= 0:
        return None
    return r["window_least_s"] / r["window_elapsed_s"] * 100.0
