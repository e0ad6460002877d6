"""mfu.dense: the whole step's share of the card's bf16 peak, in %: the
model FLOPs of a step (`roofline.dense_model_flops`: 6 N tokens over the
parameters that enter products, the input embedding's lookup left out,
and 3x the causal attention's forward), times the untraced window's
steps, over (its length x 989 TFLOP/s)."""

from pb import roofline


def read(r: dict):
    flops = r["model_flops_per_step"] * r["window_steps"]
    if flops <= 0:
        return None
    return flops / (r["window_elapsed_s"] * roofline.BF16_TC_FLOPS) * 100.0
