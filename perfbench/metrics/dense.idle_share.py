"""dense.idle_share: the device's idle share of a step of the dense
trainer (`train/trainer.py`), in %: 1 - (device busy a step in the
traced pass) / (the untraced window's wall a step), as
`chip_smoke.profile_steps` computes it."""


def read(r: dict):
    busy = r["busy_s"] / r["traced_steps"]
    if busy <= 0:
        return None
    return (1.0 - busy / r["wall_per_step_s"]) * 100.0
