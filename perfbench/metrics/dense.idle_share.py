"""dense.idle_share: the device's idle share of the dense trainer's
traced pass (`train/trainer.py`), in %: 1 - (device busy, the union of
every device operation's interval) / (the traced pass's wall), both from
the one profile. The step is paced by the card, and the profiler
stretches its kernels by about as much as the card idles, so busy time
under the profiler is not held against the untraced window's wall."""


def read(r: dict):
    busy = r["busy_s"]
    if busy <= 0:
        return None
    return (1.0 - busy / r["traced_window_s"]) * 100.0
