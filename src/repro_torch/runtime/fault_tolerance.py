"""Fault tolerance: retries, preemption-graceful save, straggler watchdog,
failure injection for tests. A copy of `repro.runtime.fault_tolerance`
(pure Python; the port keeps its own).

At 1000+ nodes the failure model is: (a) preemption signals (graceful), (b)
hard node loss (restart from checkpoint, possibly on fewer nodes — see
runtime/elastic.py), (c) stragglers (slow HBM/ICI on one chip stalls the
SPMD step). The host-side pieces here cover the coordinator's half of each:
checkpoint cadence + signal-triggered save, bounded retry-with-restore, and
a step-time watchdog that flags outliers for the scheduler to evict.
"""
from __future__ import annotations

import collections
from collections.abc import Callable
import logging
import signal
import statistics
import threading
import time

log = logging.getLogger("repro_torch.ft")


class PreemptionGuard:
    """Sets a flag on SIGTERM/SIGINT so the train loop can save and exit."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received", signum)
        self._flag.set()

    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self):         # for tests
        self._flag.set()


class StragglerWatchdog:
    """Tracks per-step wall time; flags steps > `factor` x rolling median.

    On a real pod the flagged host/chip id would be reported to the cluster
    scheduler for eviction; here we record and expose the events.
    """

    def __init__(self, window: int = 50, factor: float = 3.0):
        self.times = collections.deque(maxlen=window)
        self.factor = factor
        self.events = []
        self._t0: float | None = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int):
        if self._t0 is None:
            return
        dt = time.monotonic() - self._t0
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.factor * med:
                self.events.append({"step": step, "seconds": dt,
                                    "median": med})
                log.warning("straggler step %d: %.3fs vs median %.3fs",
                            step, dt, med)
        self.times.append(dt)


class FailureInjector:
    """Deterministic failure injection for integration tests."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.failed = []

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failed.append(step)
            raise RuntimeError(f"injected failure at step {step}")


def run_with_restarts(make_loop: Callable[[int | None], int],
                      max_restarts: int = 3) -> int:
    """Run `make_loop(resume_step)` restarting on failure.

    make_loop returns the last completed step; on exception we restart from
    whatever the checkpointer has. Returns the final step."""
    restarts = 0
    last = None
    while True:
        try:
            return make_loop(last)
        except Exception as e:  # noqa: BLE001 — the point is to survive
            restarts += 1
            log.warning("training failed (%s); restart %d/%d",
                        e, restarts, max_restarts)
            if restarts > max_restarts:
                raise
            last = None  # loop must re-read the checkpoint
