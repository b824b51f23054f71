"""Fault tolerance: preemption handling, restart, straggler watchdog.

The reference package's ``repro.train.fault_tolerance``:

  * ``PreemptionGuard`` — converts SIGTERM/SIGINT into a "save now" flag
    checked once per step; the last completed step is always recoverable.
  * ``resume_or_init`` — restart-from-latest on boot (idempotent relaunch:
    the scheduler can just re-exec the same command on a fresh node set).
  * ``StepWatchdog`` — per-step wall-time tracker; steps slower than
    ``threshold_x`` times the trailing median are recorded as straggler
    events.

``elastic_reshard`` (re-slicing a checkpoint onto a new mesh by the
logical sharding rules) raises ``NotImplementedError``: the LM side of the
mesh is not ported yet (ROADMAP queue 1, item 13f).
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Optional

from repro_torch.train import checkpoint as ckpt


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self.requested = True

    def restore_handlers(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


def resume_or_init(directory, init_fn, like_state=None, shardings=None):
    """Returns (state, start_step).  Restores the newest committed
    checkpoint if present, else calls init_fn()."""
    like = like_state if like_state is not None else init_fn()
    restored, step = ckpt.restore_latest(directory, like, shardings)
    if restored is None:
        return like, 0
    return restored, step


def elastic_reshard(directory, step, like_state, axes_tree, new_mesh,
                    rules=None):
    raise NotImplementedError(
        "elastic_reshard needs the logical-axis sharding rules of the LM "
        "side of the mesh, not ported yet (ROADMAP queue 1, item 13f)")


class StepWatchdog:
    def __init__(self, threshold_x: float = 2.5, window: int = 32):
        self.threshold_x = threshold_x
        self.window = window
        self.times: list = []
        self.straggler_events: list = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int):
        dt = time.perf_counter() - self._t0
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if dt > self.threshold_x * med:
                self.straggler_events.append((step, dt, med))
        self.times.append(dt)
        return dt
