"""Fault-tolerance runtime: step watchdog, failure recovery, straggler
accounting. The port's copy of ``repro/ft/manager.py`` (plain Python).

Node failure surfaces as an exception raised from the step call (a
collective timeout, a device error). ``RestartManager`` wraps the step:
on a failure it restores the latest committed checkpoint into the state
(in place, ``checkpoint/ckpt.py``) and resumes from its step. ``Watchdog``
tracks step latencies and flags stragglers (more than k sigma above the
running mean).
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Watchdog:
    k_sigma: float = 4.0
    warmup: int = 3
    _n: int = 0
    _mean: float = 0.0
    _m2: float = 0.0
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        """Record a step latency; returns True if it is a straggler."""
        self._n += 1
        delta = dt - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (dt - self._mean)
        if self._n <= self.warmup:
            return False
        var = self._m2 / max(self._n - 1, 1)
        is_straggler = dt > self._mean + self.k_sigma * max(var, 1e-12) ** 0.5
        self.stragglers += int(is_straggler)
        return is_straggler


class RestartManager:
    """Run steps with checkpoint/restart recovery."""

    def __init__(self, ckpt_manager, save_every: int = 50, max_retries: int = 3):
        self.ckpt = ckpt_manager
        self.save_every = save_every
        self.max_retries = max_retries
        self.watchdog = Watchdog()
        self.recoveries = 0

    def run(self, state, step0: int, n_steps: int, step_fn, make_batch, on_metrics=None):
        """state: (params, opt_state). step_fn(state, step, batch)->
        (state, metrics). make_batch(step)->batch. Returns final state."""
        step = step0
        retries = 0
        while step < step0 + n_steps:
            batch = make_batch(step)
            t0 = time.time()
            try:
                state, metrics = step_fn(state, step, batch)
            except Exception:
                retries += 1
                self.recoveries += 1
                if retries > self.max_retries:
                    raise
                restored, ck_step = self.ckpt.restore_latest(state)
                if restored is not None:
                    state, step = restored, ck_step
                continue
            retries = 0
            if self.watchdog.observe(time.time() - t0) and on_metrics:
                on_metrics(step, {"straggler": True})
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save_async(step, state)
        self.ckpt.wait()
        return state, step
