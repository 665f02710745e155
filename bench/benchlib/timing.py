"""Timing one call: CUDA events on the card's clock, or the host's clock
on the CPU (the tests' runs)."""
from __future__ import annotations

import time


class CallTimer:
    """``start()`` before a call, ``stop()`` after its outputs are made;
    ``seconds()`` waits for the card and gives the time between the two
    on the card's clock. The stream is idle when the call starts (a
    closed loop synchronises after each call), so the start event runs as
    the call begins and the stop event once its last kernel has run and
    the host has returned."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            import torch

            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self._b.record()
        else:
            self._t1 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            self._b.synchronize()
            return self._a.elapsed_time(self._b) * 1e-3
        return self._t1 - self._t0


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if device.type == "cuda":
        import torch

        return torch.cuda.max_memory_allocated(device)
    return 0


def device_kind(device) -> str:
    if device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    return "cpu"
