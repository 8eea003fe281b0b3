"""Named wall-clock timers for the training engine's phases (port of
``emdr2_tpu/utils/timers.py``).

A timer's ``stop(wait_for=...)`` first waits for device work, so the host
clock covers it: ``wait_for`` is a ``torch.cuda.Stream`` or
``torch.cuda.Event`` (only that stream's work or that event is waited for),
or a device, e.g. ``"cuda"`` (everything on it). Deeper traces use
``utils.monitoring.profile_steps``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch


def _wait(wait_for) -> None:
    if hasattr(wait_for, "synchronize"):          # a stream or an event
        wait_for.synchronize()
        return
    device = torch.device(wait_for)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self._elapsed = 0.0
        self._start: Optional[float] = None

    def start(self) -> "_Timer":
        assert self._start is None, f"timer {self.name} already running"
        self._start = time.perf_counter()
        return self

    def stop(self, wait_for=None) -> None:
        assert self._start is not None, f"timer {self.name} not running"
        if wait_for is not None:
            _wait(wait_for)
        self._elapsed += time.perf_counter() - self._start
        self._start = None

    def elapsed(self, reset: bool = True) -> float:
        running = self._start is not None
        if running:
            self.stop()
        out = self._elapsed
        if reset:
            self._elapsed = 0.0
        if running:
            self.start()
        return out


class Timers:
    def __init__(self):
        self._timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self._timers:
            self._timers[name] = _Timer(name)
        return self._timers[name]

    def log(self, names=None, normalizer: float = 1.0,
            reset: bool = True) -> str:
        """Elapsed times in ms, each divided by ``normalizer``."""
        names = names if names is not None else list(self._timers)
        parts = []
        for name in names:
            if name in self._timers:
                ms = (self._timers[name].elapsed(reset=reset) * 1000.0
                      / normalizer)
                parts.append(f"{name}: {ms:.2f}")
        return "time (ms) | " + " | ".join(parts)
