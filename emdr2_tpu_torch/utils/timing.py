"""Per-stage wall-clock timing for the serving path."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class StageTimer:
    """Milliseconds per named stage. Each boundary synchronizes ``device``
    (when it is a CUDA device), so the host clock covers the device work of
    the stage and nothing of the next one."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms: Dict[str, List[float]] = defaultdict(list)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.ms[name].append((time.perf_counter() - t0) * 1e3)


def stage(timer: Optional[StageTimer], name: str):
    """``timer.stage(name)``, or a no-op context without a timer."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()
