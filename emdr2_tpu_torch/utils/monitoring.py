"""Observability: device memory report and TensorBoard scalars (port of
``emdr2_tpu/utils/monitoring.py``; spans are ``utils/timing.py``'s).

- ``report_memory`` prints each CUDA device's allocator statistics
  (``torch.cuda.memory_stats``) beside the device's free / total
  (``torch.cuda.mem_get_info``); with no CUDA device it prints nothing;
- ``MetricsWriter`` writes TensorBoard scalars and text when a log
  directory is given and ``torch.utils.tensorboard`` imports, else nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def report_memory(prefix: str = "", printer=print) -> Dict[str, float]:
    """GB allocated on each visible CUDA device, by device name."""
    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        used = stats.get("allocated_bytes.all.current", 0) / 1e9
        peak = stats.get("allocated_bytes.all.peak", 0) / 1e9
        reserved = stats.get("reserved_bytes.all.current", 0) / 1e9
        out[f"cuda:{i}"] = used
        printer(f"{prefix}[cuda:{i}] memory used {used:.2f} GB "
                f"| peak {peak:.2f} GB | reserved {reserved:.2f} GB "
                f"| free {free / 1e9:.2f} of {total / 1e9:.2f} GB")
    return out


class MetricsWriter:
    """TensorBoard scalar writer; a no-op without a log directory or when
    tensorboard cannot be imported."""

    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._writer = SummaryWriter(log_dir=log_dir)

    def scalars(self, metrics: Dict[str, float], step: int) -> None:
        if self._writer is None:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), step)

    def text(self, tag: str, value: str, step: int = 0) -> None:
        if self._writer is not None:
            self._writer.add_text(tag, value, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
