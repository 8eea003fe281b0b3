"""What the per-layer readers share. A reader is ``read(record)``: the
metric's value from a traced run's record, or None where the record has
nothing to read it from (the harness then leaves the metric out).

The record: the ``units`` of work (steps, passages) in the window of
``window_s`` seconds; the traced window's ``traced_s`` and the device's
``busy_s`` in it; ``kernel_s`` (device seconds by operation name);
``stage_ms`` (the program's stage timer: lists of milliseconds by
stage); ``peak_bytes`` (the allocator's peak over the window);
``flops_per_unit`` and ``attention_per_unit`` (the yardstick's counts,
``benchmark/counts``); ``peak`` (the card's rates, or None for a card
not in the table).
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.counts.flops import least_seconds

HERE = Path(__file__).resolve().parent


def mfu(record):
    """Model FLOPs over the window against the card's bf16 peak, in %."""
    if not record.get("peak") or not record.get("flops_per_unit"):
        return None
    rate = record["flops_per_unit"] * record["units"] / record["window_s"]
    return 100.0 * rate / record["peak"]["bf16"]


def stage_mean_ms(record, stage):
    times = record.get("stage_ms", {}).get(stage)
    return sum(times) / len(times) if times else None


def idle_share(record):
    if not record.get("traced_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["traced_s"])


def peak_gib(record):
    return record["peak_bytes"] / 2 ** 30 if record.get("peak_bytes") else None


def roofline(record, metric):
    """The least time of the window's attention work over the device time
    of the kernels ``counts/<metric>.json`` names, in %."""
    with open(HERE.parent / "counts" / f"{metric}.json") as f:
        names = json.load(f)["kernels"]
    spent = sum(s for k, s in record.get("kernel_s", {}).items()
                if any(n in k for n in names))
    if not spent or not record.get("peak") or not record.get(
            "attention_per_unit"):
        return None
    least = least_seconds(record["attention_per_unit"], record["peak"])
    return 100.0 * least * record["units"] / spent
