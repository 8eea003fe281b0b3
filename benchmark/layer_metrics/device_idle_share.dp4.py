"""The share of the traced window in which no operation ran on rank 0's
card (the profiler's device timeline, rank 0's process)."""
from benchmark.layer_metrics._common import idle_share


def read(record):
    return idle_share(record)
