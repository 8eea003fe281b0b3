"""The share of the traced window in which no operation ran on the card
(the profiler's device timeline)."""
from benchmark.layer_metrics._common import idle_share


def read(record):
    return idle_share(record)
