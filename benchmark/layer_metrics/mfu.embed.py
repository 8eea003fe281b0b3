"""The whole step's share of the card's bf16 peak: the yardstick's model
FLOPs of the window's work over its time."""
from benchmark.layer_metrics._common import mfu


def read(record):
    return mfu(record)
