"""The whole T5 v1.1 step's share of the card's bf16 peak: the yardstick's
model FLOPs of the window's work (``counts/t5v11.py``) over its time."""
from benchmark.layer_metrics._common import mfu


def read(record):
    return mfu(record)
