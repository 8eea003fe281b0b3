"""The layer-norm kernels' share of their roofline in a train step: the
bytes their launches in the window must move (counted by the wrapper,
forward, recompute and backward: each input read once, each output
written once, the backward's per-block partials written and read back)
over 3.35 TB/s, against the device time of the kernels whose name holds
``layer_norm``."""
from benchmark.layer_metrics._layer_norm import roofline


def read(record):
    return roofline(record)
