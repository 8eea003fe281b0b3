"""The layer-norm kernel's share of its roofline in the embedder: the
bytes its forward launches over the window's passages must move (counted
by the wrapper: x read once, the output written once) over 3.35 TB/s,
against the device time of the kernels whose name holds ``layer_norm``."""
from benchmark.layer_metrics._layer_norm import roofline


def read(record):
    return roofline(record)
