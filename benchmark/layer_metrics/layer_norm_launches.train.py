"""Launches of the layer-norm kernel's forward in a train step: one a
Megatron-block norm call (each layer's two or three, each stack's final
norm; stage A's query tower, the towers, the reader, the teacher), the
remat recompute's included."""
from benchmark.layer_metrics._layer_norm import per_unit


def read(record):
    return per_unit(record, "layer_norm", "launches")
