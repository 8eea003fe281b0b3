"""Launches of the dropout-add kernel's forward in a train step: one a
hidden-dropout site (the embeddings, each residual branch, the decoders'
materialized attention probabilities), the remat recompute's included."""
from benchmark.layer_metrics._dropout_add import per_step


def read(record):
    return per_step(record, "dropout_add", "launches")
