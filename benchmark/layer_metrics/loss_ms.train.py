"""Stage C's joint loss (``emdr2_total_loss``). The mean of the program's
stage timer's ``loss`` stage (a child of ``forward_backward``) over the
traced run's steps; on the card, the device's time between the span's two
events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "loss")
