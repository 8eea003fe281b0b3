"""Stage C: the towers, the FiD reader, the teacher, the losses and the
backward. The mean of the program's stage timer's ``forward_backward``
stage over the traced window's steps (each boundary waits for the
stream)."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "forward_backward")
