"""Stage C with the T5 v1.1 reader: the towers, the FiD reader, the teacher, the losses and the backward. The mean of the program's stage timer's ``forward_backward`` stage
over the traced run's steps; on the card, the device's time between the
span's two events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "forward_backward")
