"""Stage C on rank 0 under --dp 4: the towers, the FiD reader, the teacher, the losses (their normalizers summed over the ranks) and the backward. The mean of the program's stage timer's
``forward_backward`` stage over the traced run's stage steps; on the card, the
device's time between the span's two events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "forward_backward")
