"""Stage C's teacher: the reader over the query and one passage a row, with
no gradient (``_teacher_gold_log_probs``). The mean of the program's stage
timer's ``teacher_forward`` stage (a child of ``forward_backward``) over the
traced run's steps; on the card, the device's time between the span's two
events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "teacher_forward")
