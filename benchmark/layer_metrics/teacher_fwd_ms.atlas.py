"""Stage C's teacher: the T5 v1.1 reader over one passage at a time, no gradient (``_teacher_gold_log_probs``). The mean of the program's stage timer's ``teacher_forward`` stage
over the traced run's steps; on the card, the device's time between the
span's two events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "teacher_forward")
