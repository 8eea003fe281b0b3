"""Stage B: the host's passage formatting (C++) into the three token
layouts. The mean of the program's stage timer's ``postprocess`` stage
over the traced window's steps (each boundary waits for the stream)."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "postprocess")
