"""Stage A: the question embeddings, the int8 search and the rows' copy to
the host. The mean of the program's stage timer's ``retrieve`` stage
over the traced window's steps (each boundary waits for the stream)."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "retrieve")
