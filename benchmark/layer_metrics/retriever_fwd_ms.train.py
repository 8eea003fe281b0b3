"""Stage C's retriever: the query and context towers, their scores and the
log-softmax (``EMDR2Model._topk_log_probs``). The mean of the program's
stage timer's ``retriever_forward`` stage (a child of ``forward_backward``)
over the traced run's steps; on the card, the device's time between the
span's two events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "retriever_forward")
