"""The gradient's all-reduce over the 4 ranks (``Optimizer.step``'s ``dp.all_reduce_grads_``, fixed buckets over NCCL), on rank 0; a program without the span gives nothing. The mean of the program's stage timer's
``grad_all_reduce`` stage over the traced run's stage steps; on the card, the
device's time between the span's two events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "grad_all_reduce")
