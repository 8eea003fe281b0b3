"""Stage A under --dp 4: the query tower, each rank's K3 search of its shard, the all-gathers of the queries and of the candidates and ``sharded_mips_topk``'s merge, rows to the host (``E2EQATask.build_device_batch``), on rank 0. The mean of the program's stage timer's
``retrieve`` stage over the traced run's stage steps; on the card, the
device's time between the span's two events."""
from benchmark.layer_metrics._common import stage_mean_ms


def read(record):
    return stage_mean_ms(record, "retrieve")
