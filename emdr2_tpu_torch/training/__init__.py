"""Training: the step, the loop around it, prefetching and checkpoints."""

from emdr2_tpu_torch.training.checkpointing import (finalize_async_saves,
                                                    latest_iteration,
                                                    load_checkpoint,
                                                    save_checkpoint)
from emdr2_tpu_torch.training.engine import TrainLog, train
from emdr2_tpu_torch.training.prefetch import (BatchPrefetcher,
                                              DataParallelPrefetcher)
from emdr2_tpu_torch.training.step import TrainState

__all__ = ["BatchPrefetcher", "DataParallelPrefetcher", "TrainLog", "TrainState",
           "finalize_async_saves", "latest_iteration", "load_checkpoint",
           "save_checkpoint", "train"]
