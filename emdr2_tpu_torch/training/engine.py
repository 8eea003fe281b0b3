"""Training engine: the epoch / interval loop of end-to-end EMDR2 training
(port of ``emdr2_tpu/training/engine.py``).

Per-interval loss averages and timer logs, checkpoint and evaluation
intervals, the ``exit_interval`` and time-budget clean exits, the epoch /
iteration resume math (``iteration -> epoch, batch offset``), the prefetcher
and the handshake points of an index refresher.

Unlike the JAX loop, every exit path (an exception included) stops the
refresher and the prefetch worker and drains an in-flight checkpoint write,
so a raising step leaves no live embedder and no thread behind.

Data parallelism (``dp``): every rank runs this loop in lockstep over the
same global batches, each feeding its contiguous slice
(``epoch_batches(rank=, world_size=)``); rank 0 writes the checkpoints
and logs; the time budget is decided together (an all-reduce), so no rank
leaves while the others wait in a collective. The prefetcher there is
``DataParallelPrefetcher``: the search's collectives stay on this thread,
in the same order as the step's on every rank (``training/prefetch.py``).
"""

from __future__ import annotations

import pprint
import time
from typing import Callable, Dict, List, Optional

from emdr2_tpu_torch.config import EMDR2Config
from emdr2_tpu_torch.training import checkpointing as ckpt_lib
from emdr2_tpu_torch.training.prefetch import (BatchPrefetcher,
                                              DataParallelPrefetcher)
from emdr2_tpu_torch.utils import monitoring
from emdr2_tpu_torch.utils.timing import StageTimer


class TrainLog:
    """Interval-averaged metric logging. Metrics may be 0-d device tensors:
    they are read (one wait for the device per value) only when an interval
    closes, so the steps in between queue up without waiting."""

    def __init__(self, log_interval: int,
                 printer: Callable[[str], None] = print):
        self.log_interval = log_interval
        self.printer = printer
        self._pending: List[Dict] = []
        self._t0 = time.perf_counter()
        self.history: List[Dict[str, float]] = []

    def push(self, iteration: int, total_iters: int, metrics: Dict) -> None:
        self._pending.append(metrics)
        if iteration % self.log_interval == 0:
            acc: Dict[str, float] = {}
            for m in self._pending:
                for k, v in m.items():
                    acc[k] = acc.get(k, 0.0) + float(v)
            count = len(self._pending)
            avg = {k: v / count for k, v in acc.items()}
            ms = (time.perf_counter() - self._t0) * 1000.0 / count
            avg["ms_per_iter"] = ms
            avg["iteration"] = iteration
            self.history.append(avg)
            parts = " | ".join(f"{k} {v:.4e}" for k, v in avg.items()
                               if k != "iteration")
            self.printer(f" iteration {iteration:8d}/{total_iters} | {parts}")
            self._pending = []
            self._t0 = time.perf_counter()


def _silent(_: str) -> None:
    pass


def _time_line(timer: StageTimer, steps: int) -> str:
    """The interval's ms a step: the host's wait for batches, the steps'
    time (the card's where it has events); then forgets the interval."""
    batch = sum(timer.host_ms["batch"]) / steps
    step = sum(timer.ms["step"]) / steps
    timer.clear()
    return f"time (ms) | batch: {batch:.2f} | step: {step:.2f}"


def _past(deadline: float, dp) -> bool:
    """Whether the time budget is spent, on any rank (one all-reduce over
    every rank of the grid, so all take the same exit)."""
    late = time.perf_counter() > deadline
    world = dp.world if dp is not None else None
    if world is None or not world.distributed:
        return late
    import torch
    return bool(world.all_reduce_sum_(torch.tensor([float(late)])) > 0)


def train(task, dataset, cfg: EMDR2Config,
          refresher=None,
          save_dir: Optional[str] = None,
          eval_callback: Optional[Callable[[int], Optional[Dict]]] = None,
          tensorboard_dir: Optional[str] = None,
          prefetch_depth: int = 0,
          timeout_minutes: Optional[float] = None,
          printer: Callable[[str], None] = print,
          log: Optional[TrainLog] = None, dp=None) -> int:
    """Run the training loop; returns the final iteration.

    ``task`` is an ``E2EQATask`` with an initialized state (a resumed one
    continues from ``task.state.step``); ``dataset`` an ``OpenQADataset``.
    The total is ``epochs x batches per epoch`` unless
    ``cfg.train.train_iters`` is set, which is then authoritative: epochs
    cycle, reshuffled per pass, until it is reached.

    ``refresher`` (optional) is any object with ``start(model)``,
    ``maybe_swap(iteration, model) -> bool`` and ``stop(wait=...)``: it
    re-embeds the evidence and swaps the index in. ``eval_callback(
    iteration)`` may return a metrics dict (e.g. ``{"valid_em": ...}``),
    which is written to TensorBoard at that iteration. With
    ``prefetch_depth > 0`` a worker thread builds the next batches
    (``training/prefetch.py``; under data parallelism the searches stay
    on this thread). Interval saves follow
    ``cfg.train.async_save``; the exit, time-budget and final saves are
    synchronous, durable before return. ``log`` (optional) is the
    ``TrainLog`` to push to, for a caller that reads its ``history``.
    ``dp``: the data-parallel group (module docstring).

    The metrics writer is closed, the refresher and the prefetch worker
    are stopped and a background checkpoint write is drained on every exit
    path: normal completion, time budget, ``exit_interval`` and an
    exception on its way out."""
    tcfg = cfg.train
    distributed = dp is not None and dp.world_size > 1
    dist_kw = ({"rank": dp.rank, "world_size": dp.world_size}
               if distributed else {})
    if dp is not None and not dp.is_coordinator:
        printer = _silent
    B = task.global_batch_size
    batches_per_epoch = len(dataset) // B
    total_iters = (tcfg.train_iters if tcfg.train_iters is not None
                   else tcfg.epochs * batches_per_epoch)

    iteration = int(task.state.step)
    start_epoch = iteration // max(batches_per_epoch, 1)
    start_offset = iteration % max(batches_per_epoch, 1)

    if log is None:
        log = TrainLog(tcfg.log_interval, printer)
    # "batch": the host's wait for the next batch; "step": the step, on the
    # card's events where the task runs on one
    timer = StageTimer(getattr(task, "device", "cpu"))
    writer = monitoring.MetricsWriter(tensorboard_dir)
    reported_memory = False
    # wall-clock budget: checkpoint and exit cleanly before a scheduler
    # kills the job
    deadline = (time.perf_counter() + timeout_minutes * 60.0
                if timeout_minutes else None)

    def save(it: int, async_save: bool = False) -> None:
        if save_dir is not None:
            ckpt_lib.save_checkpoint(save_dir, task.state, it,
                                     async_save=async_save, dp=dp)

    refresh_count = 0
    epoch = start_epoch
    prefetcher = None
    try:
        # the full config as TensorBoard text, fenced so it renders verbatim
        writer.text("config", "```\n" + pprint.pformat(cfg) + "\n```")
        if refresher is not None:
            refresher.start(task.state.model)
        while iteration < total_iters and batches_per_epoch > 0:
            epoch_batches = dataset.epoch_batches(B, seed=tcfg.seed + epoch,
                                                  **dist_kw)
            if prefetch_depth > 0 and dp is not None \
                    and dp.world.world_size > 1:
                # stage A's collectives (over dp, and the split towers'
                # over tp) on this thread, the rest on a worker
                epoch_batches = prefetcher = DataParallelPrefetcher(
                    task, epoch_batches, depth=prefetch_depth)
            elif prefetch_depth > 0:
                # the worker embeds stage-A queries with a copy of the query
                # tower refreshed after every step: the optimizer updates
                # the live one in place
                task.enable_prefetch_snapshots()
                epoch_batches = prefetcher = BatchPrefetcher(
                    task, epoch_batches, depth=prefetch_depth)
            batches = iter(epoch_batches)
            bi = -1
            while iteration < total_iters:
                with timer.stage("batch"):
                    batch = next(batches, None)
                if batch is None:
                    break
                bi += 1
                if epoch == start_epoch and bi < start_offset:
                    continue                       # resume skip

                if refresher is not None and refresher.maybe_swap(
                        iteration, task.state.model):
                    refresh_count += 1
                    writer.scalars({"index_refresh_count": refresh_count},
                                   iteration)
                    if save_dir is not None:
                        # a checkpoint at every refresh, for fault tolerance
                        save(iteration, tcfg.async_save)
                        if dp is None or dp.is_coordinator:
                            ckpt_lib.remove_stale_checkpoints(save_dir,
                                                              keep_last=2)

                with timer.stage("step"):
                    if prefetch_depth > 0:   # an already built device batch
                        metrics = task.train_step_prebuilt(batch)
                    else:
                        metrics = task.train_step(batch)
                iteration += 1
                log.push(iteration, total_iters, metrics)
                if iteration % tcfg.log_interval == 0:
                    writer.scalars({k: float(v) for k, v in metrics.items()},
                                   iteration)
                    printer(" " + _time_line(timer, tcfg.log_interval))
                    if not reported_memory:
                        monitoring.report_memory(" ", printer)
                        reported_memory = True

                if iteration % tcfg.save_interval == 0:
                    # staged, then written under the next steps
                    save(iteration, tcfg.async_save)
                if (eval_callback is not None
                        and iteration % tcfg.eval_interval == 0):
                    eval_metrics = eval_callback(iteration)
                    if eval_metrics:
                        writer.scalars({k: float(v)
                                        for k, v in eval_metrics.items()},
                                       iteration)
                if deadline is not None and _past(deadline, dp):
                    if refresher is not None:
                        refresher.stop(wait=False)
                        refresher = None
                    save(iteration)
                    printer(f" exiting at iteration {iteration} "
                            f"(time budget)")
                    return iteration
                if tcfg.exit_interval and iteration % tcfg.exit_interval == 0:
                    # clean shutdown: wait for an index build in flight,
                    # final save, stop
                    if refresher is not None:
                        refresher.stop(wait=True)
                        refresher = None
                    save(iteration)
                    printer(f" exiting at iteration {iteration} "
                            f"(exit_interval)")
                    return iteration
            if prefetcher is not None:
                prefetcher.close()
                prefetcher = None
            epoch += 1
        if refresher is not None:
            refresher.stop(wait=True)
            refresher = None
        save(iteration)
        return iteration
    finally:
        # reached with a live refresher only when an exception is on its
        # way out: stop it without waiting for an index build in flight
        if refresher is not None:
            refresher.stop(wait=False)
        if prefetcher is not None:
            prefetcher.close()
        writer.close()
        # a staged interval save becomes durable (or its failure surfaces)
        # before the loop is left
        ckpt_lib.finalize_async_saves()
