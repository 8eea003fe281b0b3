"""Evidence-index refresh during training (port of
``emdr2_tpu/training/async_refresh.py``).

EMDR2 re-embeds the evidence with the latest context tower while it trains
and swaps the fresh index in. The protocol and its order are the JAX
package's:

    trainer                          embedder thread
    -------                          ---------------
    start(model): publish weights -> wait for weights
    ... train steps ...              embed the corpus with those weights
    maybe_swap(): result ready?  <-- publish the result, wait for weights
      at an interval boundary:
        index.update(result)
        publish fresh weights

so the index and the embedder's weights are always one refresh interval
stale (the paper's stale-index approximation), and ``maybe_swap`` never
blocks the trainer.

Where the embedder runs: on the builder's devices. With an embedder group
(``--embed-devices``, ``parallel.mesh.embed_devices``) those are cards of
their own on the rank's own host (the worker is a thread of the trainer's
process), the reference's indexer ranks; without one, the trainer's card.
``_publish_weights`` copies the live tower onto them
(``EvidenceIndexBuilder.place_params``, card to card on the trainer's
stream) and records an event there; the embedder's streams wait for it
before their first read, and the next copy comes only after the worker has
finished reading (its result is complete when it is posted). The result:
by default fp16 rows in host RAM, uploaded at the swap (``embed_corpus``);
with ``zero_copy`` (the default on a disjoint embedder, as in the JAX
CLI) the block stays on the embedder's card, cast or quantized there
(``ShardedEvidenceIndex.local_block``: int8 rows and scales, half the bytes
of bf16), and the swap copies it card to card after the event of its last
write (``update_from_process_local``).

Data and tensor parallelism (the index's ranks, ``index.blocks``: every
rank of the grid): each rank's embedder embeds that rank's block of index
rows only (``process_row_range()``) and issues no collective, so it may run
beside the trainers' collectives. Under tensor parallelism the embedder
needs the whole context tower: ``_publish_weights`` gathers it over tp on
the trainer's thread at each hand-off (``builder.place_params``, one
all-gather per split parameter), so every collective stays on that
thread, and the embedder runs it as one process would (the JAX embedder
sub-mesh is ``(embed_devices, 1)``: tp = 1). The swap is decided together:
at an interval boundary every rank all-reduces
"my block is ready" (and "my embedder failed") on the trainer thread, in
program order with the step's collectives, and all ranks swap and publish
fresh weights at the same step, or none does. Otherwise one rank would
search a newer index than another and ``sharded_mips_topk`` would merge
rows of two versions. The JAX package gets the common step from its single
controller; the reference from its ``NEW_INDEX_READY`` broadcast.

``SynchronousRefresher`` has each rank embed its own block inline with the
live weights and swap it in (no overlap): the baseline the asynchronous
refresher is held to. ``stop`` cancels a pass in flight between two
batches: its result would be dropped anyway.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, List, Optional

import torch

from emdr2_tpu_torch.retrieval.builder import (EvidenceIndexBuilder,
                                               context_tower)
from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex


class _Cancelled(Exception):
    """Raised inside the worker's embed pass once ``stop`` was called."""


class AsyncIndexRefresher:
    def __init__(self, builder: EvidenceIndexBuilder,
                 index: ShardedEvidenceIndex, reload_interval: int,
                 extract_retriever: Callable[[Any], Any] = context_tower,
                 on_refresh: Optional[Callable[[int], None]] = None,
                 zero_copy: Optional[bool] = None):
        """``extract_retriever`` maps the live model to the module the
        builder embeds with (its context tower); that module is what the
        snapshot copies. ``zero_copy``: keep the fresh block on the
        embedder's device (about ``shard_rows x d`` in the index's form
        beside what that device holds, for the whole pass) instead of host
        RAM; default: when the builder's device is not the index's."""
        self.builder = builder
        self.index = index
        self.reload_interval = reload_interval
        self.extract = extract_retriever
        self.on_refresh = on_refresh
        self.zero_copy = (builder.device != index.device if zero_copy is None
                          else zero_copy)
        self._cuda = builder.device.type == "cuda"

        self._snapshot: Optional[List[torch.nn.Module]] = None
        self._published: Optional[torch.cuda.Event] = None
        self._weights_ready = threading.Event()
        self._result = None                  # (block or rows, ready event)
        self._result_lock = threading.Lock()
        self._stop = threading.Event()
        self._last_reload_step = 0
        self.refresh_count = 0
        # the trainer thread's intra-op thread count, which the worker
        # takes before its first product (``_worker``)
        self._num_threads = torch.get_num_threads()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="index-refresh")
        self._started = False
        self.error: Optional[BaseException] = None

    # ------------------------------------------------------------- trainer

    def start(self, model) -> None:
        """Publish the initial weights and start the embedder."""
        if self._cuda:
            # build the kernel library here: the worker and the step would
            # otherwise race to compile and load it
            from emdr2_tpu_torch.ops import build
            build.load()
        self._publish_weights(model)
        self._thread.start()
        self._started = True

    @torch.no_grad()
    def _publish_weights(self, model) -> None:
        live = self.extract(model)
        self._snapshot = self.builder.place_params(live, self._snapshot)
        if self._cuda:
            # after the copies, on the stream that updates the live tower
            self._published = torch.cuda.Event()
            self._published.record(torch.cuda.current_stream(
                next(live.parameters()).device))
        self._weights_ready.set()

    def _agree(self, ready: bool) -> bool:
        """Whether every rank's block is ready (one all-reduce on the
        trainer thread under data parallelism); raises on every rank if
        any rank's embedder failed."""
        ranks = self.index.blocks
        failed = self.error is not None
        if ranks.world_size > 1:
            flags = ranks.all_reduce_sum_(torch.tensor(
                [float(not ready), float(failed)]))
            ready, any_failed = bool(flags[0] == 0), bool(flags[1] > 0)
        else:
            any_failed = failed
        if any_failed:
            raise RuntimeError("async embedder failed" + (
                "" if failed else " on another rank")) from self.error
        return ready

    def maybe_swap(self, step: int, model) -> bool:
        """Call every train step, on every rank at the same steps. At an
        interval boundary, if every rank's embedder has finished, swap the
        index and hand over fresh weights; never waits for an embedder."""
        if self.error is not None and self.index.blocks.world_size == 1:
            raise RuntimeError("async embedder failed") from self.error
        if step - self._last_reload_step < self.reload_interval:
            return False
        with self._result_lock:
            ready = self._result is not None
        if not self._agree(ready):
            return False
        with self._result_lock:
            result, self._result = self._result, None
        block, ready_event = result
        self.index.update_from_process_local(block, ready=ready_event)
        self._last_reload_step = step
        self.refresh_count += 1
        self._publish_weights(model)
        if self.on_refresh is not None:
            self.on_refresh(step)
        return True

    def stop(self, wait: bool = True) -> None:
        """Stop the embedder (idempotent); ``wait`` joins its thread, which
        leaves a pass in flight at its next batch."""
        self._stop.set()
        self._weights_ready.set()  # unblock the worker
        if wait and self._started:
            self._thread.join(timeout=600)

    def wait_for_result(self, timeout: Optional[float] = None) -> bool:
        """Block until an embedding pass finishes (tests, clean exits)."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._result_lock:
                if self._result is not None:
                    return True
            if self.error is not None:
                raise RuntimeError("async embedder failed") from self.error
            if deadline is not None and time.time() > deadline:
                return False
            time.sleep(0.02)

    # ------------------------------------------------------------- worker

    def _check_stop(self, done: int, total: int) -> None:
        if self._stop.is_set():
            raise _Cancelled()

    def _embed_pass(self, streams) -> None:
        for stream in streams:
            stream.wait_event(self._published)
        part = self.index.process_row_range()
        ready = None
        if self.zero_copy:
            rows = self.builder.embed_corpus_device(
                self._snapshot, progress=self._check_stop,
                row_partition=part)
            # cast or quantized where the rows are: the embedder's card
            block = self.index.local_block(rows)
            if streams:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.builder.device))
                # the result is posted complete: maybe_swap never waits,
                # and the next weights may overwrite the snapshot
                ready.synchronize()
        else:
            block = self.builder.embed_corpus(
                self._snapshot, progress=self._check_stop,
                row_partition=part)
        with self._result_lock:
            self._result = (block, ready)

    def _worker(self) -> None:
        # A new thread's first CPU products run with MKL's machine-wide
        # thread count: PyTorch sets a thread's own OpenMP and MKL counts
        # only at its first parallel op, and a GEMM is not one. The
        # trainer's count, set here before any work, makes the worker's
        # products those of the trainer thread.
        torch.set_num_threads(self._num_threads)
        # a stream of its own on each embedder device, so its kernels run
        # beside the train step's
        streams = ([torch.cuda.Stream(d) for d in self.builder.devices]
                   if self._cuda else [])
        try:
            with torch.inference_mode(), contextlib.ExitStack() as ctx:
                for stream in streams:
                    ctx.enter_context(torch.cuda.stream(stream))
                while not self._stop.is_set():
                    self._weights_ready.wait()
                    if self._stop.is_set():
                        return
                    self._weights_ready.clear()
                    self._embed_pass(streams)
        except _Cancelled:
            return
        except Exception as e:  # surfaced on the trainer's thread
            self.error = e


class SynchronousRefresher:
    """Re-embeds inline at each boundary with the live weights (no
    overlap): the baseline the asynchronous refresher is held to. Each
    rank of the index's group embeds and swaps its own rows."""

    def __init__(self, builder: EvidenceIndexBuilder,
                 index: ShardedEvidenceIndex, reload_interval: int,
                 extract_retriever: Callable[[Any], Any] = context_tower):
        self.builder = builder
        self.index = index
        self.reload_interval = reload_interval
        self.extract = extract_retriever
        self._last_reload_step = 0
        self.refresh_count = 0

    def start(self, model) -> None:
        pass

    def maybe_swap(self, step: int, model) -> bool:
        if step - self._last_reload_step < self.reload_interval:
            return False
        self.index.update_from_process_local(self.builder.embed_corpus(
            self.extract(model),
            row_partition=self.index.process_row_range()))
        self._last_reload_step = step
        self.refresh_count += 1
        return True

    def stop(self, wait: bool = True) -> None:
        pass
