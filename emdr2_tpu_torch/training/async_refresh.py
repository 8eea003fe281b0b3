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

Data parallelism (the index's group ``index.dp``): ``SynchronousRefresher``
has each rank embed its own block of index rows
(``embed_corpus(row_partition=)``, all of them on one rank) and swap it in
locally (``update_from_process_local``): no rows cross between ranks. The
asynchronous refresher refuses more than one rank: its embedder would
share the trainers' devices and issue collectives beside theirs, which
the JAX package refuses too; it needs an embedder group of its own
(``--embed-devices``, not ported yet, ROADMAP A3).

Per process, one card. The embedder is a thread on a CUDA stream of its
own (the pattern of ``training/prefetch.py``), so its kernels run beside
the train step's. Weights: the optimizer updates the live tower in place,
so ``_publish_weights`` copies it (device to device, on the trainer's
stream) into a snapshot module and records an event; the worker's stream
waits for that event before its first read, and the next copy comes only
after the worker has finished reading (its result is complete when it is
posted). Swap: by default the rows come back to host RAM in fp16 and are
uploaded at the swap (``embed_corpus``); ``zero_copy=True`` keeps them on
the device (``embed_corpus_device``) and hands ``ShardedEvidenceIndex
.update`` the tensor with the event after its last write. ``stop`` cancels
a pass in flight between two batches: its result would be dropped anyway.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Any, Callable, Optional

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
                 zero_copy: bool = False):
        """``extract_retriever`` maps the live model to the module the
        builder embeds with (its context tower); that module is what the
        snapshot copies. ``zero_copy``: keep the fresh rows on the device
        (about ``n_padded x d`` in ``cfg.index.dtype`` beside the live
        index for the whole pass) instead of host RAM. An index held by
        more than one rank is refused (module docstring)."""
        world = index.dp.world_size
        if world > 1:
            raise NotImplementedError(
                f"the asynchronous index refresher with {world} "
                f"data-parallel ranks: its embedder would share the "
                f"trainers' devices and race their collectives; it needs "
                f"a disjoint embedder group (--embed-devices, not ported "
                f"yet, ROADMAP A3). Use the synchronous refresher")
        self.builder = builder
        self.index = index
        self.reload_interval = reload_interval
        self.extract = extract_retriever
        self.on_refresh = on_refresh
        self.zero_copy = zero_copy
        self._cuda = builder.device.type == "cuda"

        self._snapshot: Optional[torch.nn.Module] = None
        self._published: Optional[torch.cuda.Event] = None
        self._weights_ready = threading.Event()
        self._result = None                  # (rows, ready event or None)
        self._result_lock = threading.Lock()
        self._stop = threading.Event()
        self._last_reload_step = 0
        self.refresh_count = 0
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
        if self._snapshot is None:
            # a Parameter's deepcopy leaves its .grad behind
            self._snapshot = copy.deepcopy(live).requires_grad_(False).eval()
        else:
            torch._foreach_copy_(list(self._snapshot.parameters()),
                                 list(live.parameters()))
        if self._cuda:
            self._published = torch.cuda.Event()
            self._published.record(
                torch.cuda.current_stream(self.builder.device))
        self._weights_ready.set()

    def maybe_swap(self, step: int, model) -> bool:
        """Call every train step. At an interval boundary, if the embedder
        has finished, swap the index and hand over fresh weights; never
        waits for the embedder."""
        if self.error is not None:
            raise RuntimeError("async embedder failed") from self.error
        if step - self._last_reload_step < self.reload_interval:
            return False
        with self._result_lock:
            result, self._result = self._result, None
        if result is None:
            return False
        rows, ready = result
        self.index.update(rows, ready=ready)
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

    def _embed_pass(self, stream) -> None:
        if stream is not None:
            stream.wait_event(self._published)
        if self.zero_copy:
            rows = self.builder.embed_corpus_device(
                self._snapshot, self.index.n_padded,
                progress=self._check_stop)
            ready = None
            if stream is not None:
                ready = torch.cuda.Event()
                ready.record(stream)
                # the result is posted complete: maybe_swap never waits,
                # and the next weights may overwrite the snapshot
                ready.synchronize()
        else:
            rows = self.builder.embed_corpus(self._snapshot,
                                             progress=self._check_stop)
            ready = None
        with self._result_lock:
            self._result = (rows, ready)

    def _worker(self) -> None:
        stream = (torch.cuda.Stream(self.builder.device) if self._cuda
                  else None)
        try:
            with torch.inference_mode(), (
                    torch.cuda.stream(stream) if stream is not None
                    else contextlib.nullcontext()):
                while not self._stop.is_set():
                    self._weights_ready.wait()
                    if self._stop.is_set():
                        return
                    self._weights_ready.clear()
                    self._embed_pass(stream)
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
