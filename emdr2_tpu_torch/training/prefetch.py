"""Input prefetching for the training loop (port of
``emdr2_tpu/training/prefetch.py:BatchPrefetcher``).

The work before a step — stage A (query embed + MIPS search), the host
postprocess (``data/postprocess.py``) and the batch's copy to the device —
runs between steps in the plain loop. ``BatchPrefetcher`` builds the next
``depth`` device batches on a worker thread while the current step runs.

On a CUDA device the worker runs under a stream of its own (threads share
PyTorch's default stream otherwise, and nothing would overlap). Each batch
is handed over with an event recorded after its last copy: the consumer's
stream waits for the event and is recorded on the batch's tensors, so their
memory is not reused before the step has read them. The task must embed
with its query-tower snapshot (``E2EQATask.enable_prefetch_snapshots``):
the optimizer updates the live tower in place.

The prefetched batch's top-K *selection* uses query-tower weights up to
``depth`` steps stale; the scores in the step are always recomputed from
the live parameters. The index itself is ``index_reload_interval`` steps
stale by design, so this is the smaller approximation; it is still opt-in
(``engine.train(prefetch_depth=N)``).

Under data parallelism a worker thread may issue no collective: every
rank must issue its collectives from one thread in one order, and the
search's (``ops.mips.sharded_mips_topk``: the queries' all-gather and the
merge) would race the step's. ``DataParallelPrefetcher`` keeps the rule of
the JAX package's ``MainDispatchPrefetcher`` with a design of its own:
``__next__``, called by the loop on the main thread right after the
previous step was queued, queues stage A of the batches up to ``depth + 1``
ahead (``E2EQATask.search_async``: the live query tower, read in stream
order after that step's update, so no snapshot is needed), and hands each
pending search to a worker that only waits for its copy to the host, runs
the postprocess and copies the batch to the device on a stream of its own.
A batch's selection is then up to ``depth + 1`` steps stale, one more than
``BatchPrefetcher``'s, as in JAX; the device part of stage A runs in the
step's stream, the host part beside it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import torch


class BatchPrefetcher:
    _DONE = object()

    def __init__(self, task, batches: Iterator, depth: int = 2):
        self.task = task
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.error: Optional[Exception] = None
        device = getattr(task, "device", None)
        self._cuda = device is not None and device.type == "cuda"
        if self._cuda:
            # build the kernel library here: the worker and the step would
            # otherwise race to compile and load it
            from emdr2_tpu_torch.ops import build
            build.load()
        self._thread = threading.Thread(
            target=self._worker, args=(batches,), daemon=True,
            name="batch-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer has closed the prefetcher."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _build_all(self, batches) -> None:
        for batch in batches:
            if self._stop.is_set():
                return
            built = self.task.build_device_batch(batch)
            ready = None
            if self._cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.task.device))
            if not self._put((built, ready)):
                return

    def _worker(self, batches) -> None:
        try:
            if self._cuda:
                with torch.cuda.stream(torch.cuda.Stream(self.task.device)):
                    self._build_all(batches)
            else:
                self._build_all(batches)
        except Exception as e:    # re-raised on the consumer's thread
            self.error = e
        self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._q.put(self._DONE)         # keep ending on repeated next()
            if self.error is not None:
                raise RuntimeError("prefetch worker failed") from self.error
            raise StopIteration
        built, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.task.device)
            stream.wait_event(ready)
            for t in built:
                if isinstance(t, torch.Tensor):
                    t.record_stream(stream)
        return built

    def close(self) -> None:
        """Stop the worker (after the batch it is building) and wait for
        it; batches already built are dropped."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()


class DataParallelPrefetcher:
    """The prefetcher of a data-parallel rank (module docstring): the
    device part of stage A on the caller's thread, the rest on a worker.
    Every rank must consume the same number of batches (the loop's lockstep
    gives it), so every rank queues the same searches."""

    _DONE = object()

    def __init__(self, task, batches: Iterator, depth: int = 1):
        self.task = task
        self.depth = depth
        self._batches = iter(batches)
        self._exhausted = False
        self._in_flight = 0
        self._work: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.error: Optional[Exception] = None
        device = getattr(task, "device", None)
        self._cuda = device is not None and device.type == "cuda"
        if self._cuda:
            from emdr2_tpu_torch.ops import build
            build.load()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="batch-prefetch")
        self._thread.start()

    def _queue_searches(self) -> None:
        """Queue stage A of the batches up to ``depth + 1`` ahead."""
        while self._in_flight < self.depth + 1 and not self._exhausted:
            batch = next(self._batches, None)
            if batch is None:
                self._exhausted = True
                self._work.put(self._DONE)
                return
            self._work.put((batch, self.task.search_async(
                batch.query_bert_ids)))
            self._in_flight += 1

    def _build_all(self) -> None:
        while not self._stop.is_set():
            item = self._work.get()
            if item is self._DONE:
                return
            batch, pending = item
            built = self.task.build_device_batch(
                batch, retrieved=pending.result())
            ready = None
            if self._cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.task.device))
            self._out.put((built, ready))

    def _worker(self) -> None:
        try:
            if self._cuda:
                with torch.cuda.stream(torch.cuda.Stream(self.task.device)):
                    self._build_all()
            else:
                self._build_all()
        except Exception as e:    # re-raised on the consumer's thread
            self.error = e
        self._out.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        self._queue_searches()
        item = self._out.get()
        if item is self._DONE:
            self._out.put(self._DONE)       # keep ending on repeated next()
            if self.error is not None:
                raise RuntimeError("prefetch worker failed") from self.error
            raise StopIteration
        self._in_flight -= 1
        built, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.task.device)
            stream.wait_event(ready)
            for t in built:
                if isinstance(t, torch.Tensor):
                    t.record_stream(stream)
        return built

    def close(self) -> None:
        """Stop the worker (after the batch it is building) and wait for
        it; searches queued and batches built are dropped."""
        self._stop.set()
        self._work.put(self._DONE)
        self._thread.join()
