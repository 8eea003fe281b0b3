"""Spans and counters of the port: per-stage times for the serving, training
and evaluation paths, and counts kept on the functions that did the work.

Spans (``StageTimer``). A stage is a ``with timer.stage(name)`` block, or
``with stage(timer, name)``, which is a no-op without a timer. No
boundary waits for the device: ``ms`` waits once, when it is read. Each
span is also a ``torch.profiler.record_function`` range of the same name,
and ``torch.profiler`` stamps its events on ``time.time_ns()``, the spans'
host clock, so a profiler trace shows the spans over the device's
operations on one clock.

Counters (``count``): ``fn.launches`` of each kernel wrapper (and, on
``ops.fid_attention``'s K1 wrappers, the relative-position bias's
``.rel_launches``, ``.rel_flops`` and ``.rel_bytes``), and the
token positions against the slots of the rows a formatter built
(``data/postprocess.py:postprocess_retrieved``' ``tokens`` and ``slots``
by kind of row, ``native.batch_context_format``'s), added under one lock,
so that no count is lost between threads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

_count_lock = threading.Lock()   # the prefetch worker counts beside the step


def count(fn, counter: str, key=None, n: int = 1) -> None:
    """Add ``n`` to ``fn.<counter>`` (with ``key``, to that entry of the
    dict ``fn.<counter>``), under the lock."""
    with _count_lock:
        if key is None:
            setattr(fn, counter, getattr(fn, counter) + n)
        else:
            counts = getattr(fn, counter)
            counts[key] = counts.get(key, 0) + n


@dataclasses.dataclass
class Span:
    """One stage as it ran: ``parent`` is the name of the span it opened
    inside (None at the top), ``step`` the timer's step when it opened,
    ``start_ns`` / ``end_ns`` the host clock (``time.time_ns()``).
    ``events`` holds its CUDA events until the timer resolves them into
    ``device_ms``."""

    name: str
    parent: Optional[str]
    step: int
    start_ns: int
    end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def ms(self) -> float:
        """The device's time where the span had events, else the host's."""
        return self.host_ms if self.device_ms is None else self.device_ms


class StageTimer:
    """Spans by stage name. A span records its name, the span it opened
    inside (a stack per thread), the timer's ``step`` (set by the owner of
    the loop, ``E2EQATask.train_step``), its host start and end on
    ``time.time_ns()`` and, on a CUDA ``device``, two timing events on the
    calling thread's current stream, taken from a pool. Its time (``ms``)
    is the device's between those events there: the work queued on that
    stream inside the span, and the stream's idle time between them;
    elsewhere it is the host's (``host_ms``, always the host's).

    The stages of a training step, each on the card's events where the
    task runs on one, else on the host clock:

      retrieve            stage A: query tower, MIPS top-k, rows to the
                          host (``E2EQATask.build_device_batch``)
      postprocess         stage B: the C++ row formatting and the copies
      forward_backward    stage C (``training/step.py``):
        retriever_forward   query and context towers, scores, log-softmax
        reader_forward      the FiD encoder and decoder
        teacher_forward     the one-passage teacher's gold log-probs
                            (the three in ``EMDR2Model.forward``)
        loss                the joint loss
        backward            the backward pass
      optimizer           the mean over data parallelism, clip, AdamW
        grad_all_reduce     the mean over data parallelism alone (more
                            than one rank; ``Optimizer.step``)

    The training engine keeps one of its own for its log line: ``batch``,
    the wait for the next batch (read on the host clock), and ``step``.
    The prefetch worker (training/prefetch.py) times its stages on its own
    stream, beside the train step, so their times include whatever share
    of the card that step took from them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.step = 0
        self.spans: List[Span] = []
        self._cuda = self.device.type == "cuda"
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pending: List[Span] = []
        self._pool: List[torch.cuda.Event] = []

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self) -> torch.cuda.Event:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    @contextlib.contextmanager
    def stage(self, name: str):
        stack = self._stack()
        span = Span(name, stack[-1].name if stack else None, self.step, 0)
        stream = None
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            span.events = (self._event(), self._event())
            span.events[0].record(stream)
        # the events enclose the profiler's range and its host cost, so
        # that sibling spans leave next to no gap between them on the card
        try:
            with torch.profiler.record_function(name):
                span.start_ns = time.time_ns()
                stack.append(span)
                try:
                    yield
                finally:
                    stack.pop()
                    span.end_ns = time.time_ns()
        finally:
            if stream is not None:
                span.events[1].record(stream)
            with self._lock:
                self.spans.append(span)
                if stream is not None:
                    self._pending.append(span)

    def _resolve(self) -> None:
        """The device times of the spans whose events are pending: waits
        for their end events, then returns the events to the pool."""
        with self._lock:
            pending, self._pending = self._pending, []
        freed = []
        for span in pending:
            start, end = span.events
            end.synchronize()
            span.device_ms = start.elapsed_time(end)
            span.events = None
            freed += (start, end)
        with self._lock:
            self._pool.extend(freed)

    def _by_name(self, value) -> Dict[str, List[float]]:
        with self._lock:
            spans = list(self.spans)
        out: Dict[str, List[float]] = defaultdict(list)
        for span in spans:
            out[span.name].append(value(span))
        return out

    @property
    def ms(self) -> Dict[str, List[float]]:
        """Milliseconds by stage name, in the order the spans closed: the
        device's where they had events (read here, after one wait for the
        device), else the host's."""
        self._resolve()
        return self._by_name(lambda s: s.ms)

    @property
    def host_ms(self) -> Dict[str, List[float]]:
        """Host milliseconds by stage name, with no wait."""
        return self._by_name(lambda s: s.host_ms)

    def clear(self) -> None:
        """Forget every closed span (their events go back to the pool)."""
        self._resolve()
        with self._lock:
            self.spans = []


def stage(timer: Optional[StageTimer], name: str):
    """``timer.stage(name)``, or a no-op context without a timer."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()
