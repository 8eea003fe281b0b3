"""The port's spans and counters (``utils/timing.py``): nested spans on the
profiler's clock; a tiny OPENQA step under the benchmark's switched timer
(off: nothing recorded; on: each of the nine stages once a step, with and
without remat); the padding counts of stage B (both paths) and of the
embedder against the device batch's arrays, and the benchmark's readers
of them. All on the CPU; the card's version is ``tests/test_torch_gpu.py``
(``test_stage_spans_wait_for_nothing_until_read``)."""

import collections
import threading

import pytest

torch = pytest.importorskip("torch")

from benchmark import harness  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from emdr2_tpu_torch import native  # noqa: E402
from emdr2_tpu_torch.data.postprocess import postprocess_retrieved  # noqa: E402
from emdr2_tpu_torch.utils.timing import StageTimer, stage  # noqa: E402

STAGES = ("retrieve", "postprocess", "forward_backward", "retriever_forward",
          "reader_forward", "teacher_forward", "loss", "backward",
          "optimizer")
STAGE_C = ("retriever_forward", "reader_forward", "teacher_forward", "loss",
           "backward")
SEED = 2 ** 31 + 12345


def test_nested_spans_record_parents_on_the_profilers_clock():
    """Each span names the span it opened inside, on its own thread's
    stack, and carries the timer's step; its host start lies inside the
    profiler's ``record_function`` range of its name, within 1 ms of the
    range's start, and its end inside the range too."""
    from torch.profiler import ProfilerActivity, profile

    timer = StageTimer("cpu")
    timer.step = 3
    x = torch.randn(64, 64)

    def worker():
        with timer.stage("worker"):
            torch.mm(x, x)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a fresh profiler's first range opens ~1.4 ms before the code
        # inside it runs (torch 2.13, CPU): the ranges timed come after
        with stage(timer, "warm-up"):
            pass
        with timer.stage("outer"):
            y = x @ x
            with timer.stage("inner"):
                y = y @ x
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    spans = {s.name: s for s in timer.spans}
    assert [s.name for s in timer.spans] == ["warm-up", "inner", "worker",
                                             "outer"]
    assert spans["inner"].parent == "outer"
    assert spans["outer"].parent is None and spans["worker"].parent is None
    assert {s.step for s in timer.spans} == {3}
    ranges = {ev.name(): (ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.is_user_annotation()}
    for name in ("outer", "inner"):
        lo, hi = ranges[name]
        s = spans[name]
        assert lo <= s.start_ns <= lo + 1_000_000, (name, s.start_ns - lo)
        assert s.start_ns <= s.end_ns <= hi, name
    # no device events on the CPU: the times are the host's
    assert timer.ms == timer.host_ms
    assert timer.ms["outer"][0] >= timer.ms["inner"][0] > 0
    timer.clear()
    assert timer.spans == [] and dict(timer.ms) == {}
    with stage(None, "retrieve") as got:          # no timer: a no-op
        assert got is None


@pytest.fixture(scope="module")
def cells():
    """Tiny runs' drivers of the benchmark's cells, set up once each, by
    (cell, remat)."""
    made = {}

    def get(cell, remat=None):
        if (cell, remat) not in made:
            if cell == "openqa-b8":
                over = tiny.openqa()
                if remat is not None:
                    for tower in ("retriever", "reader"):
                        over["config"][tower]["remat"] = remat
            else:
                over = tiny.embed()
            manifest = harness.read_json(harness.ROOT / "BENCHMARK.json")
            run = harness.Run(manifest, cell, SEED, 0.0, True, device="cpu",
                              overrides=over)
            traffic = run.traffic["driver"]
            module = harness.load_module(
                harness.HERE / "drivers" / f"{traffic}.py",
                f"timing_test_driver_{traffic}")
            driver = module.Driver(run)
            driver.setup()
            made[cell, remat] = driver
        return made[cell, remat]

    yield get
    for driver in made.values():
        driver.run.close()


@pytest.mark.parametrize("remat", [False, True])
def test_switched_timer_records_the_nine_stages_once_a_step(cells, remat):
    """The benchmark's switch (a subclass that overrides ``stage``) gates
    every span, nested ones included: set-up's steps ran with it off and
    left nothing; on, each step has each stage once, stage C's five under
    ``forward_backward``."""
    driver = cells("openqa-b8", remat)
    timer = driver.timer
    assert timer.spans == []
    timer.on = True
    try:
        for _ in range(2):
            driver.unit()
    finally:
        timer.on = False
    driver.unit()                                 # off again: nothing
    by_step = collections.defaultdict(list)
    for s in timer.spans:
        by_step[s.step].append(s)
    assert len(by_step) == 2
    for spans in by_step.values():
        assert sorted(s.name for s in spans) == sorted(STAGES)
        for s in spans:
            assert s.parent == ("forward_backward" if s.name in STAGE_C
                                else None), s.name
    ms = timer.ms
    assert all(len(ms[name]) == 2 for name in STAGES)


@pytest.mark.parametrize("path", ["native", "python"])
def test_stage_b_counts_the_device_batchs_tokens(cells, monkeypatch, path):
    """``postprocess_retrieved`` adds each kind of row's non-pad positions
    and slots: exactly those of the device batch it built, by either
    path."""
    task = cells("openqa-b8").task
    if path == "python":
        # the fallback: the extension does not import
        monkeypatch.delattr(native, "batch_postprocess")
    tokens = dict(postprocess_retrieved.tokens)
    slots = dict(postprocess_retrieved.slots)
    batch = task.build_device_batch(cells("openqa-b8")._qa_batch())
    pad = task.tok.pad_id
    for key, rows in (("context", batch.context_bert_ids),
                      ("reader", batch.reader_ids),
                      ("teacher", batch.reader_one_ctx_ids)):
        assert (postprocess_retrieved.tokens[key] - tokens.get(key, 0)
                == int((rows != pad).sum()) > 0), key
        assert (postprocess_retrieved.slots[key] - slots.get(key, 0)
                == rows.numel()), key


def test_embedder_counts_its_rows_tokens(cells):
    """``native.batch_context_format`` adds the non-pad positions and the
    slots of the rows the embedder's tower gets."""
    driver = cells("evidence-embed")
    builder = driver.builder
    seen = []
    real = builder.embed_method

    def spy(module, ids, types):
        seen.append(ids)
        return real(module, ids, types)

    builder.embed_method = spy
    tokens = native.batch_context_format.tokens
    slots = native.batch_context_format.slots
    try:
        driver.unit()
    finally:
        builder.embed_method = real
    assert seen
    assert native.batch_context_format.tokens - tokens == sum(
        int((ids != builder.pad_id).sum()) for ids in seen)
    assert native.batch_context_format.slots - slots == sum(
        ids.numel() for ids in seen)


@pytest.mark.parametrize("metric,owner,key", [
    ("context_pad_share.train", postprocess_retrieved, "context"),
    ("reader_pad_share.train", postprocess_retrieved, "reader"),
    ("teacher_pad_share.train", postprocess_retrieved, "teacher"),
    ("pad_share.embed", native.batch_context_format, None),
])
def test_pad_share_readers(cells, monkeypatch, metric, owner, key):
    """The benchmark's readers give the program's pad share in %, and
    nothing where the program keeps no counts."""
    cells("openqa-b8" if key else "evidence-embed")
    reader = harness.load_module(
        harness.HERE / "layer_metrics" / f"{metric}.py",
        "timing_test_" + metric.replace(".", "_"))
    tokens, slots = owner.tokens, owner.slots
    if key is not None:
        tokens, slots = tokens[key], slots[key]
    assert reader.read({}) == pytest.approx(100.0 * (1 - tokens / slots))
    assert 0 < reader.read({}) < 100
    monkeypatch.delattr(owner, "tokens")
    assert reader.read({}) is None

