"""The port's index refresh: ``training.async_refresh`` on the toy world
(the protocol of tests/test_async_refresh.py::TestAsyncRefresher), the
index swap under a search in flight (fault C4: the swap must leave a search
that already read the index with the old one), and five ``engine.train``
iterations with a ``SynchronousRefresher`` against the JAX engine with its
own, from the same converted weights.

Tolerances: the engine run as tests/test_torch_engine.py holds it (atol
1e-5, fp32); index rows are fp16 embeddings of fp32 towers (1e-3).
"""

import copy
import dataclasses
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import MeshConfig  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import (  # noqa: E402
    ShardedEvidenceIndex as JaxIndex,
)
from emdr2_tpu.retrieval.builder import (  # noqa: E402
    EvidenceIndexBuilder as JaxBuilder,
)
from emdr2_tpu.tasks import E2EQATask as JaxTask  # noqa: E402
from emdr2_tpu.training import engine as jax_engine  # noqa: E402
from emdr2_tpu.training.async_refresh import (  # noqa: E402
    SynchronousRefresher as JaxSynchronousRefresher,
)
from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex  # noqa: E402
from emdr2_tpu_torch.retrieval import index as index_lib  # noqa: E402
from emdr2_tpu_torch.retrieval.builder import (  # noqa: E402
    EvidenceIndexBuilder,
    context_tower,
)
from emdr2_tpu_torch.tasks import E2EQATask  # noqa: E402
from emdr2_tpu_torch.training import engine as engine_lib  # noqa: E402
from emdr2_tpu_torch.training.async_refresh import (  # noqa: E402
    AsyncIndexRefresher,
    SynchronousRefresher,
)
from emdr2_tpu_torch.training.step import METRICS  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_e2e_train import _optimizer, _params  # noqa: E402
from tests.test_torch_engine import (  # noqa: E402
    BoomTask,
    StubDataset,
    StubTask,
    _cfg,
    _loop,
    _quiet,
)
from tests.test_torch_models import jax_flash_cfg  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

B = 4
ATOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_toy_world(tmp_path_factory.mktemp("toy"))


def _index_emb(corpus, dim, seed=0):
    return np.random.RandomState(seed).randn(len(corpus), dim).astype(
        np.float32)


def make_task(world, quantize="none"):
    """A port task at lr 5e-3 (the weights move visibly every step), its
    index and a builder over the toy corpus."""
    jcfg, tok, corpus, ds, _ = world
    cfg = _optimizer(port_config(jcfg), 0.0)
    cfg = cfg.replace(index=dataclasses.replace(cfg.index, quantize=quantize))
    index = ShardedEvidenceIndex(
        cfg.index, _index_emb(corpus, cfg.index.embed_dim), device="cpu")
    task = E2EQATask(cfg, tok, corpus, index, total_train_iters=40,
                     device="cpu")
    task.init_state(0)
    builder = EvidenceIndexBuilder(cfg, task.state.model, corpus, tok.cls_id,
                                   tok.sep_id, tok.pad_id, batch_size=16)
    return task, index, builder, ds


def _rows(index):
    return index.embeddings[:index.n_real].float().numpy()


def _wait_for_error(refresher, timeout=60.0):
    deadline = time.time() + timeout
    while refresher.error is None and time.time() < deadline:
        time.sleep(0.02)


class TestAsyncRefresher:
    def test_refresh_happens_and_matches_weights(self, world):
        """Swaps at the interval boundaries only, and each swapped index
        holds the embeddings of the weights handed over one interval
        before."""
        task, index, builder, ds = make_task(world)
        model = task.state.model
        handed = [copy.deepcopy(context_tower(model))]    # start's weights
        r = AsyncIndexRefresher(builder, index, reload_interval=2)
        r.start(model)
        batches = iter(list(ds.epoch_batches(B, seed=0)) * 10)
        swapped, indexes = [], []
        for step in range(1, 13):
            assert r.wait_for_result(timeout=120)
            if r.maybe_swap(step, model):
                swapped.append(step)
                indexes.append(_rows(index))
                handed.append(copy.deepcopy(context_tower(model)))
            task.train_step(next(batches))
            if len(swapped) == 2:
                break
        r.stop()
        r.stop()                                   # idempotent
        assert not r._thread.is_alive() and r.error is None
        assert swapped == [2, 4] and r.refresh_count == 2
        for got, weights in zip(indexes, handed):
            np.testing.assert_allclose(
                got, builder.embed_corpus(weights).astype(np.float32),
                atol=1e-3)
        # stale by one interval: not the weights of the swap's own step
        assert np.abs(indexes[1] - builder.embed_corpus(handed[2]).astype(
            np.float32)).max() > 1e-3

    def test_worker_error_surfaces(self, world):
        task, index, builder, _ = make_task(world)

        def boom(module, progress=None):
            raise ValueError("embedder exploded")

        builder.embed_corpus = boom
        r = AsyncIndexRefresher(builder, index, reload_interval=1)
        r.start(task.state.model)
        _wait_for_error(r)
        with pytest.raises(RuntimeError, match="async embedder failed"):
            r.maybe_swap(5, task.state.model)
        with pytest.raises(RuntimeError, match="async embedder failed"):
            r.wait_for_result(timeout=1)
        r.stop(wait=False)
        r.stop(wait=True)
        assert not r._thread.is_alive()

    def test_sync_refresher_equivalent(self, world):
        task, index, builder, _ = make_task(world)
        r = SynchronousRefresher(builder, index, reload_interval=3)
        assert not r.maybe_swap(2, task.state.model)
        assert r.maybe_swap(3, task.state.model) and r.refresh_count == 1
        want = builder.embed_corpus()
        np.testing.assert_array_equal(_rows(index), want.astype(np.float32))

        # the asynchronous refresher with the same weights swaps in the
        # same rows
        _, index2, builder2, _ = make_task(world)
        a = AsyncIndexRefresher(builder2, index2, reload_interval=3)
        a.start(task.state.model)
        assert a.wait_for_result(timeout=120)
        assert not a.maybe_swap(2, task.state.model)
        assert a.maybe_swap(3, task.state.model)
        a.stop()
        np.testing.assert_array_equal(_rows(index2), _rows(index))

    @pytest.mark.parametrize("quantize", ["none", "int8"])
    def test_zero_copy_refresh_matches_host_path(self, world, quantize):
        """The device-resident rows (n_padded, ``cfg.index.dtype``) swap
        in as the host path's fp16 rows do; an int8 index zeroes their
        padding tail, so the last group's scale is the host path's."""
        task, index, builder, _ = make_task(world, quantize)
        host = builder.embed_corpus()
        index.update(host)
        want_rows, want_scales = index.embeddings.clone(), index.scales
        dev = builder.embed_corpus_device(None, index.n_padded)
        assert tuple(dev.shape) == (index.n_padded, index.cfg.embed_dim)
        index.update(dev)
        if quantize == "int8":
            torch.testing.assert_close(index.scales, want_scales, rtol=1e-3,
                                       atol=0)
            assert (index.embeddings.int() - want_rows.int()).abs().max() <= 1
        else:
            np.testing.assert_allclose(_rows(index), host.astype(np.float32),
                                       atol=1e-3)

        # the asynchronous refresher drives the same path end to end
        _, index2, builder2, _ = make_task(world, quantize)
        r = AsyncIndexRefresher(builder2, index2, reload_interval=1,
                                zero_copy=True)
        r.start(task.state.model)
        assert r.wait_for_result(timeout=120)
        assert r.maybe_swap(1, task.state.model)
        r.stop()
        assert torch.equal(index2.embeddings, index.embeddings)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_update_during_a_search_leaves_the_old_index_to_it(
        world, monkeypatch, quantize):
    """Fault C4's protocol: a search snapshots (rows, scales) once; an
    ``update`` that lands while the search's scan runs changes the result
    of later searches only."""
    jcfg, _, corpus, _, _ = world
    cfg = port_config(jcfg).index
    cfg = dataclasses.replace(cfg, quantize=quantize, chunk_rows=16)
    n, d = 200, cfg.embed_dim
    old = np.random.RandomState(1).randn(n, d).astype(np.float32)
    new = -old[::-1].copy()
    q = torch.tensor(np.random.RandomState(2).randn(5, d), dtype=torch.float32)
    index = ShardedEvidenceIndex(cfg, old, device="cpu")
    want_old = index.search(q, k=4)
    want_new = ShardedEvidenceIndex(cfg, new, device="cpu").search(q, k=4)
    assert not torch.equal(want_old[1], want_new[1])

    entered, release = threading.Event(), threading.Event()
    scan = index_lib.mips_topk

    def held_scan(*args, **kw):
        entered.set()
        assert release.wait(30)
        return scan(*args, **kw)

    monkeypatch.setattr(index_lib, "mips_topk", held_scan)
    out = []
    t = threading.Thread(target=lambda: out.append(index.search(q, k=4)))
    t.start()
    assert entered.wait(30)
    index.update(new)                       # while the search is in flight
    release.set()
    t.join(30)
    assert not t.is_alive()
    for got, want in zip(out[0], want_old):
        assert torch.equal(got, want)
    monkeypatch.setattr(index_lib, "mips_topk", scan)
    for got, want in zip(index.search(q, k=4), want_new):
        assert torch.equal(got, want)


def test_searches_under_repeated_swaps_see_one_index_each(world):
    """Stress: more reader threads than cores search while the main thread
    swaps two embeddings back and forth; every result is one index's, never
    rows of one with the scales of the other (switch interval shortened)."""
    jcfg, _, _, _, _ = world
    cfg = dataclasses.replace(port_config(jcfg).index, quantize="int8",
                              chunk_rows=16)
    n, d = 200, cfg.embed_dim
    a = np.random.RandomState(3).randn(n, d).astype(np.float32)
    b = 10.0 * np.random.RandomState(4).randn(n, d).astype(np.float32)
    q = torch.tensor(np.random.RandomState(5).randn(4, d),
                     dtype=torch.float32)
    want = [ShardedEvidenceIndex(cfg, e, device="cpu").search(q, k=4)
            for e in (a, b)]
    index = ShardedEvidenceIndex(cfg, a, device="cpu")
    results, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            results.append(index.search(q, k=4))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=reader)
               for _ in range(2 * (os.cpu_count() or 2))]
    try:
        for t in threads:
            t.start()
        for i in range(40):
            index.update(b if i % 2 == 0 else a)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and results
    for vals, ids in results:
        assert any(torch.equal(vals, wv) and torch.equal(ids, wi)
                   for wv, wi in want)


@pytest.mark.parametrize("how,want_wait", [
    ("complete", True), ("exit_interval", True), ("timeout", False),
    ("error", False)])
def test_real_refresher_stopped_once_on_every_exit(world, how, want_wait):
    """``engine.train`` stops a live ``AsyncIndexRefresher`` exactly once on
    every exit path (tests/test_torch_engine.py's rule, with the real
    refresher), and its thread ends."""
    task, index, builder, _ = make_task(world)
    stub = BoomTask() if how == "error" else StubTask()
    stub.state.model = task.state.model
    r = AsyncIndexRefresher(builder, index, reload_interval=1)
    stops, stop = [], r.stop

    def counted_stop(wait=True):
        stops.append(wait)
        stop(wait)

    r.stop = counted_stop
    if how == "error":
        with pytest.raises(RuntimeError, match="boom"):
            engine_lib.train(stub, StubDataset(), _cfg(train_iters=3),
                             refresher=r, printer=_quiet)
    else:
        kw = {"complete": {}, "exit_interval": {"exit_interval": 2},
              "timeout": {}}[how]
        engine_lib.train(stub, StubDataset(), _cfg(train_iters=3, **kw),
                         refresher=r,
                         timeout_minutes=1e-9 if how == "timeout" else None,
                         printer=_quiet)
    assert stops == [want_wait]
    r._thread.join(timeout=60)
    assert not r._thread.is_alive() and r.error is None


def test_engine_with_sync_refresher_matches_jax_engine(world):
    """Five iterations at reload interval 2 (swaps at iterations 2 and 4)
    with each package's ``SynchronousRefresher``: every logged interval,
    the final parameters and the final index."""
    jcfg, tok, corpus, ds, _ = world
    jcfg = _loop(_optimizer(jax_flash_cfg(jcfg), 0.0), train_iters=5,
                 index_reload_interval=2)
    emb = _index_emb(corpus, jcfg.index.embed_dim)
    mesh = build_mesh(MeshConfig(dp=1, tp=1))
    jindex = JaxIndex(mesh, jcfg.index, emb)
    jtask = JaxTask(jcfg, mesh, tok, corpus, jindex, total_train_iters=5)
    jtask.init_state(jax.random.PRNGKey(0), B)
    start = _params(jtask)
    jrefresher = JaxSynchronousRefresher(
        JaxBuilder(jcfg, mesh, jtask.model, corpus, tok.cls_id, tok.sep_id,
                   tok.pad_id, batch_size=16), jindex, reload_interval=2)

    cfg = _loop(_optimizer(port_config(jcfg), 0.0), train_iters=5,
                index_reload_interval=2)
    index = ShardedEvidenceIndex(cfg.index, emb, device="cpu")
    task = E2EQATask(cfg, tok, corpus, index, total_train_iters=5,
                     device="cpu")
    task.init_state(0, state_dict=start)
    refresher = SynchronousRefresher(
        EvidenceIndexBuilder(cfg, task.state.model, corpus, tok.cls_id,
                             tok.sep_id, tok.pad_id, batch_size=16),
        index, reload_interval=2)

    want_lines = []
    want_it = jax_engine.train(jtask, ds, jcfg, refresher=jrefresher,
                               printer=want_lines.append)
    log = engine_lib.TrainLog(cfg.train.log_interval, _quiet)
    got_it = engine_lib.train(task, ds, cfg, refresher=refresher,
                              printer=_quiet, log=log)
    assert got_it == want_it == 5
    assert refresher.refresh_count == jrefresher.refresh_count == 2

    want_rows = [line for line in want_lines
                 if "iteration" in line and "|" in line and "/" in line]
    assert [r["iteration"] for r in log.history] == [2, 4]
    assert len(want_rows) == 2
    for h, line in zip(log.history, want_rows):
        parts = dict(p.split() for p in
                     (x.strip() for x in line.split("|")[1:]))
        for key in METRICS:
            # the printed values carry five significant digits
            np.testing.assert_allclose(h[key], float(parts[key]), rtol=2e-4,
                                       atol=ATOL, err_msg=f"{key} at "
                                       f"{h['iteration']}")
    ref = _params(jtask)
    sd = task.state.model.state_dict()
    for key, p in ref.items():
        np.testing.assert_allclose(sd[key].numpy(), p.numpy(), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(
        _rows(index), np.asarray(jindex.embeddings)[:len(corpus)], atol=1e-3)
