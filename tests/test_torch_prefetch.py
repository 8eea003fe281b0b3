"""The port's batch prefetcher and the query-tower snapshot behind it
(``training/prefetch.py``, ``E2EQATask.enable_prefetch_snapshots``).

Selection under prefetch is allowed to be ``depth`` steps stale, so a
prefetched run equals a plain one only when the retriever is frozen
(``update_retriever=False``): then both must agree bit for bit.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex  # noqa: E402
from emdr2_tpu_torch.tasks import E2EQATask  # noqa: E402
from emdr2_tpu_torch.training import engine as engine_lib  # noqa: E402
from emdr2_tpu_torch.training.prefetch import BatchPrefetcher  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

B = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_toy_world(tmp_path_factory.mktemp("toy"))


def _task(world, update_retriever=True, **train_kw):
    jcfg, tok, corpus, ds, _ = world
    cfg = port_config(jcfg).replace(update_retriever=update_retriever)
    opt = dataclasses.replace(cfg.train.optimizer, lr=5e-3, warmup=0.0)
    train = dict(optimizer=opt, batch_size=B, log_interval=1,
                 save_interval=10 ** 6, eval_interval=10 ** 6)
    train.update(train_kw)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train))
    emb = np.random.RandomState(0).randn(
        len(corpus), cfg.index.embed_dim).astype(np.float32)
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, emb, device="cpu"),
                     total_train_iters=8, device="cpu")
    task.init_state(0)
    return task, cfg, ds


def _threads():
    return {t.name for t in threading.enumerate()}


def test_worker_error_is_reraised_on_the_consumer():
    class Task:
        device = torch.device("cpu")

        def build_device_batch(self, batch):
            if batch == 2:
                raise ValueError("bad batch")
            return batch * 10

    pre = BatchPrefetcher(Task(), iter(range(5)), depth=2)
    assert next(pre) == 0 and next(pre) == 10
    with pytest.raises(RuntimeError, match="prefetch worker failed") as e:
        next(pre)
    assert isinstance(e.value.__cause__, ValueError)
    with pytest.raises(RuntimeError):                # and again, not a hang
        next(pre)
    pre.close()
    assert "batch-prefetch" not in _threads()


def test_prefetcher_yields_every_batch_in_order_and_closes_early():
    class Task:
        device = torch.device("cpu")

        def build_device_batch(self, batch):
            return batch + 100

    assert list(BatchPrefetcher(Task(), iter(range(7)), depth=1)) == [
        100 + i for i in range(7)]

    def forever():
        i = 0
        while True:
            yield i
            i += 1

    pre = BatchPrefetcher(Task(), forever(), depth=2)
    assert next(pre) == 100
    pre.close()                         # a worker blocked on a full queue
    assert "batch-prefetch" not in _threads()


def test_frozen_retriever_prefetched_run_equals_plain_run(world):
    """With the query tower frozen, stale selection is the same selection:
    history and parameters agree bit for bit, and no thread is left."""
    runs = []
    for depth in (0, 2):
        task, cfg, ds = _task(world, update_retriever=False, train_iters=5)
        log = engine_lib.TrainLog(cfg.train.log_interval, lambda s: None)
        assert engine_lib.train(task, ds, cfg, prefetch_depth=depth,
                                printer=lambda s: None, log=log) == 5
        assert "batch-prefetch" not in _threads()
        runs.append((log.history, task.state.model.state_dict()))
    (h0, p0), (h1, p1) = runs
    assert len(h0) == len(h1) == 5
    for a, b in zip(h0, h1):
        assert all(a[k] == b[k] for k in a if k != "ms_per_iter"), (a, b)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_snapshot_is_refreshed_after_every_step(world):
    task, cfg, ds = _task(world)
    live = task.state.model.retriever.query_model

    def same():
        return all(torch.equal(a, b) for a, b in zip(
            task._retrieval_snapshot.parameters(), live.parameters()))

    with pytest.raises(RuntimeError):
        E2EQATask(cfg, task.tok, task.corpus, task.index,
                  device="cpu").enable_prefetch_snapshots()
    task.enable_prefetch_snapshots()
    snap = task._retrieval_snapshot
    assert snap is not live and same()
    assert not any(p.requires_grad for p in snap.parameters())
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        snap.parameters(), live.parameters()))
    batches = list(ds.epoch_batches(B, seed=0))[:2]
    before = [p.clone() for p in snap.parameters()]
    for batch in batches:
        built = task.build_device_batch(batch)
        task.train_step_prebuilt(built)
        assert task._retrieval_snapshot is snap and same()
    assert not all(torch.equal(a, b) for a, b in zip(
        before, snap.parameters()))
    # retrieval reads the snapshot, not the live tower
    ids = batches[0].query_bert_ids
    want = task.retrieve(ids)
    with torch.no_grad():
        for p in live.parameters():
            p.add_(0.5)
    got = task.retrieve(ids)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    task.refresh_retrieval_snapshot()
    assert not np.array_equal(task.retrieve(ids)[1], want[1])
    task.init_state(1)                               # a new model: no copy
    assert task._retrieval_snapshot is None


def test_live_retriever_prefetched_run_trains(world):
    """Prefetch with the retriever learning: stale selection is allowed, so
    only sanity is held: five finite steps, parameters moved, clean exit."""
    task, cfg, ds = _task(world, train_iters=5)
    before = {k: v.clone() for k, v in task.state.model.state_dict().items()}
    lines = []
    assert engine_lib.train(task, ds, cfg, prefetch_depth=2,
                            printer=lines.append) == 5
    after = task.state.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert sum("iteration" in s and "loss" in s for s in lines) == 5
    assert all("nan" not in s for s in lines)
    assert "batch-prefetch" not in _threads()


def test_launch_counts_lose_nothing_between_threads():
    """The prefetch worker and the step count launches of the same kernels:
    32 threads x 2,000 increments under a shortened switch interval."""
    import sys

    from emdr2_tpu_torch.utils.timing import count

    def wrapper():
        pass

    wrapper.launches = 0

    def work():
        for _ in range(2000):
            count(wrapper, "launches")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 32 * 2000
