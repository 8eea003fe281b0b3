"""The port's checkpoints (``emdr2_tpu_torch/training/checkpointing.py``):
round trip, the tracker's durability order, async saves and their failures,
``load_optim=False``, the partial loaders, pruning, a resumed run against an
uninterrupted one (bit for bit, dropout on), and Adam state carried over
from a JAX run (``convert.load_adam_from_jax``).
"""

import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu_torch.config import with_transformers  # noqa: E402
from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex  # noqa: E402
from emdr2_tpu_torch.tasks import E2EQATask  # noqa: E402
from emdr2_tpu_torch.training import checkpointing as ckpt  # noqa: E402
from emdr2_tpu_torch.training import engine as engine_lib  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

B = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_toy_world(tmp_path_factory.mktemp("toy"))


def _task(world, dropout=0.0, seed=0, **train_kw):
    jcfg, tok, corpus, ds, _ = world
    kw = dict(hidden_dropout=dropout, attention_dropout=dropout)
    cfg = with_transformers(port_config(jcfg), kw, kw)
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
    task.init_state(seed)
    return task, cfg, ds


def _moments(task):
    st = task.state.optimizer.adamw.state
    return {n: (st[p]["exp_avg"], st[p]["exp_avg_sq"], st[p]["step"])
            for n, p in task.state.model.named_parameters() if p in st}


def _assert_same_state(a, b):
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    ma, mb = _moments(a), _moments(b)
    assert ma.keys() == mb.keys() and len(ma) == len(sa)
    for k in ma:
        assert all(torch.equal(x, y) for x, y in zip(ma[k], mb[k])), k
    assert (a.state.step, a.state.seed, a.state.optimizer.count) == (
        b.state.step, b.state.seed, b.state.optimizer.count)


@pytest.fixture
def trained(world):
    task, cfg, ds = _task(world)
    for batch in list(ds.epoch_batches(B, seed=0))[:2]:
        task.train_step(batch)
    return task


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_restores_everything(world, trained, tmp_path,
                                        async_save):
    root = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(root, trained.state, 2, async_save=async_save)
    ckpt.finalize_async_saves()
    assert path == ckpt.iter_dir(os.path.abspath(root), 2)
    assert os.path.isfile(os.path.join(path, ckpt.STATE_FILE))
    assert ckpt.latest_iteration(root) == 2
    assert not [d for d in os.listdir(root) if ".tmp-" in d]
    fresh, _, _ = _task(world, seed=9)
    state, it = ckpt.load_checkpoint(root, fresh.state)
    assert it == 2 and state is fresh.state
    _assert_same_state(fresh, trained)


def test_async_save_stages_before_it_returns(world, trained, tmp_path,
                                             monkeypatch):
    """The step mutates the state in place: what reaches the disk is the
    state at the time of the call, whatever happens before the write."""
    root = str(tmp_path / "ck")
    gate = threading.Event()
    real_write = ckpt._write

    def slow_write(*a):
        gate.wait(timeout=30)
        return real_write(*a)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    want = {k: v.clone() for k, v in trained.state.model.state_dict().items()}
    ckpt.save_checkpoint(root, trained.state, 2, async_save=True)
    assert ckpt.latest_iteration(root) is None       # not durable yet
    with torch.no_grad():
        for p in trained.state.model.parameters():
            p.add_(1.0)
    gate.set()
    ckpt.finalize_async_saves()
    assert ckpt.latest_iteration(root) == 2
    fresh, _, _ = _task(world, seed=9)
    ckpt.load_checkpoint(root, fresh.state)
    got = fresh.state.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_tracker_written_only_after_the_checkpoint(trained, tmp_path,
                                                   monkeypatch):
    """A write that dies before the rename leaves the tracker at the last
    complete checkpoint and no ``iter_`` directory behind it."""
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, trained.state, 2)
    seen = {}
    real_replace = os.replace

    def spy_replace(src, dst):
        if os.path.basename(dst) == ckpt.TRACKER:
            seen["checkpoint_there"] = os.path.isfile(os.path.join(
                ckpt.iter_dir(root, 4), ckpt.STATE_FILE))
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy_replace)
    ckpt.save_checkpoint(root, trained.state, 4)
    assert seen == {"checkpoint_there": True}
    monkeypatch.setattr(os, "replace", real_replace)

    def dying_save(obj, f, *a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(root, trained.state, 6)
    assert ckpt.latest_iteration(root) == 4
    assert not os.path.isdir(ckpt.iter_dir(root, 6))


def test_async_failure_surfaces_at_the_next_call(trained, tmp_path,
                                                 monkeypatch):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, trained.state, 2)

    def dying_save(obj, f, *a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dying_save)
    ckpt.save_checkpoint(root, trained.state, 4, async_save=True)
    with pytest.raises(RuntimeError, match="background checkpoint") as e:
        ckpt.finalize_async_saves()
    assert isinstance(e.value.__cause__, OSError)
    assert ckpt.latest_iteration(root) == 2
    ckpt.finalize_async_saves()                     # raised once, then clear


def test_load_optim_false_and_iteration_override(world, trained, tmp_path):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, trained.state, 2)
    trained.train_step(next(world[3].epoch_batches(B, seed=3)))
    ckpt.save_checkpoint(root, trained.state, 3)
    fresh, _, _ = _task(world, seed=9)
    _, it = ckpt.load_checkpoint(root, fresh.state, load_optim=False)
    assert it == 3
    sa, sb = fresh.state.model.state_dict(), trained.state.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert (fresh.state.step, fresh.state.seed,
            fresh.state.optimizer.count) == (0, 9, 0)
    assert not _moments(fresh)                       # a fresh optimizer
    _, it = ckpt.load_checkpoint(root, fresh.state, iteration=2)
    assert it == 2 and fresh.state.step == 2
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"), fresh.state)


def test_partial_loaders(world, trained, tmp_path):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, trained.state, 2)
    fresh, _, _ = _task(world, seed=9)
    model, ref = fresh.state.model, trained.state.model

    def same(a, b):
        sa, sb = a.state_dict(), b.state_dict()
        return all(torch.equal(sa[k], sb[k]) for k in sa)

    assert not same(model.retriever, ref.retriever)
    got = ckpt.load_retriever_params(root, model.retriever)
    assert got is model.retriever and same(model.retriever, ref.retriever)
    assert not same(model.reader, ref.reader)
    ckpt.load_reader_params(root, model.reader, iteration=2)
    assert same(model.reader, ref.reader)
    with pytest.raises(RuntimeError):                # the reader's keys
        ckpt.load_retriever_params(root, model.reader)


def test_remove_stale_checkpoints(trained, tmp_path):
    root = str(tmp_path / "ck")
    for it in (1, 2, 3, 4):
        ckpt.save_checkpoint(root, trained.state, it)
    os.makedirs(os.path.join(root, "iter_notanumber"))
    ckpt.remove_stale_checkpoints(root, keep_last=2)
    assert sorted(d for d in os.listdir(root) if d.startswith("iter_0")) == [
        "iter_0000003", "iter_0000004"]
    assert os.path.isdir(os.path.join(root, "iter_notanumber"))
    assert ckpt.latest_iteration(root) == 4
    ckpt.remove_stale_checkpoints(str(tmp_path / "missing"))


def test_resumed_run_equals_uninterrupted_run_bit_for_bit(world, tmp_path):
    """train 4 == train 2 -> save -> load into a fresh task -> train 2, with
    dropout 0.1 (the masks derive from the saved seed and step), through
    the engine's interval save and its resume skip."""
    full, cfg4, ds = _task(world, dropout=0.1, train_iters=4)
    logs = []
    assert engine_lib.train(full, ds, cfg4, printer=logs.append) == 4

    root = str(tmp_path / "ck")
    first, cfg2, _ = _task(world, dropout=0.1, train_iters=2)
    assert engine_lib.train(first, ds, cfg2, save_dir=root,
                            printer=lambda s: None) == 2
    assert ckpt.latest_iteration(root) == 2

    resumed, _, _ = _task(world, dropout=0.1, seed=5, train_iters=4)
    ckpt.load_checkpoint(root, resumed.state)
    assert resumed.state.step == 2 and resumed.state.seed == 0
    assert engine_lib.train(resumed, ds, cfg4, save_dir=root,
                            printer=lambda s: None) == 4
    _assert_same_state(resumed, full)
    assert ckpt.latest_iteration(root) == 4


def test_engine_interval_saves_are_durable_on_return(world, tmp_path):
    task, cfg, ds = _task(world, train_iters=3, save_interval=2,
                          async_save=True)
    root = str(tmp_path / "ck")
    engine_lib.train(task, ds, cfg, save_dir=root, printer=lambda s: None)
    assert not ckpt._PENDING
    assert sorted(os.listdir(root)) == ["iter_0000002", "iter_0000003",
                                        ckpt.TRACKER]
    assert ckpt.latest_iteration(root) == 3


def test_adam_state_from_a_jax_run(world):
    """Two JAX steps, then the port goes on from the converted parameters,
    moments and count: its third step equals the JAX third step (atol 1e-5,
    the optimizer of tests/test_torch_e2e_train.py)."""
    import jax

    from emdr2_tpu.config import MeshConfig
    from emdr2_tpu.parallel import build_mesh
    from emdr2_tpu.retrieval import ShardedEvidenceIndex as JaxIndex
    from emdr2_tpu.tasks import E2EQATask as JaxTask
    from emdr2_tpu_torch.convert import load_adam_from_jax
    from tests.test_torch_e2e_train import _optimizer, _params
    from tests.test_torch_models import jax_flash_cfg, unboxed_numpy

    jcfg, tok, corpus, ds, _ = world
    jcfg = _optimizer(jax_flash_cfg(jcfg), 0.0)
    emb = np.random.RandomState(0).randn(
        len(corpus), jcfg.index.embed_dim).astype(np.float32)
    mesh = build_mesh(MeshConfig(dp=1, tp=1))
    jtask = JaxTask(jcfg, mesh, tok, corpus, JaxIndex(mesh, jcfg.index, emb),
                    total_train_iters=4)
    jtask.init_state(jax.random.PRNGKey(0), B)
    batches = list(ds.epoch_batches(B, seed=0))[:3]
    for batch in batches[:2]:
        jtask.train_step(batch)

    states = jax.tree_util.tree_leaves(
        jtask.state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    (adam,) = [s for s in states if hasattr(s, "mu")]
    cfg = _optimizer(port_config(jcfg), 0.0)
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, emb, device="cpu"),
                     total_train_iters=4, device="cpu")
    task.init_state(0, state_dict=_params(jtask))
    load_adam_from_jax(task.state.optimizer, task.state.model,
                       unboxed_numpy(adam.mu), unboxed_numpy(adam.nu),
                       int(adam.count))
    task.state.step = int(jtask.state.step)
    assert task.state.optimizer.count == 2 and task.state.step == 2

    want = jtask.train_step(batches[2])
    got = task.train_step(batches[2])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), atol=1e-5)
    ref = _params(jtask)
    sd = task.state.model.state_dict()
    for key, p in ref.items():
        np.testing.assert_allclose(sd[key].numpy(), p.numpy(), atol=1e-5,
                                   err_msg=key)
    with pytest.raises(ValueError):
        load_adam_from_jax(task.state.optimizer, task.state.model, {}, {}, 0)
