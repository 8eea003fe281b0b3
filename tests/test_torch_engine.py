"""The port's training loop: ``emdr2_tpu_torch.training.engine.train`` on the
toy world against ``emdr2_tpu.training.engine.train`` from the same converted
weights (``prefetch_depth=0``), and the loop's rules on a stub task.

The parity run uses the optimizer of tests/test_torch_e2e_train.py (lr 5e-3,
Adam eps 1e-3, see there why) and holds every logged interval of
``TrainLog.history`` and the final parameters to atol 1e-5 (fp32, summation
order).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import MeshConfig  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import (  # noqa: E402
    ShardedEvidenceIndex as JaxIndex,
)
from emdr2_tpu.tasks import E2EQATask as JaxTask  # noqa: E402
from emdr2_tpu.training import engine as jax_engine  # noqa: E402
from emdr2_tpu_torch.config import tiny_config  # noqa: E402
from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex  # noqa: E402
from emdr2_tpu_torch.tasks import E2EQATask  # noqa: E402
from emdr2_tpu_torch.training import engine as engine_lib  # noqa: E402
from emdr2_tpu_torch.training.step import METRICS  # noqa: E402
from emdr2_tpu_torch.utils import monitoring  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_e2e_train import _optimizer, _params  # noqa: E402
from tests.test_torch_models import jax_flash_cfg  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

B = 4
ATOL = 1e-5


def _loop(cfg, **kw):
    base = dict(batch_size=B, log_interval=2, save_interval=10 ** 6,
                eval_interval=10 ** 6, seed=7)
    base.update(kw)
    return cfg.replace(train=dataclasses.replace(cfg.train, **base))


def test_engine_matches_jax_engine(tmp_path):
    """Five iterations of the six batches of an epoch (24 questions / 4):
    the history of both logged intervals, the evaluation callback's
    iterations, the final iteration and the final parameters."""
    jcfg, tok, corpus, ds, _ = build_toy_world(tmp_path)
    jcfg = _loop(_optimizer(jax_flash_cfg(jcfg), 0.0), train_iters=5,
                 eval_interval=4)
    emb = np.random.RandomState(0).randn(
        len(corpus), jcfg.index.embed_dim).astype(np.float32)
    mesh = build_mesh(MeshConfig(dp=1, tp=1))
    jtask = JaxTask(jcfg, mesh, tok, corpus, JaxIndex(mesh, jcfg.index, emb),
                    total_train_iters=5)
    jtask.init_state(jax.random.PRNGKey(0), B)
    start = _params(jtask)

    cfg = _loop(_optimizer(port_config(jcfg), 0.0), train_iters=5,
                eval_interval=4)
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, emb, device="cpu"),
                     total_train_iters=5, device="cpu")
    task.init_state(0, state_dict=start)

    want_lines, got_lines, want_evals, got_evals = [], [], [], []
    # the JAX loop keeps its log to itself: read its TrainLog through the
    # printer's lines and compare the parsed numbers
    want_it = jax_engine.train(jtask, ds, jcfg,
                               eval_callback=want_evals.append,
                               printer=want_lines.append)
    log = engine_lib.TrainLog(cfg.train.log_interval, got_lines.append)
    got_it = engine_lib.train(task, ds, cfg, eval_callback=got_evals.append,
                              printer=got_lines.append, log=log)
    assert got_it == want_it == 5 and task.state.step == 5
    assert got_evals == want_evals == [4]

    def parse(lines):
        rows = []
        for line in lines:
            if "iteration" in line and "|" in line and "/" in line:
                head, *parts = [p.strip() for p in line.split("|")]
                row = {"iteration": int(head.split()[1].split("/")[0])}
                for part in parts:
                    k, v = part.split()
                    row[k] = float(v)
                rows.append(row)
        return rows

    want_rows, got_rows = parse(want_lines), parse(got_lines)
    history = log.history
    assert [r["iteration"] for r in history] == [2, 4]
    assert [r["iteration"] for r in want_rows] == [2, 4]
    for h, w, g in zip(history, want_rows, got_rows):
        for key in METRICS:
            # the printed values carry five significant digits
            np.testing.assert_allclose(h[key], w[key], rtol=2e-4, atol=ATOL,
                                       err_msg=f"{key} at {h['iteration']}")
            np.testing.assert_allclose(g[key], h[key], rtol=2e-4, atol=ATOL)
        assert np.isfinite(h["ms_per_iter"]) and h["grad_norm"] > 0
    ref = _params(jtask)
    sd = task.state.model.state_dict()
    for key, p in ref.items():
        np.testing.assert_allclose(sd[key].numpy(), p.numpy(), atol=ATOL,
                                   err_msg=key)


# ---- the loop's rules on a stub task (no model, instant steps) ----

class StubState:
    def __init__(self, step=0):
        self.step = step
        self.model = object()


class StubTask:
    def __init__(self, step=0):
        self.state = StubState(step)
        self.global_batch_size = 4
        self.steps_run = 0

    def train_step(self, batch):
        self.steps_run += 1
        self.state.step += 1
        return {"loss": 1.0}


class StubDataset:
    """10 examples -> 2 batches of 4 per epoch (drop_last)."""

    def __init__(self, n=10):
        self.n = n
        self.epoch_seeds = []

    def __len__(self):
        return self.n

    def epoch_batches(self, batch_size, seed, **kw):
        self.epoch_seeds.append(seed)
        for i in range(self.n // batch_size):
            yield ("batch", seed, i)


def _cfg(**train_kw):
    cfg = tiny_config()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, log_interval=1000, save_interval=10 ** 6,
        eval_interval=10 ** 6, **train_kw))


def _quiet(s):
    pass


@pytest.mark.parametrize("step,epochs,train_iters,want_it,want_steps", [
    (0, 2, 7, 7, 7),        # explicit train_iters wins over 2 epochs x 2
    (0, 3, None, 6, 6),     # epochs derive the total
    (0, 5, 3, 3, 3),        # train_iters below the epochs' total
    (3, 2, None, 4, 1),     # resume at epoch 1, offset 1: one step left
    (5, 2, 7, 7, 2),        # resume past a cycled boundary
    (7, 2, 7, 7, 0),        # already done
])
def test_train_iters_and_resume(step, epochs, train_iters, want_it,
                                want_steps):
    task, ds = StubTask(step), StubDataset()
    it = engine_lib.train(task, ds, _cfg(epochs=epochs,
                                         train_iters=train_iters),
                          printer=_quiet)
    assert it == want_it and task.steps_run == want_steps
    if step == 0 and train_iters == 7:
        # 4 epochs consumed (2+2+2+1), each with its own shuffle seed
        assert len(set(ds.epoch_seeds)) == len(ds.epoch_seeds) == 4


def test_empty_dataset_terminates():
    task, ds = StubTask(), StubDataset(n=2)      # no full batch of 4
    it = engine_lib.train(task, ds, _cfg(epochs=3, train_iters=9),
                          printer=_quiet)
    assert it == 0 and task.steps_run == 0


class SpyWriter:
    """MetricsWriter stand-in recording scalar writes and close calls."""

    instances = []

    def __init__(self, log_dir):
        self.scalar_calls = []
        self.closed = False
        SpyWriter.instances.append(self)

    def scalars(self, metrics, step):
        self.scalar_calls.append((dict(metrics), step))

    def text(self, tag, value, step=0):
        pass

    def close(self):
        self.closed = True


@pytest.fixture
def spy(monkeypatch):
    SpyWriter.instances = []
    monkeypatch.setattr(monitoring, "MetricsWriter", SpyWriter)
    return SpyWriter


class BoomTask(StubTask):
    def train_step(self, batch):
        if self.steps_run == 1:
            raise RuntimeError("boom")
        return super().train_step(batch)


@pytest.mark.parametrize("how", ["complete", "exit_interval", "timeout",
                                 "error"])
def test_writer_closed_on_every_exit(spy, how):
    if how == "complete":
        it = engine_lib.train(StubTask(), StubDataset(), _cfg(train_iters=3),
                              printer=_quiet)
        assert it == 3
    elif how == "exit_interval":
        it = engine_lib.train(StubTask(), StubDataset(),
                              _cfg(train_iters=9, exit_interval=2),
                              printer=_quiet)
        assert it == 2
    elif how == "timeout":
        it = engine_lib.train(StubTask(), StubDataset(), _cfg(train_iters=9),
                              timeout_minutes=1e-9, printer=_quiet)
        assert 0 < it < 9
    else:
        with pytest.raises(RuntimeError, match="boom"):
            engine_lib.train(BoomTask(), StubDataset(), _cfg(train_iters=3),
                             printer=_quiet)
    assert spy.instances[-1].closed


def test_eval_metrics_reach_writer(spy):
    calls = []

    def eval_cb(iteration):
        calls.append(iteration)
        return {"valid_em": 41.5, "valid_n": 100}

    cfg = _cfg(train_iters=4)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, eval_interval=2))
    engine_lib.train(StubTask(), StubDataset(), cfg, eval_callback=eval_cb,
                     printer=_quiet)
    assert calls == [2, 4]
    em = [(m["valid_em"], s) for m, s in spy.instances[-1].scalar_calls
          if "valid_em" in m]
    assert em == [(41.5, 2), (41.5, 4)]


class SpyRefresher:
    def __init__(self):
        self.events = []

    def start(self, model):
        self.events.append("start")

    def maybe_swap(self, iteration, model):
        self.events.append(("swap?", iteration))
        return iteration == 2

    def stop(self, wait=True):
        self.events.append(("stop", wait))


@pytest.mark.parametrize("how,want_stop", [
    ("complete", ("stop", True)), ("exit_interval", ("stop", True)),
    ("timeout", ("stop", False)), ("error", ("stop", False))])
def test_refresher_stopped_once_on_every_exit(how, want_stop, tmp_path):
    """A raising step stops the refresher too (the JAX loop leaves it
    running); every path stops it exactly once."""
    r = SpyRefresher()
    if how == "error":
        with pytest.raises(RuntimeError, match="boom"):
            engine_lib.train(BoomTask(), StubDataset(), _cfg(train_iters=3),
                             refresher=r, printer=_quiet)
    else:
        kw = {"complete": {}, "exit_interval": {"exit_interval": 2},
              "timeout": {}}[how]
        engine_lib.train(StubTask(), StubDataset(),
                         _cfg(train_iters=3, **kw), refresher=r,
                         timeout_minutes=1e-9 if how == "timeout" else None,
                         printer=_quiet)
    assert r.events[0] == "start"
    stops = [e for e in r.events if isinstance(e, tuple) and e[0] == "stop"]
    assert stops == [want_stop]


def test_refresh_swap_is_counted(spy):
    r = SpyRefresher()
    engine_lib.train(StubTask(), StubDataset(), _cfg(train_iters=4),
                     refresher=r, printer=_quiet)
    assert [e for e in r.events if e[0] == "swap?"] == [
        ("swap?", i) for i in range(4)]
    counts = [(m, s) for m, s in spy.instances[-1].scalar_calls
              if "index_refresh_count" in m]
    assert counts == [({"index_refresh_count": 1}, 2)]


def test_train_log_averages_per_interval_and_reads_tensors():
    lines = []
    log = engine_lib.TrainLog(2, lines.append)
    for it, loss in enumerate([1.0, 3.0, 5.0, 9.0], start=1):
        log.push(it, 4, {"loss": torch.tensor(loss)})
    assert [h["loss"] for h in log.history] == [2.0, 7.0]
    assert [h["iteration"] for h in log.history] == [2, 4]
    assert len(lines) == 2 and "loss 2.0000e+00" in lines[0]


# ---- the engine's time line and utils/monitoring.py ----

def test_engine_log_line_times_batch_wait_and_step():
    """Each logged interval prints ``time (ms) | batch: .. | step: ..``,
    a step's mean of the host's wait for the next batch and of the step
    (the host clock on the CPU)."""
    import re
    import time

    class SlowTask(StubTask):
        def train_step(self, batch):
            time.sleep(0.004)
            return super().train_step(batch)

    class SlowDataset(StubDataset):
        def epoch_batches(self, batch_size, seed, **kw):
            for b in super().epoch_batches(batch_size, seed, **kw):
                time.sleep(0.002)
                yield b

    cfg = _cfg(train_iters=4)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_interval=2))
    lines = []
    engine_lib.train(SlowTask(), SlowDataset(), cfg, printer=lines.append)
    line = re.compile(r"^ time \(ms\) \| batch: (\d+\.\d\d) \| "
                      r"step: (\d+\.\d\d)$")
    times = [line.match(s) for s in lines if "time (ms)" in s]
    assert len(times) == 2 and all(times)
    for m in times:
        batch, step = float(m.group(1)), float(m.group(2))
        assert 2.0 <= batch < 1e3 and 4.0 <= step < 1e3


def test_monitoring_without_a_card_or_a_log_dir(tmp_path):
    lines = []
    if not torch.cuda.is_available():
        assert monitoring.report_memory(" ", lines.append) == {}
        assert lines == []
    w = monitoring.MetricsWriter(None)
    w.scalars({"loss": 1.0}, 1)
    w.text("config", "x")
    w.close()
