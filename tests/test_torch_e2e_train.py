"""The training slice as a whole: the JAX ``E2EQATask`` on a one-device
mesh and the port's ``E2EQATask`` on the toy world of
``tests.helpers.build_toy_world``, with the same index embeddings, the same
converted initial parameters and the same batches. Two ``train_step``s at
dropout 0 must give equal metrics and equal parameters after each step.

lr 5e-3 makes the update visible (as in tests/test_e2e_train.py); one case
runs with warmup, which pins the first update's lr at schedule(0) = 0.
Adam's eps is raised to 1e-3 on both sides: at random init the retriever's
gradient is a posterior minus a prior that are both ~1/K, so its fp32
values carry relative rounding errors of 1e-3..1e-1 in either framework
(some, like the context tower's final LayerNorm bias, are exactly 0 and
come out as noise of ~1e-10). Adam's first step divides g by |g| + eps and
turns such errors into lr-sized differences wherever |g| ~ eps; with eps
1e-3 the update stays linear in them, and Adam's first step is close to
lr * sign(g) wherever |g| >> eps. So each step also holds Adam's first
moments, which carry the clipped gradients at their magnitude, to the JAX
optimizer's. The gradients themselves are held to ``jax.grad`` in
tests/test_torch_train_model.py.

Tolerance: atol 1e-5 on metrics, parameters and first moments over
(1 - beta1) (fp32, summation order).
"""

import dataclasses

import flax.linen as nn
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
from emdr2_tpu_torch.config import with_transformers  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex  # noqa: E402
from emdr2_tpu_torch.tasks import E2EQATask  # noqa: E402
from emdr2_tpu_torch.training.step import METRICS  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_models import jax_flash_cfg  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

B = 4
ATOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_toy_world(tmp_path_factory.mktemp("toy"))


def _optimizer(cfg, warmup):
    opt = dataclasses.replace(cfg.train.optimizer, lr=5e-3, warmup=warmup,
                              adam_eps=1e-3)
    return cfg.replace(train=dataclasses.replace(cfg.train, optimizer=opt))


def _params(jax_task):
    return _on_port_keys(jax_task.state.params)


def _on_port_keys(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  nn.meta.unbox(tree)))


def _jax_first_moments(jax_task):
    """Adam's ``mu`` in the JAX optimizer state, on the port's keys."""
    states = jax.tree_util.tree_leaves(
        jax_task.state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    (adam,) = [s for s in states if hasattr(s, "mu")]
    return _on_port_keys(adam.mu)


def _first_moments(task):
    """AdamW's ``exp_avg`` of every parameter, by name."""
    st = task.state.optimizer.adamw.state
    return {n: st[p]["exp_avg"]
            for n, p in task.state.model.named_parameters()}


@pytest.mark.parametrize("flash,warmup", [(True, 0.0), (False, 0.5)])
def test_two_train_steps_match_jax(world, flash, warmup):
    jcfg, tok, corpus, ds, _ = world
    jcfg = _optimizer(jax_flash_cfg(jcfg) if flash else jcfg, warmup)
    emb = np.random.RandomState(0).randn(
        len(corpus), jcfg.index.embed_dim).astype(np.float32)
    mesh = build_mesh(MeshConfig(dp=1, tp=1))
    jtask = JaxTask(jcfg, mesh, tok, corpus, JaxIndex(mesh, jcfg.index, emb),
                    total_train_iters=4)
    jtask.init_state(jax.random.PRNGKey(0), B)

    cfg = port_config(jcfg)                     # flash on in both towers
    if not flash:
        off = {"fid_flash_attention": False}
        cfg = with_transformers(cfg, off, off)
    cfg = _optimizer(cfg, warmup)
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, emb, device="cpu"),
                     total_train_iters=4, device="cpu")
    task.init_state(0, state_dict=_params(jtask))

    for i, batch in enumerate(list(ds.epoch_batches(B, seed=0))[:2]):
        want = jtask.train_step(batch)
        got = task.train_step(batch)
        for key in METRICS:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       atol=ATOL, err_msg=f"{key} step {i}")
        ref = _params(jtask)
        sd = task.state.model.state_dict()
        for key, p in ref.items():
            np.testing.assert_allclose(sd[key].numpy(), p.numpy(), atol=ATOL,
                                       err_msg=f"{key} after step {i}")
        # the clipped gradients, at their magnitude: mu / (1 - beta1) is
        # g1 after step 1 and beta1 * g1 + g2 after step 2
        scale = 1.0 - cfg.train.optimizer.adam_beta1
        mu = _first_moments(task)
        for key, m in _jax_first_moments(jtask).items():
            np.testing.assert_allclose(mu[key].numpy() / scale,
                                       m.numpy() / scale, atol=ATOL,
                                       err_msg=f"moment {key} step {i}")
    assert task.state.step == 2 and task.state.optimizer.count == 2


def test_first_step_under_warmup_leaves_params(world):
    """schedule(0) = 0 with warmup: the first update changes nothing."""
    jcfg, tok, corpus, ds, _ = world
    cfg = _optimizer(port_config(jcfg), 0.5)
    emb = np.random.RandomState(1).randn(
        len(corpus), cfg.index.embed_dim).astype(np.float32)
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, emb, device="cpu"),
                     total_train_iters=4, device="cpu")
    task.init_state(3)
    before = {k: v.clone() for k, v in task.state.model.state_dict().items()}
    task.train_step(next(ds.epoch_batches(B, seed=0)))
    after = task.state.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    task.train_step(next(ds.epoch_batches(B, seed=1)))
    assert not all(torch.equal(before[k], after[k]) for k in before)


def test_dropout_steps_are_deterministic_per_seed(world):
    """At dropout 0.1, the same state seed gives identical metrics and
    parameters, another seed another loss; every metric is finite."""
    jcfg, tok, corpus, ds, _ = world
    kw = dict(hidden_dropout=0.1, attention_dropout=0.1)
    cfg = with_transformers(port_config(jcfg), kw, kw)
    emb = np.random.RandomState(2).randn(
        len(corpus), cfg.index.embed_dim).astype(np.float32)
    batch = next(ds.epoch_batches(B, seed=0))
    runs = []
    for seed in (5, 5, 6):
        task = E2EQATask(cfg, tok, corpus,
                         ShardedEvidenceIndex(cfg.index, emb, device="cpu"),
                         total_train_iters=4, device="cpu")
        task.init_state(0)
        task.state.seed = seed                 # same weights, other masks
        m = task.train_step(batch)
        assert all(np.isfinite(float(m[k])) for k in METRICS)
        runs.append((m, task.state.model.state_dict()))
    (m0, p0), (m1, p1), (m2, _) = runs
    assert all(float(m0[k]) == float(m1[k]) for k in METRICS)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert float(m0["loss"]) != float(m2["loss"])
