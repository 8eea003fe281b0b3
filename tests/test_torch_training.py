"""The port's training pieces against the JAX package on numpy inputs:
``emdr2_total_loss`` (EMDR2 and KL retriever variants, and reader-only),
``annealing_lr`` for every decay style, the weight-decay mask key for key,
and the optimizer (optax-form global-norm clip + AdamW + schedule) against
the JAX ``make_optimizer`` chain.

Tolerance: fp32 on both sides, differing in summation order: atol 1e-5 on
O(1) losses, 1e-6 on parameters after three updates; the schedules agree
to fp32 rounding (rtol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from emdr2_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from emdr2_tpu.models import EMDR2Model as JaxEMDR2Model  # noqa: E402
from emdr2_tpu.training import losses as jax_losses  # noqa: E402
from emdr2_tpu.training import step as jax_step  # noqa: E402
from emdr2_tpu.training.schedules import (  # noqa: E402
    annealing_lr as jax_annealing_lr,
)
from emdr2_tpu_torch.config import OptimizerConfig, tiny_config  # noqa: E402
from emdr2_tpu_torch.convert import leaves_by_port_key  # noqa: E402
from emdr2_tpu_torch.models import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.training import losses, step  # noqa: E402
from emdr2_tpu_torch.training.schedules import annealing_lr  # noqa: E402
from tests.test_models import make_batch  # noqa: E402

torch.set_num_threads(2)


def loss_inputs(seed=0, B=3, K=5, L=7, V=40, eos=30):
    rng = np.random.RandomState(seed)
    lm_logits = rng.randn(B, L, V).astype(np.float32) * 3
    topk = jax.nn.log_softmax(rng.randn(B, K).astype(np.float32))
    gold = np.log(rng.dirichlet(np.ones(V), size=(B, K, L))[..., 0]
                  ).astype(np.float32)
    labels = rng.randint(1, V, size=(B, L)).astype(np.int32)
    labels[0, 2] = eos + 3                    # a sentinel id
    mask = np.ones((B, L), np.float32)
    mask[1, 4:] = 0.0
    mask[2, :] = 0.0                          # a row with no tokens
    return lm_logits, np.array(topk), gold, labels, mask


@pytest.mark.parametrize("use_kl_div", [False, True])
@pytest.mark.parametrize("update_retriever", [True, False])
def test_total_loss_matches_jax(use_kl_div, update_retriever):
    args = loss_inputs(seed=int(use_kl_div) + 2 * int(update_retriever))
    want_total, want_aux = jax_losses.emdr2_total_loss(
        *[jnp.asarray(a) for a in args], eos_id=30,
        update_retriever=update_retriever, use_kl_div=use_kl_div)
    t = [torch.as_tensor(a) for a in args]
    t[3] = t[3].long()
    got_total, got_aux = losses.emdr2_total_loss(
        *t, eos_id=30, update_retriever=update_retriever,
        use_kl_div=use_kl_div)
    np.testing.assert_allclose(got_total.item(), float(want_total), atol=1e-5)
    for name in want_aux._fields:
        np.testing.assert_allclose(getattr(got_aux, name).item(),
                                   float(getattr(want_aux, name)), atol=1e-5,
                                   err_msg=name)


def test_retriever_loss_gradient_reaches_topk_only():
    lm_logits, topk, gold, labels, mask = (torch.as_tensor(a)
                                           for a in loss_inputs(1))
    topk = topk.clone().requires_grad_(True)
    gold = gold.clone().requires_grad_(True)
    aux = losses.emdr2_retriever_loss(gold.detach(), topk, labels.long(),
                                      mask, 30)
    aux.retriever_loss.backward()
    assert topk.grad is not None and gold.grad is None


@pytest.mark.parametrize("style", ["linear", "cosine", "exponential",
                                   "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_annealing_lr_matches_jax(style, warmup):
    want = jax_annealing_lr(2e-3, warmup, 20, style, min_lr=1e-5)
    got = annealing_lr(2e-3, warmup, 20, style, min_lr=1e-5)
    for s in range(0, 30):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {s}")
    if warmup:
        assert got(0) == 0.0                  # the first update's lr


def test_decay_mask_matches_jax_key_for_key():
    jcfg = jax_tiny_config()
    params = JaxEMDR2Model(jcfg).init({"params": jax.random.PRNGKey(0)},
                                      make_batch(jcfg))["params"]
    import flax.linen as nn
    want = leaves_by_port_key(jax.tree_util.tree_map(
        bool, jax_step.decay_mask(nn.meta.unbox(params))))
    got = step.decay_mask(EMDR2Model(tiny_config(), device="cpu"))
    assert got == want
    assert not got["reader.lm_bias"] and not got[
        "reader.encoder.ln_final.weight"]
    assert got["reader.shared_embeddings.word_embeddings"]


class _Toy(torch.nn.Module):
    """Parameters named like the model's: a kernel, a bias, a LayerNorm."""

    def __init__(self, arrays):
        super().__init__()
        self.layer = torch.nn.Module()
        self.layer.kernel = torch.nn.Parameter(torch.tensor(arrays[0]))
        self.layer.bias = torch.nn.Parameter(torch.tensor(arrays[1]))
        self.ln_final = torch.nn.Module()
        self.ln_final.weight = torch.nn.Parameter(torch.tensor(arrays[2]))


@pytest.mark.parametrize("warmup", [0.0, 0.5])
def test_optimizer_matches_optax_chain(warmup):
    """Three updates with gradients below and above the clip norm; the
    unused parameter (no gradient) still decays, as under optax."""
    rng = np.random.RandomState(0)
    arrays = [rng.randn(4, 3).astype(np.float32),
              rng.randn(3).astype(np.float32),
              rng.randn(3).astype(np.float32)]
    grads = [[rng.randn(*a.shape).astype(np.float32) * s for a in arrays]
             for s in (0.1, 3.0, 0.5)]
    kw = dict(lr=1e-2, weight_decay=0.1, warmup=warmup, clip_grad=1.0)
    tx = jax_step.make_optimizer(JaxOptimizerConfig(**kw), 6)
    jp = {"layer": {"kernel": jnp.asarray(arrays[0]),
                    "bias": jnp.asarray(arrays[1])},
          "ln_final": {"scale": jnp.asarray(arrays[2])}}
    state = tx.init(jp)
    toy = _Toy(arrays)
    opt = step.make_optimizer(toy, OptimizerConfig(**kw), 6)
    for g in grads:
        g[1] = g[1] * 0.0                     # no gradient for the bias
        jg = {"layer": {"kernel": jnp.asarray(g[0]), "bias": jnp.asarray(g[1])},
              "ln_final": {"scale": jnp.asarray(g[2])}}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        toy.layer.kernel.grad = torch.tensor(g[0])
        toy.ln_final.weight.grad = torch.tensor(g[2])
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jg)),
                                   rtol=1e-6)
    for key, p in leaves_by_port_key(jp).items():
        got = dict(toy.named_parameters())[key]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(p),
                                   atol=1e-6, err_msg=key)
    assert opt.count == 3


def test_remat_policy_dots_no_batch_is_refused():
    """``dots_no_batch`` is ported now (tests/test_torch_stack_options.py):
    the model takes it, and refuses a policy name it does not know."""
    cfg = tiny_config()
    for policy, ok in (("dots_no_batch", True), ("dots", False)):
        enc = dataclasses.replace(cfg.retriever.encoder, remat=True,
                                  remat_policy=policy)
        mcfg = cfg.replace(retriever=dataclasses.replace(cfg.retriever,
                                                         encoder=enc))
        if ok:
            EMDR2Model(mcfg, device="cpu")
        else:
            with pytest.raises(ValueError):
                EMDR2Model(mcfg, device="cpu")
