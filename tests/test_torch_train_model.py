"""The port's training forward against the JAX package (CPU, fp32): the
same converted flax parameters and numpy batch through ``EMDR2Model`` on
both sides at ``tiny_config`` with dropout 0 (``deterministic=True``), and
the gradients of the joint loss against ``jax.grad``. Then properties of
the port alone: the chunked teacher head against the dense one, remat on
and off at dropout > 0 (identical loss and gradients: the recompute
regenerates the same masks), and dropout determinism.

Tolerance: fp32 on both sides, differing in summation order: atol 1e-5 on
log-probs and logits, atol 1e-5 on gradients (the largest are O(1)).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from emdr2_tpu.models import EMDR2Model as JaxEMDR2Model  # noqa: E402
from emdr2_tpu.training.losses import (  # noqa: E402
    emdr2_total_loss as jax_total_loss,
)
from emdr2_tpu_torch.config import (  # noqa: E402
    tiny_config,
    with_flash_attention,
    with_transformers,
)
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.models import EMDR2Batch, EMDR2Model  # noqa: E402
from emdr2_tpu_torch.models import layers  # noqa: E402
from emdr2_tpu_torch.ops.hashing import DropoutSeeds  # noqa: E402
from emdr2_tpu_torch.training.losses import emdr2_total_loss  # noqa: E402
from tests.test_models import make_batch  # noqa: E402
from tests.test_torch_models import jax_flash_cfg  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-5
EOS = 600


def jax_batch(jcfg):
    """make_batch with padded reader rows, a shorter answer and a padded
    context, so every mask path is exercised."""
    b = make_batch(jcfg)
    reader = np.array(b.reader_ids)
    reader[0, 1, 30:] = 0
    one = np.array(b.reader_one_ctx_ids)
    one[1, 2, 20:] = 0
    ctx = np.array(b.context_bert_ids)
    ctx[1, 0, 10:] = 0
    dec, labels, mask = (np.array(b.dec_ids), np.array(b.labels),
                         np.array(b.loss_mask))
    dec[1, 5:] = 0
    labels[1, 5:] = 0
    mask[1, 5:] = 0.0
    return b._replace(reader_ids=jnp.asarray(reader),
                      reader_one_ctx_ids=jnp.asarray(one),
                      context_bert_ids=jnp.asarray(ctx),
                      dec_ids=jnp.asarray(dec), labels=jnp.asarray(labels),
                      loss_mask=jnp.asarray(mask))


def torch_batch(batch) -> EMDR2Batch:
    return EMDR2Batch(*[torch.tensor(np.asarray(x)) for x in batch])


@pytest.fixture(scope="module", params=["flash", "plain"])
def pair(request):
    """(port cfg, port model, numpy batch, JAX outputs, loss and grads):
    one jitted JAX call (the Pallas kernels in interpret mode) computes the
    forward and the gradients of the joint loss."""
    flash = request.param == "flash"
    jcfg = jax_tiny_config()
    cfg = tiny_config()
    if flash:
        jcfg, cfg = jax_flash_cfg(jcfg), with_flash_attention(cfg)
    jbatch = jax_batch(jcfg)
    jmodel = JaxEMDR2Model(jcfg)
    params = nn.meta.unbox(jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(1)}, jbatch)["params"])

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jbatch)
        total = jax_total_loss(out.lm_logits, out.topk_log_probs,
                               out.gold_log_probs, jbatch.labels,
                               jbatch.loss_mask, eos_id=EOS)[0]
        return total, out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    model = EMDR2Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    want = dict(out=out, loss=float(loss), grads=params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads)))
    return cfg, model, jbatch, want


def test_forward_matches_jax(pair):
    cfg, model, jbatch, want = pair
    with torch.no_grad():
        got = model(torch_batch(jbatch))
    for name in want["out"]._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want["out"], name)),
                                   atol=ATOL, err_msg=name)


def test_loss_gradients_match_jax_grad(pair):
    cfg, model, jbatch, want = pair
    batch = torch_batch(jbatch)
    model.zero_grad(set_to_none=True)
    out = model(batch)
    loss, _ = emdr2_total_loss(out.lm_logits, out.topk_log_probs,
                               out.gold_log_probs, batch.labels.long(),
                               batch.loss_mask, eos_id=EOS)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want["loss"], atol=ATOL)
    named = dict(model.named_parameters())
    assert set(want["grads"]) == set(named)
    for key, g in want["grads"].items():
        got = named[key].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=ATOL,
                                   err_msg=key)
    model.zero_grad(set_to_none=True)


def test_chunked_teacher_head_matches_dense(pair):
    cfg, model, jbatch, _ = pair
    b = torch_batch(jbatch)
    with torch.no_grad():
        hidden, flat = model.fid_encode(b.reader_ids)
        mask = layers_mask(b.dec_ids, flat)
        dense = torch.log_softmax(model.reader.decode(b.dec_ids, hidden, mask),
                                  dim=-1)
        want = dense.gather(-1, b.labels.long()[..., None])[..., 0]
        got = model.reader.decode_gold_log_probs(b.dec_ids, hidden, mask,
                                                 b.labels.long())
    assert cfg.reader.transformer.vocab_size % 4 == 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def layers_mask(dec_ids, flat):
    from emdr2_tpu_torch.data import masks
    return masks.attention_mask(dec_ids, flat)


def dropout_cfg(flash=True, remat=False, rate=0.1):
    kw = dict(hidden_dropout=rate, attention_dropout=rate, remat=remat)
    cfg = with_transformers(tiny_config(), kw, kw)
    return with_flash_attention(cfg) if flash else cfg


def loss_and_grads(cfg, state_dict, batch, seed):
    model = EMDR2Model(cfg, device="cpu")
    model.load_state_dict(state_dict)
    out = model(batch, drop=DropoutSeeds(seed))
    loss, _ = emdr2_total_loss(out.lm_logits, out.topk_log_probs,
                               out.gold_log_probs, batch.labels.long(),
                               batch.loss_mask, eos_id=EOS)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("flash", [True, False])
def test_remat_gives_identical_loss_and_grads_with_dropout(pair, flash):
    """Checkpointing every stack re-runs each layer's forward in the
    backward; the seeds travel with the layer's arguments, so the
    recompute draws the forward's masks and nothing changes."""
    _, model, jbatch, _ = pair
    sd = model.state_dict()
    batch = torch_batch(jbatch)
    calls = []
    orig = layers.TransformerStack._run

    def spy(self, fn, *args):
        calls.append(self.cfg.remat and torch.is_grad_enabled())
        return orig(self, fn, *args)

    layers.TransformerStack._run = spy
    try:
        loss0, g0 = loss_and_grads(dropout_cfg(flash, False), sd, batch, 7)
        calls.clear()
        loss1, g1 = loss_and_grads(dropout_cfg(flash, True), sd, batch, 7)
    finally:
        layers.TransformerStack._run = orig
    assert any(calls)                          # the checkpointed path ran
    assert torch.equal(loss0, loss1)
    for name, g in g0.items():
        if g is None:
            assert g1[name] is None
        else:
            torch.testing.assert_close(g1[name], g, rtol=0, atol=0,
                                       msg=name)


def test_dropout_is_a_function_of_the_seed(pair):
    _, model, jbatch, _ = pair
    sd = model.state_dict()
    batch = torch_batch(jbatch)
    cfg = dropout_cfg()
    a, _ = loss_and_grads(cfg, sd, batch, 11)
    b, _ = loss_and_grads(cfg, sd, batch, 11)
    c, _ = loss_and_grads(cfg, sd, batch, 12)
    d, _ = loss_and_grads(dropout_cfg(rate=0.0), sd, batch, 11)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    with torch.no_grad():                      # no seeds: no dropout
        m = EMDR2Model(cfg, device="cpu")
        m.load_state_dict(sd)
        e = m(batch).lm_logits
        m0 = EMDR2Model(dropout_cfg(rate=0.0), device="cpu")
        m0.load_state_dict(sd)
        assert torch.equal(e, m0(batch).lm_logits)


def test_flash_cross_attention_pads_keys_to_a_chunk_multiple():
    """With ``flash_key_chunk`` 80 over 192 keys the layer pads 48 keys at
    -1e9 bias for K2; output and gradients equal the materialized path
    under the same key bias (itself held to the JAX package above)."""
    cfg = tiny_config().reader.transformer
    flash = dataclasses.replace(cfg, fid_flash_attention=True,
                                flash_key_chunk=80)
    gen = torch.Generator().manual_seed(0)
    att = layers.Attention(flash, cross_attention=True)
    layers.init_weights(att, gen)
    x = torch.randn(2, 8, cfg.hidden_size, generator=gen)
    enc = torch.randn(2, 192, cfg.hidden_size, generator=gen)
    kv_bias = torch.zeros(2, 192)
    kv_bias[1, 150:] = -1e9
    outs = []
    for path in ("flash", "plain"):
        att.cfg = flash if path == "flash" else cfg
        xs, es = x.clone().requires_grad_(True), enc.clone().requires_grad_(
            True)
        att.zero_grad(set_to_none=True)
        if path == "flash":
            y = att.cross_full(xs, es, kv_bias=kv_bias)
        else:
            y = att.cross_full(xs, es, cross_bias=kv_bias[:, None, None, :])
        y.square().sum().backward()
        outs.append([y.detach(), xs.grad, es.grad]
                    + [p.grad for p in att.parameters()])
    for got, want in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_key_chunk_below_reader_length_matches_jax():
    """``flash_key_chunk=32`` under the reader's 48 tokens: the reader and
    teacher encoders take the general kernel (K4) with keys padded to 64,
    forward and backward (the plain backward of the TPU kernel's formula on
    the port's side, the Pallas VJP in interpret mode on the JAX side); the
    towers' 32 and 16 tokens stay on the slab kernel. Forward, loss and
    every gradient, atol 1e-5."""
    from emdr2_tpu_torch.ops import fid_attention

    chunk = {"flash_key_chunk": 32}
    jcfg = jax_flash_cfg(jax_tiny_config())
    jcfg = jcfg.replace(
        retriever=dataclasses.replace(
            jcfg.retriever,
            encoder=dataclasses.replace(jcfg.retriever.encoder, **chunk)),
        reader=dataclasses.replace(
            jcfg.reader,
            transformer=dataclasses.replace(jcfg.reader.transformer,
                                            **chunk)))
    cfg = with_transformers(with_flash_attention(tiny_config()), chunk, chunk)
    jbatch = jax_batch(jcfg)
    jmodel = JaxEMDR2Model(jcfg)
    params = nn.meta.unbox(jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(2)}, jbatch)["params"])

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jbatch)
        total = jax_total_loss(out.lm_logits, out.topk_log_probs,
                               out.gold_log_probs, jbatch.labels,
                               jbatch.loss_mask, eos_id=EOS)[0]
        return total, out

    (want_loss, want_out), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    model = EMDR2Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    batch = torch_batch(jbatch)
    calls = {"fwd": 0, "bwd": 0}
    orig_f = fid_attention.fid_cross_attention_forward
    orig_b = fid_attention.fid_cross_attention_backward

    def spy_f(*a, **k):
        calls["fwd"] += 1
        return orig_f(*a, **k)

    def spy_b(*a, **k):
        calls["bwd"] += 1
        return orig_b(*a, **k)

    fid_attention.fid_cross_attention_forward = spy_f
    fid_attention.fid_cross_attention_backward = spy_b
    try:
        out = model(batch)
        loss, _ = emdr2_total_loss(out.lm_logits, out.topk_log_probs,
                                   out.gold_log_probs, batch.labels.long(),
                                   batch.loss_mask, eos_id=EOS)
        loss.backward()
    finally:
        fid_attention.fid_cross_attention_forward = orig_f
        fid_attention.fid_cross_attention_backward = orig_b
    # two encoder layers: reader (with grad) + teacher (without) forward,
    # and the reader's backward
    n = cfg.reader.transformer.num_layers
    assert calls == {"fwd": 2 * n, "bwd": n}
    for name in want_out._fields:
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(want_out, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=ATOL)
    named = dict(model.named_parameters())
    for key, g in want_grads.items():
        got = named[key].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=ATOL,
                                   err_msg=key)
