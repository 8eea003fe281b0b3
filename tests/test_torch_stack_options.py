"""The two ``TransformerStack`` options of the port against the JAX package
(CPU, fp32, dropout 0): layer parameter sharing (``num_unique_layers``,
grouped and spaced) and ``remat_policy="dots_no_batch"``.

The same flax parameters (``convert.params_from_jax``: a shared stack needs
no renaming, its ``layer_{u}`` names are the flax ones) and the same numpy
ids go through a BERT encoder (and a decoder stack) of both packages; the
outputs and the gradients of one scalar loss are held at 1e-5 (fp32 on
both sides, differing in summation order). ``dots_no_batch`` is held to no
remat and to JAX, and a dispatch mode counts the matrix products the
backward runs: under ``dots_no_batch`` none is recomputed.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from emdr2_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from emdr2_tpu.data import masks as jax_masks  # noqa: E402
from emdr2_tpu.models.bert import BertEncoder as JaxBertEncoder  # noqa: E402
from emdr2_tpu.models.layers import (  # noqa: E402
    TransformerStack as JaxTransformerStack,
)
from emdr2_tpu_torch.config import tiny_config  # noqa: E402
from emdr2_tpu_torch.convert import (  # noqa: E402
    leaves_by_port_key,
    params_from_jax,
)
from emdr2_tpu_torch.data import masks  # noqa: E402
from emdr2_tpu_torch.models.bert import BertEncoder  # noqa: E402
from emdr2_tpu_torch.models.layers import (  # noqa: E402
    DecodeCache,
    TransformerStack,
)
from emdr2_tpu_torch.ops.hashing import DropoutSeeds  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-5


def encoder_cfgs(**fields):
    """(JAX, port) BERT encoder configs of tiny_config with ``fields``."""
    j = dataclasses.replace(jax_tiny_config().retriever.encoder, **fields)
    p = dataclasses.replace(tiny_config().retriever.encoder, **fields)
    return j, p


def unboxed(params):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def make_ids(cfg, B=3, L=12, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, cfg.vocab_size - 1, size=(B, L)).astype(np.int32)
    ids[1, 7:] = 0                     # a padded row
    return ids


def loss_weights(shape, seed=1):
    """Weights of the scalar loss sum(h * w), scaled by the number of rows
    so that the gradients are O(1)."""
    w = np.random.RandomState(seed).randn(*shape) / np.prod(shape[:-1])
    return w.astype(np.float32)


def jax_encoder_run(jcfg, ids, w, seed=0):
    """-> (fp32 numpy params, hidden, {port key: grad})."""
    model = JaxBertEncoder(jcfg)
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        jnp.asarray(ids))["params"]
    params = unboxed(params)

    def loss(p):
        h = model.apply({"params": p}, jnp.asarray(ids))
        return jnp.sum(h * w), h

    (_, h), g = jax.value_and_grad(loss, has_aux=True)(params)
    return params, np.asarray(h), {k: np.asarray(v) for k, v in
                                   leaves_by_port_key(unboxed(g)).items()}


def port_encoder_run(pcfg, params, ids, w, drop=None):
    model = BertEncoder(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    h = model(torch.tensor(ids, dtype=torch.long), drop=drop)
    (h * torch.tensor(w)).sum().backward()
    grads = {k: p.grad.detach().numpy()
             for k, p in model.named_parameters()}
    return model, h.detach().numpy(), grads


def assert_grads(got, want, atol=ATOL):
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k].reshape(g.shape), atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("style", ["grouped", "spaced"])
@pytest.mark.parametrize("flash", [False, True])
def test_shared_encoder_matches_jax(style, flash):
    """4 layer calls over 2 unique layers: the port builds layer_0 and
    layer_1 only, and its forward and gradients equal the JAX stack's."""
    jcfg, pcfg = encoder_cfgs(num_layers=4, num_unique_layers=2,
                              param_sharing_style=style,
                              fid_flash_attention=flash)
    ids = make_ids(pcfg)
    w = loss_weights(ids.shape + (pcfg.hidden_size,))
    params, jh, jg = jax_encoder_run(jcfg, ids, w)
    assert sorted(params["encoder"]) == ["layer_0", "layer_1", "ln_final"]
    model, ph, pg = port_encoder_run(pcfg, params, ids, w)
    assert model.encoder.num_unique == 2
    assert not hasattr(model.encoder, "layer_2")
    np.testing.assert_allclose(ph, jh, atol=ATOL)
    assert_grads(pg, jg)


def test_sharing_order_grouped_and_spaced():
    """Call i runs layer i % u (grouped) or i // (L / u) (spaced)."""
    for style, want in (("grouped", [0, 1, 2, 0, 1, 2]),
                        ("spaced", [0, 0, 1, 1, 2, 2])):
        _, cfg = encoder_cfgs(num_layers=6, num_unique_layers=3,
                              param_sharing_style=style)
        stack = TransformerStack(cfg, device="cpu")
        assert [stack.unique_index(i) for i in range(6)] == want


def test_shared_stack_draws_its_own_masks_each_call():
    """With dropout on, two calls of one shared layer use different seeds:
    grouped sharing over 2 unique layers differs from running the two
    unique layers twice with repeated seeds (the same stack built
    unshared, same weights per call, folds seeds by call index too, so it
    must agree exactly)."""
    _, cfg = encoder_cfgs(num_layers=4, num_unique_layers=2,
                          hidden_dropout=0.1, attention_dropout=0.1)
    _, flat = encoder_cfgs(num_layers=4, hidden_dropout=0.1,
                           attention_dropout=0.1)
    torch.manual_seed(0)
    shared = BertEncoder(cfg, device="cpu")
    from emdr2_tpu_torch.models.layers import init_weights
    init_weights(shared, torch.Generator().manual_seed(0))
    unshared = BertEncoder(flat, device="cpu")
    sd = {}
    for k, v in shared.state_dict().items():
        if k.startswith("encoder.layer_"):
            u = int(k.split(".")[1][len("layer_"):])
            rest = k.split(".", 2)[2]
            for i in range(4):
                if i % 2 == u:
                    sd[f"encoder.layer_{i}.{rest}"] = v
        else:
            sd[k] = v
    unshared.load_state_dict(sd, strict=True)
    ids = torch.tensor(make_ids(cfg), dtype=torch.long)
    drop = DropoutSeeds(7)
    a = shared(ids, drop=drop)
    b = unshared(ids, drop=drop)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, shared(ids))          # dropout did act


def test_shared_decoder_stack_matches_jax():
    """decode_full of a grouped-shared decoder stack (cross-attention,
    materialized scores) against the JAX stack."""
    jcfg = dataclasses.replace(jax_tiny_config().reader.transformer,
                               num_layers=4, num_unique_layers=2)
    pcfg = dataclasses.replace(tiny_config().reader.transformer,
                               num_layers=4, num_unique_layers=2)
    rng = np.random.RandomState(0)
    B, Ld, Lk, H = 2, 5, 9, pcfg.hidden_size
    x = rng.randn(B, Ld, H).astype(np.float32)
    enc = rng.randn(B, Lk, H).astype(np.float32)
    causal = np.tril(np.ones((Ld, Ld), bool))
    self_bias = np.where(causal, 0.0, -1e9).astype(np.float32)[None, None]
    self_bias = np.broadcast_to(self_bias, (B, 1, Ld, Ld)).copy()
    cross = np.zeros((B, 1, Ld, Lk), np.float32)
    cross[1, ..., 6:] = -1e9
    w = loss_weights((B, Ld, H))
    jstack = JaxTransformerStack(jcfg, has_cross_attention=True)
    params = unboxed(jstack.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(enc),
        jnp.asarray(self_bias), jnp.asarray(cross))["params"])

    def loss(p):
        y = jstack.apply({"params": p}, jnp.asarray(x), jnp.asarray(enc),
                         jnp.asarray(self_bias), jnp.asarray(cross))
        return jnp.sum(y * w), y

    (_, jy), jg = jax.value_and_grad(loss, has_aux=True)(params)
    stack = TransformerStack(pcfg, has_cross_attention=True, device="cpu")
    stack.load_state_dict(params_from_jax(params), strict=True)
    y = stack.decode_full(torch.tensor(x), torch.tensor(enc),
                          torch.tensor(self_bias), None, torch.tensor(cross))
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL)
    assert_grads({k: p.grad.numpy() for k, p in stack.named_parameters()},
                 {k: np.asarray(v) for k, v in
                  leaves_by_port_key(unboxed(jg)).items()})


def test_kv_cached_decoding_refuses_sharing():
    pcfg = dataclasses.replace(tiny_config().reader.transformer,
                               num_layers=4, num_unique_layers=2)
    stack = TransformerStack(pcfg, has_cross_attention=True, device="cpu")
    cache = DecodeCache(4, 1, pcfg.num_heads, 4, pcfg.head_dim,
                        torch.float32, "cpu")
    with pytest.raises(ValueError, match="sharing"):
        stack.decode(torch.zeros(1, 1, pcfg.hidden_size), cache, None,
                     torch.zeros(1, 3))
    with pytest.raises(ValueError, match="sharing"):
        stack.check_decode()


def test_bad_sharing_and_policy_are_refused():
    for fields in ({"num_layers": 4, "num_unique_layers": 3},
                   {"num_unique_layers": 1, "param_sharing_style": "ring"},
                   {"remat": True, "remat_policy": "dots"}):
        _, cfg = encoder_cfgs(**fields)
        with pytest.raises(ValueError):
            TransformerStack(cfg, device="cpu")


class _CountMM(TorchDispatchMode):
    """Counts the 2-D matrix products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_mm_count(pcfg, params, ids, w, drop=None):
    model = BertEncoder(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    h = model(torch.tensor(ids, dtype=torch.long), drop=drop)
    loss = (h * torch.tensor(w)).sum()
    with _CountMM() as counter:
        loss.backward()
    grads = {k: p.grad.detach().numpy() for k, p in model.named_parameters()}
    return counter.n, h.detach().numpy(), grads


@pytest.mark.parametrize("flash", [False, True])
def test_dots_no_batch_matches_jax_and_recomputes_no_product(flash):
    """Gradients under dots_no_batch equal no remat's and JAX's (with the
    same policy); the backward runs exactly as many 2-D products as
    without remat (the saved ones are not recomputed), while full
    recompute ("nothing") runs more."""
    fields = dict(num_layers=3, fid_flash_attention=flash)
    jcfg, _ = encoder_cfgs(remat=True, remat_policy="dots_no_batch",
                           **fields)
    ids = make_ids(jcfg)
    w = loss_weights(ids.shape + (jcfg.hidden_size,))
    params, jh, jg = jax_encoder_run(jcfg, ids, w)
    counts, outs = {}, {}
    for name, remat, policy in (("plain", False, "nothing"),
                                ("nothing", True, "nothing"),
                                ("dots_no_batch", True, "dots_no_batch")):
        _, pcfg = encoder_cfgs(remat=remat, remat_policy=policy, **fields)
        counts[name], h, g = _backward_mm_count(pcfg, params, ids, w)
        outs[name] = (h, g)
        np.testing.assert_allclose(h, jh, atol=ATOL)
        assert_grads(g, jg)
    for k, g in outs["dots_no_batch"][1].items():
        np.testing.assert_array_equal(g, outs["plain"][1][k], err_msg=k)
    # the projections and MLP products are recomputed only under "nothing"
    # (up to the last one a layer's backward needs: the non-reentrant
    # recompute stops there)
    assert counts["dots_no_batch"] == counts["plain"]
    assert counts["nothing"] >= counts["plain"] + 3 * 3


def test_dots_no_batch_with_dropout_equals_no_remat():
    """Dropout on: the recompute regenerates the same masks from the seeds,
    so dots_no_batch gives the no-remat gradients bit for bit."""
    fields = dict(num_layers=2, hidden_dropout=0.1, attention_dropout=0.1,
                  fid_flash_attention=True)
    jcfg, _ = encoder_cfgs(**fields)
    ids = make_ids(jcfg)
    w = loss_weights(ids.shape + (jcfg.hidden_size,))
    params = unboxed(JaxBertEncoder(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(ids))["params"])
    res = {}
    for remat in (False, True):
        _, pcfg = encoder_cfgs(remat=remat, remat_policy="dots_no_batch",
                               **fields)
        res[remat] = _backward_mm_count(pcfg, params, ids, w,
                                        drop=DropoutSeeds(11))
    assert res[True][0] == res[False][0]
    np.testing.assert_array_equal(res[True][1], res[False][1])
    for k, g in res[True][2].items():
        np.testing.assert_array_equal(g, res[False][2][k], err_msg=k)


def test_padding_bias_is_the_jax_one():
    """The encoders above see the same key mask on both sides."""
    ids = make_ids(tiny_config().retriever.encoder)
    np.testing.assert_array_equal(
        masks.padding_bias(torch.tensor(ids)).numpy(),
        np.asarray(jax_masks.padding_bias(jnp.asarray(ids))))
