"""Generation in the port against the JAX package on ``tiny_config()`` in
fp32: the same weights (carried across by ``convert.py``) and the same
batch. The weights are a random init plus numpy noise of std 0.2 on every
kernel and table, which makes the tiny model's token distributions varied
(a plain random init repeats its input token), so that the beam search's
bookkeeping is exercised: hypotheses that overtake each other, parents that
change, EOS ids that end some hypotheses early.

Token lists must be equal: greedy, beam 1/3/5, with the bf16-path K/V and
with the int8 K/V. Sampling cannot be held to ``jax.random.categorical`` bit
for bit; it is held to its own seed, and to the greedy tokens on sharply
peaked logits. Beam folding is held to the call on a repeated slab
(atol 1e-5, fp32 sums in another order)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from emdr2_tpu.models import EMDR2Model as JaxEMDR2Model  # noqa: E402
from emdr2_tpu.models import decoding as jax_dec  # noqa: E402
from emdr2_tpu.utils import metrics as jax_metrics  # noqa: E402
from emdr2_tpu_torch.config import tiny_config  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.models import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.models import decoding as dec  # noqa: E402
from emdr2_tpu_torch.models.layers import Attention, DecodeCache  # noqa: E402
from emdr2_tpu_torch.ops.decode_attention import (  # noqa: E402
    padded_rows,
    quantize_kv_rows,
)
from emdr2_tpu_torch.utils import metrics  # noqa: E402
from tests.test_models import make_batch  # noqa: E402
from tests.test_torch_models import torch_batch, unboxed_numpy  # noqa: E402

torch.set_num_threads(2)

MAX_LEN = 8
BOS = 1
# 2 never comes up; 510 and 153 come up in several hypotheses of both rows
# (at steps 1 and 5 of the greedy lists), so some beams end early
EOS_IDS = (2, 510, 153)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, jax batch, port model, port batch)."""
    jcfg = jax_tiny_config()
    jbatch = make_batch(jcfg)
    jmodel = JaxEMDR2Model(jcfg)
    params = nn.meta.unbox(
        jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch)["params"])
    rs = np.random.RandomState(0)

    def noisy(x):
        x = np.asarray(x)
        if x.ndim < 2:
            return jnp.asarray(x)
        return jnp.asarray(x + 0.2 * rs.randn(*x.shape).astype(np.float32))

    params = jax.tree_util.tree_map(noisy, params)
    model = EMDR2Model(tiny_config(), device="cpu")
    model.load_state_dict(params_from_jax(unboxed_numpy(params)))
    return jmodel, params, jbatch, model.eval(), torch_batch(jbatch)


def _sessions(pair, kv_quant=None, max_len=MAX_LEN):
    jmodel, params, _, model, _ = pair
    return (jax_dec.DecoderSession(jmodel, params, max_len,
                                   kv_quant=kv_quant),
            dec.DecoderSession(model, max_len, kv_quant=kv_quant))


def _ints(hyps):
    return [[int(t) for t in h] for h in hyps]


@pytest.mark.parametrize("eos", EOS_IDS)
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_greedy_tokens_equal_jax(pair, kv_quant, eos):
    _, _, jbatch, _, batch = pair
    jsess, sess = _sessions(pair, kv_quant)
    want = _ints(jax_dec.greedy_decode(jsess, jbatch, BOS, eos))
    got = dec.greedy_decode(sess, batch, BOS, eos)
    assert got == want
    assert len({tuple(h) for h in got}) > 1          # not a degenerate case


@pytest.mark.parametrize("eos", EOS_IDS)
@pytest.mark.parametrize("beam", [1, 3, 5])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_beam_search_tokens_equal_jax(pair, kv_quant, beam, eos):
    _, _, jbatch, _, batch = pair
    jsess, sess = _sessions(pair, kv_quant)
    want = _ints(jax_dec.beam_search_decode(jsess, jbatch, BOS, eos,
                                            beam_size=beam))
    got = dec.beam_search_decode(sess, batch, BOS, eos, beam_size=beam)
    assert got == want
    if beam == 1:
        assert got == dec.greedy_decode(sess, batch, BOS, eos)


def test_some_hypotheses_end_early(pair):
    """The EOS ids of the cases above do cut hypotheses short."""
    _, _, _, _, batch = pair
    _, sess = _sessions(pair)
    lens = [len(h) for eos in EOS_IDS for k in (1, 3, 5)
            for h in dec.beam_search_decode(sess, batch, BOS, eos,
                                            beam_size=k)]
    assert min(lens) < MAX_LEN == max(lens)
    assert len(set(lens)) > 2


@pytest.mark.parametrize("beam", [1, 3])
def test_int8_lists_equal_bf16_path_lists(pair, beam):
    _, _, _, _, batch = pair
    _, base = _sessions(pair)
    _, q8 = _sessions(pair, "int8")
    assert (dec.beam_search_decode(q8, batch, BOS, 153, beam_size=beam)
            == dec.beam_search_decode(base, batch, BOS, 153, beam_size=beam))
    assert (dec.greedy_decode(q8, batch, BOS, 153)
            == dec.greedy_decode(base, batch, BOS, 153))


def test_int8_cross_kvs_layout_and_bad_mode(pair):
    _, _, _, model, batch = pair
    sess = dec.DecoderSession(model, 4, kv_quant="int8")
    kvs, flat = sess.encode(batch)
    cfg = model.config.reader.transformer
    B, Lk = flat.shape
    Lp = padded_rows(Lk)
    assert Lp > Lk                                   # the tiny slab is padded
    assert len(kvs) == cfg.num_layers
    k8, ks, v8, vs = kvs[0]
    assert k8.dtype == v8.dtype == torch.int8
    assert k8.shape == v8.shape == (B, cfg.num_heads, Lp, cfg.head_dim)
    assert ks.shape == vs.shape == (B, cfg.num_heads, Lp)
    assert not k8[:, :, Lk:].any() and not v8[:, :, Lk:].any()
    assert (ks[:, :, Lk:] == 1).all() and (vs[:, :, Lk:] == 1).all()
    with pytest.raises(ValueError):
        dec.DecoderSession(model, 4, kv_quant="int4")


@pytest.mark.parametrize("n", [1, 2, 5, 31])
def test_length_penalty_equals_jax(n):
    assert dec.length_penalty(n) == jax_dec.length_penalty(n)
    assert dec.length_penalty(n, 0.3) == jax_dec.length_penalty(n, 0.3)
    got = dec.length_penalty(torch.tensor(float(n)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), jax_dec.length_penalty(n),
                               rtol=1e-6)


def test_top_k_takes_the_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = dec._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ------------------------------------------------------------------ sampling

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sampling_repeats_per_seed_and_differs_across_seeds(pair):
    _, _, _, _, batch = pair
    _, sess = _sessions(pair, max_len=6)
    a = dec.greedy_decode(sess, batch, BOS, 0, rng=_gen(7), sample=True)
    b = dec.greedy_decode(sess, batch, BOS, 0, rng=_gen(7), sample=True)
    c = dec.greedy_decode(sess, batch, BOS, 0, rng=_gen(8), sample=True)
    assert a == b
    assert a != c
    assert all(1 <= len(h) <= 6 for h in a)
    with pytest.raises(ValueError):
        dec.greedy_decode(sess, batch, BOS, 0, sample=True)


def test_sampling_on_peaked_logits_gives_the_greedy_tokens(pair):
    """With the LM bias pushing one token's logit far above the rest, every
    draw is the argmax."""
    _, _, _, model, batch = pair
    _, sess = _sessions(pair, max_len=5)
    old = model.reader.lm_bias.detach().clone()
    try:
        with torch.no_grad():
            model.reader.lm_bias[77] += 200.0
        greedy = dec.greedy_decode(sess, batch, BOS, 0)
        drawn = dec.greedy_decode(sess, batch, BOS, 0, rng=_gen(3),
                                  sample=True)
    finally:
        with torch.no_grad():
            model.reader.lm_bias.copy_(old)
    assert drawn == greedy == [[77] * 5] * len(greedy)


# -------------------------------------------------------------- beam folding

@pytest.mark.parametrize("int8", [False, True])
def test_beam_folding_equals_the_repeated_slab(int8):
    cfg = tiny_config().reader.transformer
    g, kvB, Lk = 3, 2, 40
    nh, hd, H = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    gen = torch.Generator().manual_seed(0)
    att = Attention(cfg, cross_attention=True, device="cpu")
    for p in att.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    x = torch.randn(g * kvB, 1, H, generator=gen)
    k = torch.randn(kvB, nh, Lk, hd, generator=gen)
    v = torch.randn(kvB, nh, Lk, hd, generator=gen)
    bias = torch.zeros(kvB, Lk)
    bias[0, 30:] = -1e9
    if int8:
        pad = padded_rows(Lk) - Lk
        k8, ks = quantize_kv_rows(k)
        v8, vs = quantize_kv_rows(v)
        F = torch.nn.functional
        kv = (F.pad(k8, (0, 0, 0, pad)), F.pad(ks, (0, pad), value=1.0),
              F.pad(v8, (0, 0, 0, pad)), F.pad(vs, (0, pad), value=1.0))
    else:
        kv = (k, v)
    folded = att.cross(x, kv, bias)
    rep = tuple(t.repeat_interleave(g, dim=0) for t in kv)
    repeated = att.cross(x, rep, bias.repeat_interleave(g, dim=0))
    assert folded.shape == (g * kvB, 1, H)
    np.testing.assert_allclose(folded.detach().numpy(),
                               repeated.detach().numpy(), atol=1e-5)
    with pytest.raises(ValueError):                     # 5 rows over 2 examples
        att.cross(x[:5], kv, bias)


def test_decode_cache_take_rows():
    cache = DecodeCache(2, 2, 2, 3, 4, torch.float32, "cpu")
    for i, (k, v) in enumerate(zip(cache.keys, cache.values)):
        k.copy_(torch.arange(k.numel()).reshape(k.shape) + 100 * i)
        v.copy_(-k)
    want = cache.keys[1][[1, 1, 0]].clone()
    cache.take_rows(torch.tensor([1, 1, 0]))
    assert cache.keys[0].shape == (3, 2, 3, 4)
    assert torch.equal(cache.keys[1], want)
    assert torch.equal(cache.values[1], -want)


# ------------------------------------------------------------------- metrics

ANSWERS = ["The  Quick, Brown-Fox!", "an apple", "Apple", "café", "cafe",
           "", "A the an", "42", "forty-two", "New York City", "(1999)"]


@pytest.mark.parametrize("pred", ANSWERS)
def test_metrics_equal_the_jax_package(pred):
    assert metrics.normalize_answer(pred) == jax_metrics.normalize_answer(pred)
    for truth in ANSWERS:
        assert (metrics.exact_match_score(pred, truth)
                == jax_metrics.exact_match_score(pred, truth))
        assert (metrics.regex_match_score(pred, truth)
                == jax_metrics.regex_match_score(pred, truth))
    assert (metrics.metric_max_over_ground_truths(
        metrics.exact_match_score, pred, ANSWERS)
        == jax_metrics.metric_max_over_ground_truths(
            jax_metrics.exact_match_score, pred, ANSWERS) == 1.0)
