"""The evaluation slice as a whole: the JAX ``E2EQATask`` on a one-device
mesh and the port's, on the toy world of ``tests.helpers.build_toy_world``
with the same index embeddings and converted parameters, under
``flash_key_chunk`` 32: the reader's 48-token rows then take the general
flash route (K4, two key chunks, the second padded), and cross-attention
walks its keys in chunks of 32.

``validation_loss``: three metrics, rtol 1e-4 (fp32 on both sides, another
summation order). ``evaluate_em``: (EM, n) equal, and the generated texts
equal, row for row. The weights get numpy noise so that answers vary; the
references of every other example are replaced by what the model generates,
so that EM is neither 0 nor 100.

Also here: the model's encoder under a key chunk shorter than the sequence
against the JAX model (atol 1e-4), and the rule that entry points default
to the card.
"""

import copy
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import MeshConfig  # noqa: E402
from emdr2_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from emdr2_tpu.models import EMDR2Model as JaxEMDR2Model  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import (  # noqa: E402
    ShardedEvidenceIndex as JaxIndex,
)
from emdr2_tpu.tasks import E2EQATask as JaxTask  # noqa: E402
from emdr2_tpu.tasks import e2eqa as jax_e2eqa  # noqa: E402
from emdr2_tpu.utils import metrics as jax_metrics  # noqa: E402
from emdr2_tpu_torch.config import (  # noqa: E402
    tiny_config,
    with_flash_attention,
    with_transformers,
)
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.models import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.models import layers  # noqa: E402
from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex  # noqa: E402
from emdr2_tpu_torch.tasks import E2EQATask  # noqa: E402
from emdr2_tpu_torch.tasks import e2eqa  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_flash_integration import flash_cfg as jax_flash_cfg  # noqa: E402
from tests.test_models import make_batch  # noqa: E402
from tests.test_torch_models import torch_batch, unboxed_numpy  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

B = 5                     # 19 examples: three full batches and a tail of 4
N_EXAMPLES = 19
KEY_CHUNK = 32
CHUNKED = {"flash_key_chunk": KEY_CHUNK}


def _noisy(params, seed=0, std=0.2):
    rs = np.random.RandomState(seed)

    def f(x):
        x = np.asarray(x)
        if x.ndim < 2:
            return jnp.asarray(x)
        return jnp.asarray(x + std * rs.randn(*x.shape).astype(np.float32))

    return jax.tree_util.tree_map(f, params)


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    """(jax task, port task, dataset of 19 examples)."""
    jcfg, tok, corpus, ds, _ = build_toy_world(tmp_path_factory.mktemp("toy"))
    jcfg = jax_flash_cfg(jcfg, key_chunk=KEY_CHUNK)
    emb = np.random.RandomState(0).randn(
        len(corpus), jcfg.index.embed_dim).astype(np.float32)
    mesh = build_mesh(MeshConfig(dp=1, tp=1))
    jtask = JaxTask(jcfg, mesh, tok, corpus, JaxIndex(mesh, jcfg.index, emb),
                    total_train_iters=4)
    jtask.init_state(jax.random.PRNGKey(0), B)
    boxed = jtask.state.params
    noisy = _noisy(nn.meta.unbox(boxed))
    jtask.state = jtask.state._replace(
        params=jax.tree_util.tree_map(
            lambda old, new: old.replace_boxed(new)
            if isinstance(old, nn.Partitioned) else new,
            boxed, noisy, is_leaf=lambda x: isinstance(x, nn.Partitioned)))

    cfg = with_transformers(port_config(jcfg), CHUNKED, CHUNKED)
    # the port's global batch is the configured one; the JAX task's is
    # init_state's
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B))
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, emb, device="cpu"),
                     total_train_iters=4, device="cpu")
    task.init_state(0, state_dict=params_from_jax(unboxed_numpy(noisy)))
    ds = copy.copy(ds)
    ds.examples = ds.examples[:N_EXAMPLES]
    return jtask, task, ds


def test_validation_loss_matches_jax(tasks):
    jtask, task, ds = tasks
    want = jtask.validation_loss(ds, batch_size=B)
    got = task.validation_loss(ds, batch_size=B)
    assert set(got) == set(want) == {"loss", "lm_loss", "retriever_loss"}
    for key in want:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    two = task.validation_loss(ds, batch_size=B, max_batches=2)
    np.testing.assert_allclose(
        two["loss"], jtask.validation_loss(ds, batch_size=B,
                                           max_batches=2)["loss"], rtol=1e-4)
    assert two["loss"] != got["loss"]


def test_validation_loss_batch_size_defaults_to_the_global_batch(tasks):
    """``validation_loss(ds)`` is the call with ``global_batch_size``
    spelled out, in the port as in the JAX package, and the two agree."""
    jtask, task, ds = tasks
    assert task.global_batch_size == jtask.global_batch_size == B
    got = task.validation_loss(ds)
    assert got == task.validation_loss(ds, batch_size=B)
    assert got == task.validation_loss(ds, None)
    want = jtask.validation_loss(ds)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    assert got != task.validation_loss(ds, batch_size=B - 1)


def test_validation_tail_rows_add_no_tokens(tasks):
    """The padded tail batch weighs in by its 4 real rows: the mean over 19
    is the mean of the four batch means weighted 5, 5, 5, 4."""
    _, task, ds = tasks
    whole = task.validation_loss(ds, batch_size=B)
    parts, sizes = [], []
    for batch in ds.epoch_batches(B, seed=0, shuffle=False, drop_last=False):
        real = len(batch.query_uid)
        if real < B:
            batch = e2eqa._pad_qa_batch(batch, B, zero_loss_mask=True)
            assert batch.loss_mask[real:].sum() == 0
            assert batch.loss_mask[:real].sum() > 0
        m = task._eval_fn(task.state, task.build_device_batch(batch))
        parts.append(float(m["lm_loss"]))
        sizes.append(real)
    assert sizes == [5, 5, 5, 4]
    np.testing.assert_allclose(whole["lm_loss"],
                               np.average(parts, weights=sizes), rtol=1e-6)


class _Recorder:
    """Wraps ``metric_max_over_ground_truths`` and keeps the predictions."""

    def __init__(self, fn):
        self.fn = fn
        self.texts = []

    def __call__(self, metric, prediction, truths):
        self.texts.append(prediction)
        return self.fn(metric, prediction, truths)


def _evaluate_both(tasks, monkeypatch, ds=None, **kw):
    jtask, task, ds0 = tasks
    ds = ds0 if ds is None else ds
    jrec = _Recorder(jax_metrics.metric_max_over_ground_truths)
    rec = _Recorder(e2eqa.metric_max_over_ground_truths)
    monkeypatch.setattr(jax_metrics, "metric_max_over_ground_truths", jrec)
    monkeypatch.setattr(e2eqa, "metric_max_over_ground_truths", rec)
    want = jtask.evaluate_em(ds, batch_size=B, max_decode_len=4, **kw)
    got = task.evaluate_em(ds, batch_size=B, max_decode_len=4, **kw)
    return want, got, jrec.texts, rec.texts


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kv_quant="int8"),
    dict(beam_size=3),
    dict(beam_size=3, kv_quant="int8"),
], ids=["greedy", "greedy-int8", "beam3", "beam3-int8"])
def test_evaluate_em_matches_jax(tasks, monkeypatch, kw):
    want, got, jtexts, texts = _evaluate_both(tasks, monkeypatch, **kw)
    assert texts == jtexts
    assert len(texts) == 4 * B          # the tail batch is padded to 5 rows
    assert got == want
    assert got[1] == N_EXAMPLES         # the padded copy counts once

    # references of every other example := the generated answer
    _, _, ds = tasks
    ds2 = copy.copy(ds)
    ds2.examples = [
        ex._replace(answers=[texts[i]]) if i % 2 == 0 else ex
        for i, ex in enumerate(ds.examples)]
    want2, got2, _, _ = _evaluate_both(tasks, monkeypatch, ds=ds2, **kw)
    assert got2 == want2
    assert got2[1] == N_EXAMPLES
    assert 100.0 * 10 / 19 - 1e-9 <= got2[0] < 100.0


def test_evaluate_em_batch_size_defaults_to_the_global_batch(tasks,
                                                             monkeypatch):
    """``evaluate_em(ds)`` is the call with ``global_batch_size`` spelled
    out (the same generated texts, the tail padded to 5 rows), in the port
    as in the JAX package, and the two agree."""
    jtask, task, ds = tasks
    rec = _Recorder(e2eqa.metric_max_over_ground_truths)
    monkeypatch.setattr(e2eqa, "metric_max_over_ground_truths", rec)
    got = task.evaluate_em(ds, max_decode_len=4)
    default_texts, rec.texts = rec.texts, []
    assert got == task.evaluate_em(ds, batch_size=B, max_decode_len=4)
    assert rec.texts == default_texts and len(default_texts) == 4 * B
    assert got == jtask.evaluate_em(ds, max_decode_len=4)
    assert got[1] == N_EXAMPLES


def test_evaluate_em_max_batches_and_session_cache(tasks):
    _, task, ds = tasks
    em, n = task.evaluate_em(ds, batch_size=B, max_decode_len=4,
                             max_batches=2)
    assert n == 2 * B and 0.0 <= em <= 100.0
    assert (4, None) in task._sessions
    first = task._sessions[(4, None)]
    task.evaluate_em(ds, batch_size=B, max_decode_len=4, max_batches=1)
    assert task._sessions[(4, None)] is first
    with pytest.raises(ValueError):
        task.evaluate_em(ds, batch_size=B, kv_quant="int4")


def test_evaluate_em_sampling_repeats_per_seed(tasks, monkeypatch):
    _, task, ds = tasks
    rec = _Recorder(e2eqa.metric_max_over_ground_truths)
    monkeypatch.setattr(e2eqa, "metric_max_over_ground_truths", rec)
    kw = dict(batch_size=B, max_decode_len=4, max_batches=2, sample=True)
    a = task.evaluate_em(ds, sample_seed=11, **kw)
    ta, rec.texts = rec.texts, []
    b = task.evaluate_em(ds, sample_seed=11, **kw)
    tb, rec.texts = rec.texts, []
    task.evaluate_em(ds, sample_seed=12, **kw)
    tc = rec.texts
    assert a == b and ta == tb
    assert ta != tc
    # the two batches draw from different streams
    assert e2eqa._fold_sample_seed(11, 0) != e2eqa._fold_sample_seed(11, 1)


def test_pad_qa_batch(tasks):
    _, _, ds = tasks
    batch = ds.batch([0, 1, 2])
    want = jax_e2eqa._pad_qa_batch(batch, 5, zero_loss_mask=True)
    got = e2eqa._pad_qa_batch(batch, 5, zero_loss_mask=True)
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        else:
            assert g == w
    assert len(got.query_uid) == 5 and got.query_uid[4] == got.query_uid[2]
    keep = e2eqa._pad_qa_batch(batch, 4)
    assert keep.loss_mask[3].sum() == batch.loss_mask[2].sum() > 0
    with pytest.raises(ValueError):
        e2eqa._pad_qa_batch(batch, 3)


# ---------------------------------- the encoder beyond one key chunk (K4)

@pytest.mark.parametrize("key_chunk", [16, 20, 32])
def test_model_forward_with_chunked_self_attention_matches_jax(
        key_chunk, monkeypatch):
    """Towers (32 and 16 tokens) and reader (48 tokens) under key chunks of
    16 (divides all), 20 and 32 (non-divisible tails, padded at -1e9)."""
    jcfg = jax_flash_cfg(jax_tiny_config(), key_chunk=key_chunk)
    jbatch = make_batch(jcfg)
    rid = np.array(jbatch.reader_ids)
    rid[:, 0, 20:] = 0                                   # padded reader rows
    rid[1, 2, 41:] = 0
    jbatch = jbatch._replace(reader_ids=jnp.asarray(rid))
    jmodel = JaxEMDR2Model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch)["params"]
    want = jmodel.apply({"params": params}, jbatch)

    calls, slab_calls = [], []
    real = layers.fid_cross_attention
    real_slab = layers.fid_self_attention

    def counting(q, k, v, kvb, seed, chunk, rate):
        calls.append((q.shape[1], k.shape[1], chunk))
        assert not k.shape[1] % chunk
        return real(q, k, v, kvb, seed, chunk, rate)

    def counting_slab(qkv, kvb, nh, seed, chunk, rate):
        # a length the chunk divides goes through the slab itself
        calls.append((qkv.shape[1], qkv.shape[1], chunk))
        slab_calls.append(qkv.shape[1])
        assert not qkv.shape[1] % chunk
        return real_slab(qkv, kvb, nh, seed, chunk, rate)

    monkeypatch.setattr(layers, "fid_cross_attention", counting)
    monkeypatch.setattr(layers, "fid_self_attention", counting_slab)
    chunked = {"flash_key_chunk": key_chunk}
    cfg = with_transformers(with_flash_attention(tiny_config()), chunked,
                            chunked)
    model = EMDR2Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(unboxed_numpy(params)))
    with torch.no_grad():
        got = model(torch_batch(jbatch))
    for name in ("lm_logits", "topk_log_probs", "gold_log_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-4, err_msg=name)
    # the reader's 48-token rows always exceed the chunk; keys are padded
    padded = -(-48 // key_chunk) * key_chunk
    assert (48, padded, key_chunk) in calls
    assert all(L > key_chunk for L, _, _ in calls)
    assert (48 in slab_calls) == (48 % key_chunk == 0)


# ------------------------------------------------- defaults on the card

def test_entry_points_default_to_the_card(tasks):
    """Without a card the default device raises, naming CUDA; the CPU is
    taken only when asked for. (With a card, the default lands on it.)"""
    _, task, _ = tasks
    cfg = tiny_config()
    emb = np.zeros((16, cfg.index.embed_dim), np.float32)
    makers = [
        lambda **kw: EMDR2Model(cfg, **kw),
        lambda **kw: ShardedEvidenceIndex(cfg.index, emb, **kw),
        lambda **kw: E2EQATask(task.cfg, task.tok, task.corpus, task.index,
                               **kw),
    ]
    for make in makers:
        if torch.cuda.is_available():
            obj = make()
            dev = (next(obj.parameters()).device if isinstance(obj, EMDR2Model)
                   else obj.device)
            assert dev.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
            with pytest.raises(RuntimeError, match="CUDA"):
                make(device="cuda:0")
        make(device="cpu")
    assert next(EMDR2Model(cfg, device="cpu").parameters()).device.type == "cpu"
    assert ShardedEvidenceIndex(cfg.index, emb,
                                device="cpu").embeddings.device.type == "cpu"
