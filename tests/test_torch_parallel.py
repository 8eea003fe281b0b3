"""Data parallelism of the port against the JAX package on a 2-device mesh.

Two gloo processes on the CPU (tests/test_torch_parallel_workers.py, which
imports no jax) run the port's distributed path, each rank on its
contiguous slice of every global batch and its block of the index rows.
The JAX side is the JAX task on a ``dp=2`` mesh of the conftest's virtual
CPU devices, with the plain or interpret path of its kernels, as its own
tests run it. Inputs come from seeded numpy; the JAX weights reach every
rank through ``convert.params_from_jax``.

Tolerances: search ids equal, values 1e-6; the DPR loss with the
all-gather and its gradients 1e-5; OPENQA step metrics rtol 2e-4 (the JAX
multihost test's tolerance for another collective order) and parameters
1e-5 at dropout 0 (the JAX side's dropout seeds come from flax rngs, which
the port does not reproduce, so the two meet at dropout 0); at dropout 0.1
the ranks' parameters are bit-equal; ``validation_loss`` 2e-4;
``evaluate_em``: the generated texts row for row and the EM exactly. The
dropout rule of a rank (the kernels' seed fold, the hidden dropout's
global rows) is held bit for bit against the JAX masks in this process.
"""

import copy
import dataclasses
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import IndexConfig as JaxIndexConfig  # noqa: E402
from emdr2_tpu.config import MeshConfig  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import (  # noqa: E402
    ShardedEvidenceIndex as JaxIndex,
)
from emdr2_tpu.tasks import E2EQATask as JaxTask  # noqa: E402
from emdr2_tpu.training.losses import (  # noqa: E402
    dpr_in_batch_loss as jax_dpr_loss,
)
from emdr2_tpu.utils import metrics as jax_metrics  # noqa: E402
from emdr2_tpu_torch.config import IndexConfig  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.training.step import METRICS  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_eval import _noisy  # noqa: E402
from tests.test_torch_models import jax_flash_cfg  # noqa: E402
from tests.test_torch_models import unboxed_numpy  # noqa: E402
from tests.test_torch_parallel_workers import one_thread  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

WORLD = 2
B = 4                         # global batch: 2 rows a rank
N_EXAMPLES = 10               # 3 evaluation batches, the last padded
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_parallel_workers.py")
WORKER_TIMEOUT_S = 300
N_ROWS, NQ, K = 20_000, 6, 10  # the search: > chunk_rows a rank
EMBED_DEVICES = 2             # the embedder group beside the 2 ranks


def _wait(procs, out, timeout):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _texts_by_row(rank_texts, batches):
    """Per-rank text lists (each rank's rows of every batch) -> global row
    order."""
    per = B // WORLD
    rows = []
    for i in range(batches):
        for texts in rank_texts:
            rows += texts[i * per:(i + 1) * per]
    return rows


class _Recorder:
    def __init__(self, fn):
        self.fn = fn
        self.texts = []

    def __call__(self, metric, prediction, truths):
        self.texts.append(prediction)
        return self.fn(metric, prediction, truths)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references on a dp=2 mesh and the two ranks' results."""
    root = tmp_path_factory.mktemp("parallel")
    jcfg, tok, corpus, ds, _ = build_toy_world(root)
    jcfg = jax_flash_cfg(jcfg)
    emb = np.random.RandomState(0).randn(
        len(corpus), jcfg.index.embed_dim).astype(np.float32)
    mesh = build_mesh(MeshConfig(dp=WORLD, tp=1))
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
    cfg = port_config(jcfg)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B))

    rs = np.random.RandomState(7)
    mips = {"queries": rs.randn(NQ, 64).astype(np.float32),
            "rows": rs.randn(N_ROWS, 64).astype(np.float32), "k": K,
            "index_cfg": IndexConfig(embed_dim=64, dtype=torch.float32)}
    dpr = {"q": rs.randn(WORLD * 3, 16).astype(np.float32),
           "c": rs.randn(WORLD * 6, 16).astype(np.float32)}
    words = [f"item{i}" for i in range(len(corpus))] + [
        "red", "blue", "green", "gold", "color", "of", "is", "what", "the"]
    dpr_task = _dpr_inputs(root)
    dpr_ref = _jax_dpr_task(dpr_task, mesh)
    spec = {"cfg": cfg, "params": params_from_jax(unboxed_numpy(noisy)),
            "emb": emb, "batch": B, "mips": mips, "dpr_loss": dpr,
            "world": {"words": words, "text": str(root / "text"),
                      "title": str(root / "title"),
                      "qa": str(root / "qa.csv"), "n_examples": N_EXAMPLES},
            "engine": {"save": str(root / "ckpt")},
            "dpr_task": dpr_task,
            "embed_devices": EMBED_DEVICES,
            "cases": ["mips", "refresh", "dpr_loss", "dpr_task", "openqa",
                      "engine", "recall", "embedder", "prefetch"]}
    out_dir = root / "out"
    out_dir.mkdir()
    spec_run = dict(spec, world_size=WORLD, out=str(out_dir),
                    address=f"file://{root / 'store'}")
    torch.save(spec_run, root / "spec.pt")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, WORKER, str(root / "spec.pt"),
                               str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    try:
        # before the steps, which donate the weights' buffers
        embedded = _jax_embedding(jcfg, mesh, jtask.model, tok, corpus,
                                  noisy)
        ref = _jax_references(jtask, mesh, ds, mips, dpr)
        ref["embedder"] = embedded
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ref["refresh"] = _one_process_refresh(spec, tok, corpus, ds)
    ref["recall"] = _one_process_recall(spec, tok, corpus)
    ref["sample"] = _one_process_sampling(spec, tok, corpus, ds)
    ref["dpr_task"] = dpr_ref
    got = _wait(procs, out_dir, WORKER_TIMEOUT_S)
    return ref, got


DPR_BATCH = 8
N_TAIL_DEV = 15               # a tail batch of 7: 4 + 3 rows over 2 ranks


def _dpr_inputs(root):
    """The DPR data (16 questions, one hard negative each), the tiny
    retriever config and the JAX DPRTask's initial weights on the port's
    keys."""
    from emdr2_tpu_torch.config import OptimizerConfig, tiny_config
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    from tests.test_torch_dpr import make_dpr_json, vocab_words
    path = make_dpr_json(root / "dpr.json")
    vocab_size = -(-len(toy_vocab(vocab_words())) // 128) * 128
    pcfg = tiny_config().retriever
    pcfg = dataclasses.replace(pcfg, encoder=dataclasses.replace(
        pcfg.encoder, vocab_size=vocab_size))
    opt = dict(lr=1e-3, warmup=0.0, weight_decay=0.1, clip_grad=0.5,
               adam_eps=1e-3)
    return {"path": path, "words": vocab_words(), "cfg": pcfg,
            "opt": OptimizerConfig(**opt), "opt_kw": opt,
            "batch": DPR_BATCH, "n_tail_dev": N_TAIL_DEV}


def _jax_dpr_task(d, mesh):
    """JAX DPRTask on the dp=2 mesh: two steps over the global batches and
    ``validate``; its initial weights go to the ranks (``d["params"]``)."""
    from emdr2_tpu.config import OptimizerConfig as JaxOptimizerConfig
    from emdr2_tpu.config import tiny_config as jax_tiny_config
    from emdr2_tpu.data.tokenizer import BertWordPieceTokenizer as JaxTok
    from emdr2_tpu.tasks.dense_retriever import DPRDataset as JaxDPRDataset
    from emdr2_tpu.tasks.dense_retriever import DPRTask as JaxDPRTask
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    tok = JaxTok(toy_vocab(d["words"]))
    jcfg = jax_tiny_config().retriever
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, vocab_size=d["cfg"].encoder.vocab_size))
    kw = dict(query_seq_len=d["cfg"].query_seq_len,
              ctx_seq_len=d["cfg"].seq_len)
    batches = list(JaxDPRDataset(d["path"], tok, hard_negs=1, **kw)
                   .epoch_batches(DPR_BATCH, seed=0))
    evald = JaxDPRDataset(d["path"], tok, evaluate=True,
                          val_av_rank_other_neg=2, val_av_rank_hard_neg=2,
                          **kw)
    jtask = JaxDPRTask(jcfg, JaxOptimizerConfig(**d["opt_kw"]), mesh,
                       total_train_iters=10, score_scaling=True)
    jtask.init(jax.random.PRNGKey(0), batches[0])
    d["params"] = params_from_jax({"retriever": unboxed_numpy(jtask.params)})
    steps = [jtask.train_step(b, jax.random.PRNGKey(i))
             for i, b in enumerate(batches[:2])]
    valid = jtask.validate(list(evald.epoch_batches(DPR_BATCH, seed=0,
                                                    shuffle=False)))
    evald.examples = evald.examples[:d["n_tail_dev"]]
    valid_tail = jtask.validate(list(evald.epoch_batches(
        DPR_BATCH, seed=0, shuffle=False, drop_last=False)))
    return {"steps": steps, "valid": valid, "valid_tail": valid_tail,
            "params": params_from_jax({"retriever":
                                       unboxed_numpy(jtask.params)})}


def _one_process_sampling(spec, tok, corpus, ds):
    """The port's sampling ``evaluate_em`` in one process at seed 5 ->
    (EM, texts)."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks import E2EQATask, e2eqa
    cfg = spec["cfg"]
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, spec["emb"],
                                          device="cpu"),
                     total_train_iters=4, device="cpu")
    task.init_state(0, state_dict=spec["params"])
    ds = copy.copy(ds)
    ds.examples = ds.examples[:N_EXAMPLES]
    rec = _Recorder(e2eqa.metric_max_over_ground_truths)
    e2eqa.metric_max_over_ground_truths = rec
    try:
        em = task.evaluate_em(ds, batch_size=B, max_decode_len=4,
                              sample=True, sample_seed=5)
    finally:
        e2eqa.metric_max_over_ground_truths = rec.fn
    return em, rec.texts


def _one_process_recall(spec, tok, corpus):
    """The port's ``evaluate_recall`` in one process, over the whole
    index."""
    from emdr2_tpu_torch.data.qa_dataset import read_qa_csv
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.evaluate import OpenRetrievalEvaluator
    from emdr2_tpu_torch.tasks import E2EQATask
    cfg = spec["cfg"]
    index = ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu")
    task = E2EQATask(cfg, tok, corpus, index, total_train_iters=4,
                     device="cpu")
    task.init_state(0, state_dict=spec["params"])
    ev = OpenRetrievalEvaluator(task.state.model, index, tok,
                                cfg.retriever.query_seq_len, batch_size=4)
    return ev.evaluate_recall(
        read_qa_csv(spec["world"]["qa"]), k=10,
        doc_text_fn=lambda pid: tok.detokenize(corpus.doc_tokens(int(pid))),
        report_at=[1, 5, 10])


@one_thread()
def _one_process_refresh(spec, tok, corpus, ds):
    """The port's refresh in one process: the rows and the search of the
    first batch after it, on one intra-op thread as the ranks run theirs
    (``one_thread``)."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training.async_refresh import SynchronousRefresher
    cfg = spec["cfg"]
    index = ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu")
    task = E2EQATask(cfg, tok, corpus, index, total_train_iters=4,
                     device="cpu")
    task.init_state(0, state_dict=spec["params"])
    builder = EvidenceIndexBuilder(cfg, task.state.model, corpus, tok.cls_id,
                                   tok.sep_id, tok.pad_id, batch_size=16)
    assert SynchronousRefresher(builder, index, 1).maybe_swap(
        1, task.state.model)
    ds = copy.copy(ds)
    ds.examples = ds.examples[:N_EXAMPLES]
    batch = next(ds.epoch_batches(B, seed=0, shuffle=False))
    q = task.state.model.embed_query(task._ids(batch.query_bert_ids)).float()
    vals, ids = index.search(q.detach(), k=cfg.index.topk)
    return index.embeddings.clone(), vals, ids


def _jax_embedding(jcfg, mesh, model, tok, corpus, params):
    """The JAX builder's rows of the whole corpus with ``params`` (fp16 on
    the host): what the ranks' first asynchronous swap must hold."""
    from emdr2_tpu.retrieval.builder import EvidenceIndexBuilder as JaxBuilder
    return JaxBuilder(jcfg, mesh, model, corpus, tok.cls_id, tok.sep_id,
                      tok.pad_id, batch_size=16).embed_corpus(params)


def _jax_references(jtask, mesh, ds, mips, dpr):
    """What the JAX package computes on the dp=2 mesh for each case."""
    ref = {}
    for quant in ("none", "int8"):
        icfg = JaxIndexConfig(embed_dim=64, dtype=jnp.float32, quantize=quant)
        index = JaxIndex(mesh, icfg, mips["rows"])
        vals, ids = index.search(jnp.asarray(mips["queries"]), k=mips["k"])
        ref[f"mips_{quant}"] = (np.asarray(vals), np.asarray(ids))

    # DPR: the global loss over the ranks' contexts in rank order, each
    # rank's queries labelled at its own positives
    q, c = jnp.asarray(dpr["q"]), jnp.asarray(dpr["c"])
    b, cr = q.shape[0] // WORLD, c.shape[0] // WORLD
    labels = jnp.concatenate([r * cr + jnp.arange(b) for r in range(WORLD)])

    def jloss(q, c):
        return jax_dpr_loss(q, c, hidden_size=16, score_scaling=True,
                            labels=labels)

    (loss, correct), grads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(q, c)
    ref["dpr"] = (float(loss), float(correct), np.asarray(grads[0]),
                  np.asarray(grads[1]))

    ds = copy.copy(ds)
    ds.examples = ds.examples[:N_EXAMPLES]
    ref["val"] = jtask.validation_loss(ds, batch_size=B, max_batches=2)
    for name, kw in (("greedy", {}), ("beam3", {"beam_size": 3})):
        rec = _Recorder(jax_metrics.metric_max_over_ground_truths)
        jax_metrics.metric_max_over_ground_truths = rec
        try:
            em = jtask.evaluate_em(ds, batch_size=B, max_decode_len=4, **kw)
        finally:
            jax_metrics.metric_max_over_ground_truths = rec.fn
        ref[f"em_{name}"] = (em, rec.texts)
    steps = []
    for batch in list(ds.epoch_batches(B, seed=0))[:2]:
        m = jtask.train_step(batch)
        steps.append({k: float(m[k]) for k in METRICS})
    ref["steps"] = steps
    ref["params"] = params_from_jax(unboxed_numpy(jtask.state.params))
    return ref


# ------------------------------------------------------------------ search

@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sharded_search_matches_jax(runs, quant):
    """Each rank's queries through ``sharded_mips_topk`` (all-gathered,
    searched on its block, merged) give the JAX mesh search's ids."""
    ref, got = runs
    want_vals, want_ids = ref[f"mips_{quant}"]
    b = NQ // WORLD
    for r, res in enumerate(got):
        vals, ids, (start, stop), held = res["mips"][quant]
        assert held == stop - start < N_ROWS          # only its block
        np.testing.assert_array_equal(ids.numpy(),
                                      want_ids[r * b:(r + 1) * b])
        np.testing.assert_allclose(vals.numpy(), want_vals[r * b:(r + 1) * b],
                                   atol=1e-6, rtol=1e-6)
    assert [res["mips"][quant][2] for res in got] == [
        (0, got[0]["mips"][quant][3]),
        (got[0]["mips"][quant][3], 2 * got[0]["mips"][quant][3])]


# ------------------------------------------------------------------- DPR

def test_dpr_loss_all_gather_matches_jax_global_loss(runs):
    """The all-gather form: the ranks' mean loss is JAX's global in-batch
    loss, and each rank's gradient over W (the mean over the group) is the
    global loss's gradient of its rows."""
    ref, got = runs
    loss, correct, gq, gc = ref["dpr"]
    b, cr = gq.shape[0] // WORLD, gc.shape[0] // WORLD
    for r, res in enumerate(got):
        d = res["dpr_loss"]
        np.testing.assert_allclose(d["loss"], loss, atol=1e-5)
        assert d["correct"] == correct
        np.testing.assert_allclose(d["grad_q"].numpy() / WORLD,
                                   gq[r * b:(r + 1) * b], atol=1e-5)
        np.testing.assert_allclose(d["grad_c"].numpy() / WORLD,
                                   gc[r * cr:(r + 1) * cr], atol=1e-5)


def test_dpr_task_steps_and_validate_match_jax_on_a_dp2_mesh(runs):
    """DPRTask on 2 ranks (each its slice: its own positives and hard
    negatives, the loss over every rank's contexts) against the JAX task
    on the dp=2 mesh: two steps' metrics, the parameters after them, and
    ``validate`` merged over the ranks."""
    ref, got = runs
    want = ref["dpr_task"]
    for res in got:
        d = res["dpr_task"]
        for g, w in zip(d["steps"], want["steps"]):
            np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-5)
            assert g["correct_prediction_count"] == \
                w["correct_prediction_count"]
        for k, v in want["params"].items():
            np.testing.assert_allclose(d["params"][k].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=k)
        assert d["valid"].keys() == want["valid"].keys()
        for k in want["valid"]:
            np.testing.assert_allclose(d["valid"][k], want["valid"][k],
                                       atol=1e-9, err_msg=k)


def test_dpr_validate_scores_a_ragged_tail_over_the_ranks(runs):
    """A dev set of 15 at a global batch of 8: the tail of 7 does not
    divide over 2 ranks; each rank pads its slice and ``validate`` drops
    the padding, so every example is scored once, as the JAX task scores
    the tail batch whole."""
    ref, got = runs
    want = ref["dpr_task"]["valid_tail"]
    for res in got:
        d = res["dpr_task"]["valid_tail"]
        assert d.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(d[k], want[k], atol=1e-9, err_msg=k)


def test_evaluate_recall_over_the_sharded_index(runs):
    """Each rank embeds and searches its slice of the questions; rank 0
    matches; every rank's recall dict equals the one-process one."""
    ref, got = runs
    for res in got:
        assert res["recall"] == ref["recall"]


# ----------------------------------------------------------------- OPENQA

def test_two_openqa_steps_match_jax_on_a_dp2_mesh(runs):
    ref, got = runs
    for res in got:
        for i, (g, w) in enumerate(zip(res["openqa"]["steps"], ref["steps"])):
            for key in METRICS:
                np.testing.assert_allclose(g[key], w[key], rtol=2e-4,
                                           atol=1e-6,
                                           err_msg=f"{key} step {i}")
        params = res["openqa"]["params"]
        for key, p in ref["params"].items():
            np.testing.assert_allclose(params[key].numpy(), p.numpy(),
                                       atol=1e-5, err_msg=key)


def test_replicas_stay_bit_equal_under_dropout(runs):
    """At dropout 0.1 the ranks draw different masks (their own rows) and
    still apply one update: parameters equal bit for bit."""
    _, got = runs
    a, b = (res["openqa"]["dropout_params"] for res in got)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert got[0]["openqa"]["dropout_steps"] == got[1]["openqa"][
        "dropout_steps"]
    assert all(np.isfinite(v) for s in got[0]["openqa"]["dropout_steps"]
               for v in s.values())


def test_validation_loss_matches_jax(runs):
    ref, got = runs
    for res in got:
        for key, want in ref["val"].items():
            np.testing.assert_allclose(res["openqa"]["val"][key], want,
                                       rtol=2e-4, err_msg=key)


@pytest.mark.parametrize("mode", ["greedy", "beam3"])
def test_evaluate_em_matches_jax(runs, mode):
    ref, got = runs
    (want_em, want_texts) = ref[f"em_{mode}"]
    ems = [res["openqa"][f"em_{mode}"][0] for res in got]
    assert ems[0] == ems[1] == want_em
    assert want_em[1] == N_EXAMPLES
    batches = -(-N_EXAMPLES // B)
    texts = _texts_by_row([res["openqa"][f"em_{mode}"][1] for res in got],
                          batches)
    assert texts == want_texts


# ------------------------------------------------------ engine and refresh

def test_engine_save_and_restore_across_ranks(runs):
    """engine.train on 2 ranks: rank 0 alone writes the checkpoint; every
    rank restores it bit for bit; two more iterations under the
    prefetcher of a data-parallel rank keep the replicas bit-equal."""
    _, got = runs
    e0, e1 = (res["engine"] for res in got)
    # the interval save at 2 and the final save, both by rank 0
    assert e0["writes"] == [2, 2] and e1["writes"] == []
    assert e0["who"] == [0, 2, True] and e1["who"] == [1, 2, False]
    for e in (e0, e1):
        assert e["iteration"] == 2 and e["step"] == (2, 2)
        assert e["params_equal"] and e["adam_equal"]
        assert e["prefetched"] == 4
    assert all(torch.equal(e0["params"][k], e1["params"][k])
               for k in e0["params"])
    a, b = e0["prefetched_params"], e1["prefetched_params"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], e0["params"][k]) for k in a)


def test_refresh_under_dp_embeds_each_ranks_rows(runs):
    """Each rank embeds its own row range and swaps it in; the search after
    the swap equals the one-process refresh's; the asynchronous refresher
    over the same group swaps in the same rows (fp16 host rows made on its
    thread: 1e-3). Rows and scores are fp32 products of another process
    (summation order: rtol 1e-5); a rank's rows taken from another range
    would differ by O(1)."""
    ref, got = runs
    rows, vals, ids = ref["refresh"]
    per = B // WORLD
    for r, res in enumerate(got):
        f = res["refresh"]
        start, stop = f["row_range"]
        assert f["swapped"] and stop - start < rows.shape[0]
        real = min(stop, rows.shape[0]) - start
        np.testing.assert_allclose(f["rows"][:real].numpy(),
                                   rows[start:start + real].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(f["ids"], ids[r * per:(r + 1) * per])
        np.testing.assert_allclose(f["vals"].numpy(),
                                   vals[r * per:(r + 1) * per].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert f["async_swapped"]
        np.testing.assert_allclose(f["async_rows"].numpy(),
                                   f["rows"].numpy(), atol=1e-3)


# ------------------------------------------- the embedder group and prefetch

def test_embedder_layout_and_its_refusals():
    """``parallel.mesh``: rank r trains on card r, its embedder on the
    cards after the trainers' (E/dp of its own, or one that dp/E ranks
    share), never a trainer's; a count that does not divide and too few
    cards are refused by name, and --tp 2 is taken over twice the
    processes (its trainers on cards 0..dp*tp-1, the embedders after
    them); on the CPU the layout's devices are the host, and without an
    embedder group the trainer's card."""
    from emdr2_tpu_torch.config import MeshConfig as Mesh
    from emdr2_tpu_torch.parallel import check_mesh_config, embed_devices
    layouts = {(8, 8): [[8 + r] for r in range(8)],
               (2, 4): [[2, 3], [4, 5]],
               (4, 2): [[4], [4], [5], [5]],
               (2, 1): [[2], [2]],
               (2, 0): [[0], [1]]}
    for (dp, e), want in layouts.items():
        mesh = Mesh(dp=dp, embed_devices=e)
        check_mesh_config(mesh, dp, n_cards=dp + e)
        got = [[d.index for d in embed_devices(mesh, r,
                                               torch.device("cuda", r))]
               for r in range(dp)]
        assert got == want
        if e:
            assert all(i >= dp for cards in got for i in cards)
    cpu = torch.device("cpu")
    assert embed_devices(Mesh(dp=2, embed_devices=4), 1, cpu) == [cpu, cpu]
    assert embed_devices(Mesh(dp=2), 1, cpu) == [cpu]
    with pytest.raises(ValueError, match="does not divide"):
        check_mesh_config(Mesh(dp=2, embed_devices=3), 2)
    with pytest.raises(ValueError, match="does not divide"):
        check_mesh_config(Mesh(dp=4, embed_devices=6), 4, n_cards=10)
    with pytest.raises(ValueError, match="needs dp \\+ embed-devices = 4"):
        check_mesh_config(Mesh(dp=2, embed_devices=2), 2, n_cards=3)
    check_mesh_config(Mesh(dp=2, tp=2, embed_devices=2), 4, n_cards=6)
    assert [[d.index for d in embed_devices(
        Mesh(dp=2, tp=2, embed_devices=2), r, torch.device("cuda", r))]
        for r in range(4)] == [[4], [4], [5], [5]]
    with pytest.raises(ValueError, match="needs 4 processes"):
        check_mesh_config(Mesh(dp=2, tp=2), 2)
    check_mesh_config(Mesh(dp=2, embed_devices=2), 2)      # CPU: no count


def test_first_async_swap_holds_the_handed_over_weights_rows(runs):
    """(a) At --dp 2 --embed-devices 2 each rank's embedder embeds its own
    block (zero-copy, on its embedder device) with the weights handed over
    at ``start``: after the first swap the rank's block equals the JAX
    builder's rows of those weights (fp16 host rows: atol 1e-3)."""
    ref, got = runs
    want = ref["embedder"].astype(np.float32)
    n = want.shape[0]
    blocks = []
    for r, res in enumerate(got):
        e = res["embedder"]
        assert e["devices"] == ["cpu"] and e["zero_copy"]
        start, stop = e["row_range"]
        real = max(0, min(stop, n) - start)
        rows = e["first_rows"].float().numpy()
        assert rows.shape[0] == stop - start < n
        np.testing.assert_allclose(rows[:real], want[start:start + real],
                                   atol=1e-3)
        blocks.append(rows[:real])
    np.testing.assert_allclose(np.concatenate(blocks), want, atol=1e-3)


def test_ranks_swap_together_when_the_last_block_is_ready(runs):
    """(b) Rank 1's embedder held back until its iteration 3: rank 0's
    block is ready from iteration 1 on, and still no rank swaps before
    both are ready; both swap at iteration 3, and every later swap at one
    iteration on both ranks. The replicas stay bit-equal and the losses
    finite, prefetching at depth 1 throughout."""
    _, got = runs
    c0, c1 = (res["embedder"]["calls"] for res in got)
    assert [c[0] for c in c0] == [c[0] for c in c1] == list(range(5))
    for (step, ready0, swapped0), (_, ready1, swapped1) in zip(c0, c1):
        assert swapped0 == swapped1, (c0, c1)
        if swapped0:
            assert ready0 and ready1
    assert [c[1] for c in c0[1:3]] == [True, True]
    assert [c[1] for c in c1[1:3]] == [False, False]
    assert not any(c[2] for c in c0[:3])
    e0, e1 = (res["embedder"] for res in got)
    assert e0["first_step"] == e1["first_step"] == 3
    assert e0["refresh_count"] == e1["refresh_count"] >= 1
    assert e0["final"] == e1["final"] == 5
    assert e0["losses"] == e1["losses"] and len(e0["losses"]) == 5
    assert all(np.isfinite(v) for v in e0["losses"])
    assert all(torch.equal(e0["params"][k], e1["params"][k])
               for k in e0["params"])


def test_frozen_retriever_prefetch_under_dp_equals_plain_run(runs):
    """(c) With the query tower frozen, stale selection is the same
    selection: three iterations at dp 2 under the prefetcher of a
    data-parallel rank (depth 1) log what the plain dp 2 run logs, bit for
    bit (the rule of test_torch_prefetch.py's frozen-retriever test)."""
    _, got = runs
    for res in got:
        plain, prefetched = res["prefetch"][0], res["prefetch"][1]
        assert len(plain) == len(prefetched) == 3
        assert plain == prefetched
    assert got[0]["prefetch"] == got[1]["prefetch"]


# ------------------------------------------------------------ command line

CLI_MODEL = ["--hidden-size", "32", "--num-layers", "1",
             "--num-attention-heads", "2", "--ffn-hidden-size", "64",
             "--seq-length-ret", "24", "--seq-length-query", "16",
             "--fid-flash-attention", "--device", "cpu"]
CLI_TASK = ["--topk-retrievals", "2", "--batch-size", "4",
            "--seq-length", "48", "--seq-length-dec", "8",
            "--max-decode-len", "4"]


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    from emdr2_tpu_torch.tools.build_evidence import build
    from emdr2_tpu_torch.tools.create_doc_index import main as build_index
    d = tmp_path_factory.mktemp("cli_dp")
    words = [f"item{i}" for i in range(16)] + [
        "red", "blue", "color", "of", "is", "what", "the"]
    (d / "vocab.txt").write_text("\n".join(toy_vocab(words)) + "\n")
    colors = ["red", "blue"]
    rows = ["id\ttext\ttitle"] + [
        f"{i + 1}\tthe color of item{i} is {colors[i % 2]}\titem{i // 2}"
        for i in range(16)]
    (d / "evidence.tsv").write_text("\n".join(rows) + "\n")
    (d / "qa.csv").write_text("\n".join(
        f"what is the color of item{i}\t['{colors[i % 2]}']"
        for i in range(16)) + "\n")
    assert build(str(d / "evidence.tsv"), str(d / "wiki"),
                 str(d / "vocab.txt"), workers=1) == 16
    assert build_index(["--evidence-data-path", str(d / "wiki"),
                        "--vocab-file", str(d / "vocab.txt"),
                        "--embedding-path", str(d / "emb"),
                        "--batch-size", "8"] + CLI_MODEL) == 0
    return d


def _cli_data(d):
    return ["--vocab-file", str(d / "vocab.txt"),
            "--train-data", str(d / "qa.csv"),
            "--valid-data", str(d / "qa.csv"),
            "--evidence-data-path", str(d / "wiki"),
            "--embedding-path", str(d / "emb")]


def test_cli_runs_two_processes(cli_dir):
    """``tasks.run --num-processes 2 --process-id i --coordinator-address``:
    both ranks run 2 iterations (16 questions, 4 a rank, global batch 8)
    with rc 0; rank 0 alone prints and writes the checkpoint."""
    d = cli_dir
    env = dict(os.environ, OMP_NUM_THREADS="2")
    args = (["--task", "OPENQA", "--save", str(d / "run"), "--epochs", "1",
             "--log-interval", "1", "--save-interval", "1",
             "--eval-interval", "100", "--dp", "2", "--num-processes", "2",
             "--coordinator-address", f"file://{d / 'store'}"]
            + _cli_data(d) + CLI_TASK + CLI_MODEL)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "emdr2_tpu_torch.tasks.run"] + args
        + ["--process-id", str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    assert "iteration        2/2" in logs[0]
    assert "final (2 iters) | valid EM" in logs[0] and "over 16" in logs[0]
    assert "iteration" not in logs[1]
    from emdr2_tpu_torch.training.checkpointing import latest_iteration
    assert latest_iteration(str(d / "run")) == 2


@pytest.mark.parametrize("flags,item", [
    (["--tp", "3"], "tensor parallelism"),
    (["--dp", "2", "--embed-devices", "3"], "does not divide"),
    (["--dp", "2"], "needs 2 processes"),
])
def test_cli_refuses_layouts_it_does_not_port(cli_dir, flags, item):
    from emdr2_tpu_torch.tasks.run import main as run_task
    with pytest.raises((NotImplementedError, ValueError)) as err:
        run_task(["--task", "OPENQA"] + flags + _cli_data(cli_dir)
                 + CLI_TASK + CLI_MODEL)
    assert item in str(err.value)
    if "--dp" not in flags:
        assert "--tp 3 does not divide num_heads 2" in str(err.value)


# ------------------------------------------------------ the dropout rule

def _one_hot_value_slab(B, L, nh, hd):
    """A qkv slab whose q and k are 0 (uniform attention) and whose value
    of key j in each head is the unit vector e_j: output column j of a head
    is then keep(i, j) / (L * (1 - rate)), so the attention-dropout mask
    is ``out != 0``, exactly."""
    H = nh * hd
    slab = np.zeros((B, L, 3 * H), np.float32)
    for h in range(nh):
        for j in range(L):
            slab[:, j, 2 * H + h * hd + j] = 1.0
    return slab


def test_attention_kernels_fold_the_seed_by_rank():
    """K0 under data parallelism: rank r's attention kernels hash local
    (batch*head) indices with seed + r * 0x9E3779B1, bit for bit the masks
    of the JAX kernel shard_mapped over a dp=2 mesh (``_shard_seed``);
    rank 1 with the unfolded seed would draw other masks."""
    from emdr2_tpu.ops.fid_attention import flash_self_attention_sharded
    from emdr2_tpu_torch.ops.fid_attention import flash_self_attention
    from emdr2_tpu_torch.ops.hashing import shard_seed
    B, L, nh, hd, rate, seed = 4, 16, 2, 16, 0.3, 0x12345678
    slab = _one_hot_value_slab(B, L, nh, hd)
    bias = np.zeros((B, L), np.float32)
    mesh = build_mesh(MeshConfig(dp=WORLD, tp=1))
    want = np.asarray(flash_self_attention_sharded(
        jnp.asarray(slab.reshape(B, L, 3, nh * hd)), jnp.asarray(bias),
        jnp.uint32(seed), nh, mesh, dropout_rate=rate)) != 0
    per = B // WORLD
    for r in range(WORLD):
        rows = slice(r * per, (r + 1) * per)
        got = flash_self_attention(torch.as_tensor(slab[rows]),
                                   torch.as_tensor(bias[rows]), nh,
                                   shard_seed(seed, r), rate).numpy() != 0
        np.testing.assert_array_equal(got, want[rows])
    unfolded = flash_self_attention(torch.as_tensor(slab[per:]),
                                    torch.as_tensor(bias[per:]), nh, seed,
                                    rate).numpy() != 0
    assert not np.array_equal(unfolded, want[per:])
    assert 0.5 < want.mean() < 0.9


def test_hidden_dropout_hashes_global_rows():
    """``PackedDropout`` under GSPMD hashes global element coordinates, so
    rank r offsets its rows by r * (its rows): bit for bit the JAX mask of
    the module jitted over a dp=2 mesh, and the one-process mask of the
    whole batch; without the offset rank 1 would repeat rank 0's mask."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from emdr2_tpu.models.layers import PackedDropout
    from emdr2_tpu.ops.hashing import MIX_PRIMES
    from emdr2_tpu_torch.ops.hashing import packed_dropout
    B, L, H, rate = 4, 8, 16, 0.3
    key = jax.random.PRNGKey(3)

    class KeyProbe(nn.Module):
        """The key ``PackedDropout`` draws at the top of an apply."""

        @nn.compact
        def __call__(self):
            return self.make_rng("dropout")

    kd = KeyProbe().apply({}, rngs={"dropout": key})
    if jnp.issubdtype(kd.dtype, jax.dtypes.prng_key):
        kd = jax.random.key_data(kd)
    words = [int(w) for w in np.asarray(kd, np.uint32).reshape(-1)]
    seed = words[0]
    for w in words[1:]:
        seed = ((seed * MIX_PRIMES[0]) & 0xFFFFFFFF) ^ w

    mesh = build_mesh(MeshConfig(dp=WORLD, tp=1))
    x = jax.device_put(jnp.ones((B, L, H), jnp.float32),
                       NamedSharding(mesh, P("dp")))
    drop = jax.jit(lambda x: PackedDropout(rate).apply(
        {}, x, deterministic=False, rngs={"dropout": key}))
    want = np.asarray(drop(x)) != 0
    ones = torch.ones(B, L, H)
    whole = packed_dropout(ones, rate, seed).numpy() != 0
    np.testing.assert_array_equal(whole, want)
    per = B // WORLD
    for r in range(WORLD):
        got = packed_dropout(ones[:per], rate, seed,
                             row_offset=r * per).numpy() != 0
        np.testing.assert_array_equal(got, want[r * per:(r + 1) * per])
    no_offset = packed_dropout(ones[:per], rate, seed).numpy() != 0
    assert not np.array_equal(no_offset, want[per:])


def test_sampling_takes_rank_0s_seed_and_global_rows(runs):
    """Sampling under data parallelism: rank 0's ``sample_seed`` (rank 1
    passes another, which is overridden) and one uniform a global row a
    step: the ranks' tokens are those of the one-process run."""
    ref, got = runs
    want_em, want_texts = ref["sample"]
    batches = -(-N_EXAMPLES // B)
    texts = _texts_by_row([res["openqa"]["em_sample"][1] for res in got],
                          batches)
    assert texts == want_texts
    assert all(res["openqa"]["em_sample"][0] == want_em for res in got)


# ------------------------------------------------------ the C5 repair (CPU)

def test_lookup_gradient_equals_f_embedding_and_restores_the_mode():
    """``layers.embedding``: the forward and the weight gradient of
    ``F.embedding``; PyTorch's deterministic mode is on only inside its
    backward and back as it was after it."""
    from emdr2_tpu_torch.models.layers import embedding
    rng = np.random.RandomState(3)
    ids = torch.as_tensor(rng.randint(0, 5, size=(64, 7)))
    w0 = torch.tensor(rng.randn(5, 6).astype(np.float32))
    dout = torch.tensor(rng.randn(64, 7, 6).astype(np.float32))
    w1, w2 = w0.clone().requires_grad_(), w0.clone().requires_grad_()
    out = embedding(ids, w1)
    want = torch.nn.functional.embedding(ids, w2)
    assert torch.equal(out, want)
    out.backward(dout)
    want.backward(dout)
    np.testing.assert_allclose(w1.grad.numpy(), w2.grad.numpy(), atol=1e-6)
    assert not torch.are_deterministic_algorithms_enabled()


def test_retriever_cli_runs_two_processes(tmp_path):
    """``tasks.run --task RETRIEVER`` in two processes: 4 iterations at 2
    a rank, validation over both ranks (a dev set whose tail batch does
    not divide over them), the post-train index embedded by
    row range (rank 1's block holds padding only) and its recall; rank 0
    alone prints and writes the checkpoint and the embedding store."""
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    from emdr2_tpu_torch.retrieval import EmbeddingStore
    from emdr2_tpu_torch.tools.build_evidence import build
    from emdr2_tpu_torch.training.checkpointing import latest_iteration
    from tests.test_torch_dpr import make_dpr_json, vocab_words
    d = tmp_path
    (d / "vocab.txt").write_text("\n".join(toy_vocab(vocab_words())) + "\n")
    make_dpr_json(d / "train.json")
    # 7 questions at a global batch of 4: the tail of 3 does not divide
    make_dpr_json(d / "valid.json", n=7, offset=16)
    (d / "evidence.tsv").write_text("\n".join(
        ["id\ttext\ttitle"] + [f"{i + 1}\titem{i} is thing{i}\titem{i}"
                               for i in range(24)]) + "\n")
    assert build(str(d / "evidence.tsv"), str(d / "wiki"),
                 str(d / "vocab.txt"), workers=1) == 24
    (d / "dev.csv").write_text("".join(
        f"what is item{i}\t['thing{i}']\n" for i in range(8)))
    args = ["--task", "RETRIEVER", "--vocab-file", str(d / "vocab.txt"),
            "--train-data", str(d / "train.json"),
            "--valid-data", str(d / "valid.json"),
            "--evidence-data-path", str(d / "wiki"),
            "--qa-file-dev", str(d / "dev.csv"),
            "--embedding-path", str(d / "emb"), "--save", str(d / "dpr"),
            "--batch-size", "2", "--dp", "2", "--train-iters", "4",
            "--epochs", "1", "--log-interval", "1", "--save-interval", "2",
            "--val-av-rank-other-neg", "1", "--val-av-rank-hard-neg", "1",
            "--report-topk-accuracies", "1", "5", "10",
            "--num-processes", "2",
            "--coordinator-address", f"file://{d / 'store'}"] + CLI_MODEL[
                :CLI_MODEL.index("--fid-flash-attention")] + [
                "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "emdr2_tpu_torch.tasks.run"] + args
        + ["--process-id", str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, cwd=root) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    assert "iteration        4/4" in logs[0] and "epoch 0" in logs[0]
    assert "DEV retrieval" in logs[0] and "recall@10" in logs[0]
    assert "iteration" not in logs[1] and "DEV" not in logs[1]
    assert latest_iteration(str(d / "dpr")) == 4
    assert len(EmbeddingStore.load(str(d / "emb")).ids) == 24


def test_rendezvous_failure_and_a_missing_nccl_raise(tmp_path):
    """No fallback: a rank whose peers never come raises after its
    timeout; NCCL asked for where PyTorch has none raises."""
    from emdr2_tpu_torch.parallel import distributed as dist_lib
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            dist_lib.init_process_group(f"file://{tmp_path / 'nccl'}", 1, 0,
                                        "nccl", device="cuda")
    with pytest.raises(Exception) as err:
        dist_lib.init_process_group(f"file://{tmp_path / 'alone'}", 2, 0,
                                    "gloo", timeout_s=3)
    assert not torch.distributed.is_initialized()
    assert "time" in str(err.value).lower() or "wait" in str(
        err.value).lower(), str(err.value)
