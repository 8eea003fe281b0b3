"""The RETRIEVER task of the port against the JAX package (CPU, fp32,
dropout 0 where the two are compared): ``dpr_in_batch_loss`` (loss,
``correct`` and gradients at 1e-5), ``DPRDataset`` (identical train and
30+30 eval batches for the same seed), ``DPRTask`` (two steps from the same
converted weights: losses and parameters at 1e-5; ``validate``: the same
average rank and top-k), its checkpoints (the dual encoder under
``retriever.``, read by ``load_retriever_params``), and the command line
``tasks.run --task RETRIEVER --device cpu`` end to end: training with
interval and end-of-epoch saves, validation, the post-train recall, a
resume from ``--load`` equal bit for bit to the uninterrupted run, and
``--eval-only``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import MeshConfig  # noqa: E402
from emdr2_tpu.config import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from emdr2_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from emdr2_tpu.data.tokenizer import (  # noqa: E402
    BertWordPieceTokenizer as JaxTokenizer,
)
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.tasks.dense_retriever import (  # noqa: E402
    DPRDataset as JaxDPRDataset,
    DPRTask as JaxDPRTask,
)
from emdr2_tpu.training.losses import (  # noqa: E402
    dpr_in_batch_loss as jax_dpr_loss,
)
from emdr2_tpu_torch.config import OptimizerConfig, tiny_config  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.data.tokenizer import (  # noqa: E402
    BertWordPieceTokenizer,
    toy_vocab,
)
from emdr2_tpu_torch.models import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.tasks.dense_retriever import (  # noqa: E402
    DPRDataset,
    DPRTask,
    read_dpr_json,
)
from emdr2_tpu_torch.tasks.run import main as run_task  # noqa: E402
from emdr2_tpu_torch.tools.build_evidence import build  # noqa: E402
from emdr2_tpu_torch.training import checkpointing as ck  # noqa: E402
from emdr2_tpu_torch.training.losses import dpr_in_batch_loss  # noqa: E402
from tests.test_torch_models import unboxed_numpy  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-5
N_ITEMS = 16


def make_dpr_json(path, n=N_ITEMS, offset=0, extra_negs=False):
    """DPR-format rows about item<i>; with ``extra_negs`` some rows have
    no hard negative and two easy ones (the easy-negative fill), others
    three hard ones (the shuffle)."""
    rows = []
    for i in range(offset, offset + n):
        j = (i + 1) % (offset + n)
        hard = [{"title": f"item{j}", "text": f"item{j} is thing{j}"}]
        easy = [{"title": "x", "text": "unrelated text"}]
        if extra_negs and i % 3 == 0:
            hard, easy = [], easy + [{"title": "y", "text": "other words"}]
        elif extra_negs and i % 3 == 1:
            hard = hard + [{"title": f"item{i}", "text": "red blue"},
                           {"title": "z", "text": f"thing{j} item{i}"}]
        rows.append({"question": f"what is item{i}",
                     "answers": [f"thing{i}"],
                     "positive_ctxs": [{"title": f"item{i}",
                                        "text": f"item{i} is thing{i}"}],
                     "hard_negative_ctxs": hard, "negative_ctxs": easy})
    path.write_text(json.dumps(rows))
    return str(path)


def vocab_words():
    return ([f"item{i}" for i in range(32)] + [f"thing{i}" for i in range(32)]
            + ["what", "is", "unrelated", "text", "other", "words", "red",
               "blue", "x", "y", "z", "the", "color", "of"])


@pytest.fixture(scope="module")
def toks():
    vocab = toy_vocab(vocab_words())
    return BertWordPieceTokenizer(vocab), JaxTokenizer(vocab)


# ------------------------------------------------------------------ the loss

@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("labels", [None, [1, 0, 2]])
def test_dpr_in_batch_loss_matches_jax(scaling, labels):
    rng = np.random.RandomState(0)
    q = rng.randn(3, 16).astype(np.float32)
    c = rng.randn(6, 16).astype(np.float32)       # positives + hard negs
    jl = None if labels is None else jnp.asarray(labels)

    def jloss(q, c):
        return jax_dpr_loss(q, c, hidden_size=16, score_scaling=scaling,
                            labels=jl)

    (want, want_correct), (gq, gc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(q), jnp.asarray(c))
    tq = torch.tensor(q, requires_grad=True)
    tc = torch.tensor(c, requires_grad=True)
    loss, correct = dpr_in_batch_loss(
        tq, tc, hidden_size=16, score_scaling=scaling,
        labels=None if labels is None else torch.tensor(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), atol=ATOL)
    assert correct.dtype == torch.float32
    assert correct.item() == float(want_correct)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), atol=ATOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), atol=ATOL)


def test_dpr_loss_all_gather_form_waits_for_multi_gpu():
    """The all-gather form is ported: it takes the data-parallel group as
    ``dp`` (the JAX ``axis_name`` keyword is not the port's), and a
    one-process group gives the plain loss. Two ranks against the JAX
    global loss: tests/test_torch_parallel.py."""
    from emdr2_tpu_torch.parallel import DataParallel
    rng = np.random.RandomState(1)
    q = torch.tensor(rng.randn(3, 8).astype(np.float32))
    c = torch.tensor(rng.randn(6, 8).astype(np.float32))
    with pytest.raises(TypeError):
        dpr_in_batch_loss(q, c, hidden_size=8, axis_name="dp")
    want = dpr_in_batch_loss(q, c, hidden_size=8, score_scaling=True)
    got = dpr_in_batch_loss(q, c, hidden_size=8, score_scaling=True,
                            dp=DataParallel.local())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------------- the dataset

@pytest.mark.parametrize("evaluate", [False, True])
def test_dataset_batches_match_jax(tmp_path, toks, evaluate):
    path = make_dpr_json(tmp_path / "dpr.json", extra_negs=True)
    kw = dict(query_seq_len=16, ctx_seq_len=24, hard_negs=2, seed=7,
              evaluate=evaluate, val_av_rank_other_neg=2,
              val_av_rank_hard_neg=2)
    ds, jds = DPRDataset(path, toks[0], **kw), JaxDPRDataset(path, toks[1],
                                                             **kw)
    assert len(ds) == len(jds) == N_ITEMS
    for epoch in range(2):
        for b, jb in zip(ds.epoch_batches(5, seed=epoch, drop_last=False),
                         jds.epoch_batches(5, seed=epoch, drop_last=False)):
            for name in b._fields:
                np.testing.assert_array_equal(getattr(b, name),
                                              getattr(jb, name), err_msg=name)
    rows = 5 * (1 + (4 if evaluate else 2))
    assert b.ctx_ids.shape[0] == (N_ITEMS % 5) * rows // 5


def test_read_dpr_json_drops_rows_without_positives(tmp_path):
    p = tmp_path / "d.json"
    p.write_text(json.dumps([
        {"question": "q", "answers": [], "positive_ctxs": []},
        {"question": "q2", "answers": [], "positive_ctxs":
            [{"title": "t", "text": "x"}]}]))
    assert [e.question for e in read_dpr_json(str(p))] == ["q2"]


# ------------------------------------------------------------------ the task

@pytest.fixture(scope="module")
def tasks(tmp_path_factory, toks):
    """(port DPRTask, JAX DPRTask, train batches, eval batches) from the
    same converted weights."""
    d = tmp_path_factory.mktemp("dpr")
    path = make_dpr_json(d / "dpr.json", extra_negs=True)
    jcfg = jax_tiny_config().retriever
    enc = dataclasses.replace(jcfg.encoder,
                              vocab_size=toks[0].padded_vocab_size)
    jcfg = dataclasses.replace(jcfg, encoder=enc)
    pcfg = tiny_config().retriever
    pcfg = dataclasses.replace(pcfg, encoder=dataclasses.replace(
        pcfg.encoder, vocab_size=toks[0].padded_vocab_size))
    kw = dict(query_seq_len=pcfg.query_seq_len, ctx_seq_len=pcfg.seq_len)
    train = JaxDPRDataset(path, toks[1], hard_negs=1, **kw)
    batches = list(train.epoch_batches(8, seed=0))
    evald = JaxDPRDataset(path, toks[1], evaluate=True,
                          val_av_rank_other_neg=2, val_av_rank_hard_neg=2,
                          **kw)
    eval_batches = list(evald.epoch_batches(8, seed=0, shuffle=False))
    # Adam's eps raised to 1e-3 on both sides, as in
    # tests/test_torch_e2e_train.py: its first steps divide g by |g| + eps,
    # which turns summation-order noise on near-zero gradients into
    # lr-sized differences when eps is 1e-8
    opt = dict(lr=1e-3, warmup=0.0, weight_decay=0.1, clip_grad=0.5,
               adam_eps=1e-3)
    jtask = JaxDPRTask(jcfg, JaxOptimizerConfig(**opt),
                       build_mesh(MeshConfig(dp=1, tp=1)),
                       total_train_iters=10, score_scaling=True)
    jtask.init(jax.random.PRNGKey(0), batches[0])
    task = DPRTask(pcfg, OptimizerConfig(**opt), total_train_iters=10,
                   score_scaling=True, device="cpu")
    task.init_state(0, state_dict=params_from_jax(
        {"retriever": unboxed_numpy(jtask.params)}))
    return task, jtask, batches, eval_batches


def test_two_train_steps_match_jax(tasks):
    task, jtask, batches, _ = tasks
    assert task.state.step == 0
    for i, batch in enumerate(batches[:2]):
        want = jtask.train_step(batch, jax.random.PRNGKey(i))
        got = task.train_step(batch)
        np.testing.assert_allclose(float(got["loss"]), want["loss"],
                                   atol=ATOL)
        assert float(got["correct_prediction_count"]) == \
            want["correct_prediction_count"]
        assert float(got["grad_norm"]) > 0
    assert task.state.step == jtask.step == 2
    want = params_from_jax({"retriever": unboxed_numpy(jtask.params)})
    got = task.model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=ATOL,
                                   err_msg=k)


def test_validate_matches_jax(tasks):
    task, jtask, _, eval_batches = tasks
    assert eval_batches[0].ctx_ids.shape[0] == 8 * (1 + 4)
    got = task.validate(eval_batches)
    want = jtask.validate(eval_batches)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, err_msg=k)


def test_checkpoint_nests_the_dual_encoder_under_retriever(tasks, tmp_path):
    """A DPR checkpoint restores into a fresh task bit for bit and hands its
    dual encoder to an EMDR2 model through ``load_retriever_params``."""
    task, _, batches, _ = tasks
    root = str(tmp_path / "ck")
    ck.save_checkpoint(root, task.get_state(), task.state.step)
    fresh = DPRTask(task.cfg, task.opt_cfg, total_train_iters=10,
                    device="cpu")
    fresh.init_state(5)
    _, it = ck.load_checkpoint(root, fresh.get_state())
    assert it == task.state.step == fresh.state.step
    for k, v in task.model.state_dict().items():
        assert k.startswith("retriever.")
        assert torch.equal(v, fresh.model.state_dict()[k]), k
    a = task.train_step(batches[0])
    b = fresh.train_step(batches[0])
    assert torch.equal(a["loss"], b["loss"])
    cfg = tiny_config()
    cfg = cfg.replace(retriever=task.cfg)
    emdr2 = EMDR2Model(cfg, device="cpu")
    ck.load_retriever_params(root, emdr2.retriever)
    for k, v in emdr2.retriever.state_dict().items():
        assert torch.equal(v, ck.read_payload(root)[0]["model"][
            "retriever." + k]), k


# --------------------------------------------------------- the command line

MODEL_ARGS = ["--hidden-size", "32", "--num-layers", "1",
              "--num-attention-heads", "2", "--ffn-hidden-size", "64",
              "--seq-length-ret", "24", "--seq-length-query", "16",
              "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("retriever_cli")
    (d / "vocab.txt").write_text("\n".join(toy_vocab(vocab_words())) + "\n")
    make_dpr_json(d / "train.json")
    make_dpr_json(d / "valid.json", n=8, offset=16)
    rows = ["id\ttext\ttitle"] + [f"{i + 1}\titem{i} is thing{i}\titem{i}"
                                  for i in range(24)]
    (d / "evidence.tsv").write_text("\n".join(rows) + "\n")
    assert build(str(d / "evidence.tsv"), str(d / "wiki"),
                 str(d / "vocab.txt"), workers=1) == 24
    (d / "dev.csv").write_text("".join(
        f"what is item{i}\t['thing{i}']\n" for i in range(8)))
    return d


def _cli(d, save, *extra):
    return ["--task", "RETRIEVER", "--vocab-file", str(d / "vocab.txt"),
            "--train-data", str(d / "train.json"),
            "--valid-data", str(d / "valid.json"),
            "--evidence-data-path", str(d / "wiki"),
            "--qa-file-dev", str(d / "dev.csv"),
            "--embedding-path", str(d / f"emb_{save}"),
            "--save", str(d / save), "--batch-size", "4",
            "--train-iters", "12", "--log-interval", "1",
            "--save-interval", "3", "--val-av-rank-other-neg", "1",
            "--val-av-rank-hard-neg", "1",
            "--report-topk-accuracies", "1", "5", "10", *MODEL_ARGS, *extra]


def test_retriever_cli_trains_validates_saves_and_evaluates(cli_world,
                                                            capsys):
    d = cli_world
    assert run_task(_cli(d, "full", "--epochs", "3")) == 0
    out = capsys.readouterr().out
    assert "iteration       12/12" in out
    assert [line.split("|")[0].strip() for line in out.splitlines()
            if line.startswith(" epoch")] == ["epoch 0", "epoch 1",
                                              "epoch 2"]
    assert "average_rank" in out and "top1_accuracy" in out
    dev = [line for line in out.splitlines() if "DEV retrieval" in line]
    assert len(dev) == 1 and "recall@10" in dev[0], out
    assert ck.latest_iteration(str(d / "full")) == 12
    payload, _ = ck.read_payload(str(d / "full"))
    assert payload["step"] == 12
    assert all(k.startswith("retriever.") for k in payload["model"])


def test_retriever_cli_resume_equals_the_uninterrupted_run(cli_world,
                                                           capsys):
    """Two epochs, then a resume from --load for the third: the same final
    parameters and optimizer state as three epochs in one run."""
    d = cli_world
    if ck.latest_iteration(str(d / "full")) != 12:
        assert run_task(_cli(d, "full", "--epochs", "3")) == 0
    assert run_task(_cli(d, "part", "--epochs", "2")) == 0
    assert ck.latest_iteration(str(d / "part")) == 8
    capsys.readouterr()
    assert run_task(_cli(d, "part", "--epochs", "3", "--load",
                         str(d / "part"))) == 0
    out = capsys.readouterr().out
    assert "resumed retriever from" in out and "at iteration 8" in out
    assert "iteration        9/12" in out
    full, _ = ck.read_payload(str(d / "full"))
    part, _ = ck.read_payload(str(d / "part"))
    assert part["step"] == full["step"] == 12
    for k, v in full["model"].items():
        assert torch.equal(v, part["model"][k]), k
    for s_full, s_part in zip(full["optimizer"]["state"].values(),
                              part["optimizer"]["state"].values()):
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s_full[name], s_part[name])


def test_evaluate_retrieval_tool_reports_the_runs_recall(cli_world, capsys):
    """``tools.evaluate_retrieval`` over the store the RETRIEVER run built,
    with the run's retriever extracted by ``checkpoint_surgery``: the same
    recall as the run's post-train evaluation."""
    from emdr2_tpu_torch.tools import checkpoint_surgery, evaluate_retrieval
    d = cli_world
    if ck.latest_iteration(str(d / "full")) != 12:
        assert run_task(_cli(d, "full", "--epochs", "3")) == 0
    capsys.readouterr()
    assert run_task(_cli(d, "full", "--epochs", "3", "--load",
                         str(d / "full"), "--eval-only")) == 0
    dev = next(line for line in capsys.readouterr().out.splitlines()
               if "DEV retrieval" in line)
    want = {kv.split()[0]: float(kv.split()[1])
            for kv in dev.split("|")[1:]}
    assert checkpoint_surgery.main([
        "extract", "--load", str(d / "full"), "--submodel", "retriever",
        "--save", str(d / "extracted")]) == 0
    capsys.readouterr()
    assert evaluate_retrieval.main([
        "--qa-data", str(d / "dev.csv"), "--evidence-data-path",
        str(d / "wiki"), "--embedding-path", str(d / "emb_full"),
        "--vocab-file", str(d / "vocab.txt"), "--load",
        str(d / "extracted"), "--topk", "100",
        "--report-topk-accuracies", "1", "5", "10",
        *[a for a in MODEL_ARGS if a != "--fid-flash-attention"]]) == 0
    line = next(line for line in capsys.readouterr().out.splitlines()
                if line.startswith(str(d / "dev.csv")))
    got = {kv.split("=")[0]: float(kv.split("=")[1])
           for kv in line.split()[2:]}
    assert got == want and "n=8" in line


def test_retriever_cli_eval_only(cli_world, capsys):
    d = cli_world
    if ck.latest_iteration(str(d / "full")) != 12:
        assert run_task(_cli(d, "full", "--epochs", "3")) == 0
    capsys.readouterr()
    argv = _cli(d, "full", "--epochs", "3", "--load", str(d / "full"),
                "--eval-only")
    assert run_task(argv) == 0
    out = capsys.readouterr().out
    assert not any(line.startswith((" iteration ", " epoch "))
                   for line in out.splitlines()), out
    assert "DEV retrieval | recall@1" in out
    assert ck.latest_iteration(str(d / "full")) == 12
