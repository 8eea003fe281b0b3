"""The port's shipped recipes (``examples/torch/*.sh``) run as real
subprocesses, so a change to the command line cannot drift from them (the
rule of tests/test_recipes.py for the JAX package's recipes).

Each script runs on the CPU: ``--device cpu`` and toy widths are appended
after its own flags (argparse keeps the last occurrence), and its ranks
meet at a ``file://`` rendezvous. ``emdr2_nq.sh`` runs the reference's
layout cut to two trainers beside two embedders (``DP=2
EMBED_DEVICES=2``) with the asynchronous refresh and prefetch at depth 1
that it ships, and as two hosts of one rank each (``NNODES=2``, the script
run once a host with its ``NODE_RANK``), which must train as the one-host
launch does.
"""

import json
import os
import re
import socket
import subprocess

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODEL_ARGS = ["--hidden-size", "32", "--num-layers", "1",
              "--num-attention-heads", "2", "--ffn-hidden-size", "64",
              "--seq-length-ret", "24", "--seq-length-query", "16",
              "--device", "cpu"]
TINY_ARGS = MODEL_ARGS + ["--epochs", "1", "--log-interval", "1"]
TIMEOUT_S = 600


def recipe_env(tmpdir, **extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", DATA_DIR=str(tmpdir),
               COORDINATOR=f"file://{tmpdir}/store-{len(extra)}-"
                           f"{os.getpid()}")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_script(script, env, extra_args):
    res = subprocess.run(
        ["bash", os.path.join(REPO, script)] + extra_args, env=env,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, (
        f"{script} failed (rc={res.returncode}):\n{res.stdout[-6000:]}")
    return res.stdout


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    """Vocabulary, evidence store, embedding store, QA csv and DPR json:
    what the recipes' variables point at."""
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    from emdr2_tpu_torch.tools.build_evidence import build
    from emdr2_tpu_torch.tools.create_doc_index import main as create_index
    d = tmp_path_factory.mktemp("recipes")
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
    dpr = [{"question": f"what is the color of item{i}",
            "answers": [colors[i % 2]],
            "positive_ctxs": [{"title": f"item{i // 2}",
                               "text": f"the color of item{i} is "
                                       f"{colors[i % 2]}"}],
            "hard_negative_ctxs": [{"title": f"item{(i + 1) // 2}",
                                    "text": f"the color of item"
                                            f"{(i + 1) % 16} is x"}]}
           for i in range(16)]
    (d / "dpr.json").write_text(json.dumps(dpr))
    assert build(str(d / "evidence.tsv"), str(d / "wiki"),
                 str(d / "vocab.txt"), workers=1) == 16
    assert create_index(["--evidence-data-path", str(d / "wiki"),
                         "--vocab-file", str(d / "vocab.txt"),
                         "--embedding-path", str(d / "emb"),
                         "--batch-size", "8"] + MODEL_ARGS) == 0
    return d


def test_openqa_recipe_two_trainers_beside_two_embedders(datadir, tmp_path):
    """examples/torch/emdr2_nq.sh at DP=2 EMBED_DEVICES=2: two ranks train
    (2 questions a rank, 4 iterations) with the asynchronous refresh on
    their embedders and prefetch at depth 1, swap the index together, save
    and evaluate; rank 0 alone prints."""
    from emdr2_tpu_torch.training.checkpointing import latest_iteration
    ckpt = tmp_path / "ckpt"
    env = recipe_env(
        tmp_path, VOCAB_FILE=datadir / "vocab.txt",
        EVIDENCE=datadir / "wiki", EMBEDDINGS=datadir / "emb",
        TRAIN_DATA=datadir / "qa.csv", VALID_DATA=datadir / "qa.csv",
        CHECKPOINT_PATH=ckpt, DP=2, EMBED_DEVICES=2, BATCH_PER_RANK=2)
    out = run_script(
        "examples/torch/emdr2_nq.sh", env,
        TINY_ARGS + ["--topk-retrievals", "2", "--seq-length", "48",
                     "--seq-length-dec", "8", "--max-decode-len", "4",
                     "--flash-key-chunk", "8", "--index-reload-interval", "1",
                     "--save-interval", "2", "--eval-interval", "100"])
    assert "iteration        4/4" in out, out[-3000:]
    assert "index refreshed at iteration" in out, out[-3000:]
    assert "final (4 iters) | valid EM" in out and "over 16" in out
    assert out.count("final (4 iters)") == 1           # rank 0 alone
    assert latest_iteration(str(ckpt)) == 4            # 16 questions / 4


def test_openqa_recipe_at_tp2_with_the_refresher(datadir, tmp_path):
    """examples/torch/emdr2_nq.sh at DP=1 TP=2: one replica split over two
    ranks (2 questions, 8 iterations) with the asynchronous refresh, whose
    hand-off gathers the context tower whole over tp, and prefetch at
    depth 1; world rank 0 alone prints and writes the checkpoint."""
    from emdr2_tpu_torch.training.checkpointing import latest_iteration
    ckpt = tmp_path / "ckpt"
    env = recipe_env(
        tmp_path, VOCAB_FILE=datadir / "vocab.txt",
        EVIDENCE=datadir / "wiki", EMBEDDINGS=datadir / "emb",
        TRAIN_DATA=datadir / "qa.csv", VALID_DATA=datadir / "qa.csv",
        CHECKPOINT_PATH=ckpt, DP=1, TP=2, EMBED_DEVICES=0,
        BATCH_PER_RANK=2)
    out = run_script(
        "examples/torch/emdr2_nq.sh", env,
        TINY_ARGS + ["--topk-retrievals", "2", "--seq-length", "48",
                     "--seq-length-dec", "8", "--max-decode-len", "4",
                     "--flash-key-chunk", "8", "--index-reload-interval", "1",
                     "--save-interval", "4", "--eval-interval", "100"])
    assert "iteration        8/8" in out, out[-3000:]
    assert "index refreshed at iteration" in out, out[-3000:]
    assert out.count("final (8 iters)") == 1           # rank 0 alone
    assert latest_iteration(str(ckpt)) == 8            # 16 questions / 2


def _final_metrics(out, iters):
    """The last training log line (iteration ``iters``) without its time
    per iteration."""
    lines = [ln for ln in out.splitlines()
             if f"iteration {iters:8d}/{iters}" in ln]
    assert lines, out[-3000:]
    return re.sub(r" \| ms_per_iter [^|]*", "", lines[-1]).strip()


def test_openqa_recipe_as_two_hosts_trains_as_one_host(datadir, tmp_path):
    """examples/torch/emdr2_nq.sh run once on each of two emulated hosts
    (``NNODES=2``, ``NODE_RANK`` 0 and 1, ``NPROC_PER_NODE=1``), DP=2 with
    EMBED_DEVICES=2 (one embedder a host) and the refresher on: the ranks
    meet at ``MASTER_ADDR:MASTER_PORT`` by torchrun's variables, both
    invocations end with rc 0, host 0 alone prints, and its final loss
    line is the one-host launch's with the same flags (no index swap
    within the 4 iterations, so the two runs do the same work)."""
    flags = TINY_ARGS + ["--topk-retrievals", "2", "--seq-length", "48",
                         "--seq-length-dec", "8", "--max-decode-len", "4",
                         "--flash-key-chunk", "8",
                         "--index-reload-interval", "100",
                         "--save-interval", "100", "--eval-interval", "100"]
    data = dict(VOCAB_FILE=datadir / "vocab.txt", EVIDENCE=datadir / "wiki",
                EMBEDDINGS=datadir / "emb", TRAIN_DATA=datadir / "qa.csv",
                VALID_DATA=datadir / "qa.csv", DP=2, EMBED_DEVICES=2,
                BATCH_PER_RANK=2)
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()
    one = run_script("examples/torch/emdr2_nq.sh", recipe_env(
        tmp_path / "one", CHECKPOINT_PATH=tmp_path / "one" / "ckpt", **data),
        flags)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    hosts = []
    for node in range(2):
        env = recipe_env(tmp_path / "two", CHECKPOINT_PATH=tmp_path / "two"
                         / "ckpt", NNODES=2, NODE_RANK=node,
                         NPROC_PER_NODE=1, MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=port, **data)
        del env["COORDINATOR"]
        hosts.append(subprocess.Popen(
            ["bash", os.path.join(REPO, "examples/torch/emdr2_nq.sh")]
            + flags, env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in hosts:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in hosts:
            if p.poll() is None:
                p.kill()
                p.wait()
    for node, (p, out) in enumerate(zip(hosts, outs)):
        assert p.returncode == 0, f"host {node}:\n{out[-6000:]}"
    assert "launch: 2 ranks on 2 host(s) x 1" in outs[0], outs[0][-3000:]
    assert "iteration" not in outs[1]
    assert _final_metrics(outs[0], 4) == _final_metrics(one, 4)
    assert "final (4 iters) | valid EM" in outs[0]


@pytest.fixture(scope="module")
def dpr_run(datadir, tmp_path_factory):
    """examples/torch/dpr_nq.sh at DP=2 on the toy world -> (checkpoint
    directory, embedding store prefix, output)."""
    d = tmp_path_factory.mktemp("dpr_recipe")
    env = recipe_env(
        d, VOCAB_FILE=datadir / "vocab.txt", EVIDENCE=datadir / "wiki",
        EMBEDDINGS_OUT=d / "emb_dpr", TRAIN_DATA=datadir / "dpr.json",
        VALID_DATA=datadir / "dpr.json", QA_FILE_DEV=datadir / "qa.csv",
        QA_FILE_TEST=datadir / "qa.csv", CHECKPOINT_PATH=d / "ckpt", DP=2)
    out = run_script(
        "examples/torch/dpr_nq.sh", env,
        TINY_ARGS + ["--batch-size", "2", "--topk-retrievals", "4",
                     "--val-av-rank-other-neg", "2",
                     "--val-av-rank-hard-neg", "1",
                     "--report-topk-accuracies", "1", "4",
                     "--save-interval", "2"])
    return d / "ckpt", d / "emb_dpr", out


def test_dpr_recipe(dpr_run):
    """examples/torch/dpr_nq.sh at DP=2: RETRIEVER training (2 questions
    a rank), average-rank validation, checkpoints, then the post-train
    index embedded by row range over the ranks and its recall."""
    from emdr2_tpu_torch.retrieval import EmbeddingStore
    from emdr2_tpu_torch.training.checkpointing import latest_iteration
    ckpt, emb, out = dpr_run
    assert "average_rank" in out and "recall@4" in out, out[-3000:]
    assert latest_iteration(str(ckpt)) == 4              # 16 rows / 4
    assert len(EmbeddingStore.load(str(emb)).ids) == 16


def test_build_index_and_eval_recipe(datadir, dpr_run, tmp_path):
    """examples/torch/build_index_and_eval.sh with the DPR recipe's
    checkpoint: the evidence pre-tokenized from its TSV, embedded, and the
    recall reported for the QA file."""
    ckpt, _, _ = dpr_run
    env = recipe_env(
        tmp_path, VOCAB_FILE=datadir / "vocab.txt",
        EVIDENCE=tmp_path / "wiki", EVIDENCE_TSV=datadir / "evidence.tsv",
        WORKERS=1, EMBEDDINGS=tmp_path / "emb", CKPT=ckpt,
        QA_FILES=datadir / "qa.csv", TOPK=4, REPORT_AT="1 4")
    out = run_script("examples/torch/build_index_and_eval.sh", env,
                     MODEL_ARGS)
    assert "done: 16 passages" in out, out[-3000:]
    assert "recall@4" in out, out[-3000:]
    from emdr2_tpu_torch.retrieval import EmbeddingStore
    assert len(EmbeddingStore.load(str(tmp_path / "emb")).ids) == 16
