"""The port's command line on the CPU (``--device cpu``), the lifecycle of
tests/test_cli_smoke.py: TSV evidence prep -> offline index build ->
OPENQA training with the async index refresher -> interval checkpoint ->
valid EM; then evaluation from the checkpoint, the index rebuilt from the
checkpoint's retriever, ``QAPipeline.load`` and the kernels' limits.

The evidence prep is framework-free: its files are held byte for byte to
the JAX tool's. The rest runs the port alone (its weights come from its own
seed, so numbers are held to the port's own builder, not to the JAX CLI).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.tools.build_evidence import build as jax_build  # noqa: E402
from emdr2_tpu_torch.data.tokenizer import toy_vocab  # noqa: E402
from emdr2_tpu_torch.retrieval import EmbeddingStore  # noqa: E402
from emdr2_tpu_torch.tasks.run import main as run_task  # noqa: E402
from emdr2_tpu_torch.tools.build_evidence import build  # noqa: E402
from emdr2_tpu_torch.tools.create_doc_index import (  # noqa: E402
    main as build_index,
)
from emdr2_tpu_torch.training.checkpointing import (  # noqa: E402
    latest_iteration,
)

torch.set_num_threads(2)

MODEL_ARGS = ["--hidden-size", "32", "--num-layers", "1",
              "--num-attention-heads", "2", "--ffn-hidden-size", "64",
              "--seq-length-ret", "24", "--seq-length-query", "16",
              "--fid-flash-attention", "--device", "cpu"]
TASK_ARGS = ["--topk-retrievals", "2", "--batch-size", "8",
             "--seq-length", "48", "--seq-length-dec", "8",
             "--max-decode-len", "4"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    words = [f"item{i}" for i in range(16)] + [
        "red", "blue", "color", "of", "is", "what", "the"]
    (d / "vocab.txt").write_text("\n".join(toy_vocab(words)) + "\n")
    colors = ["red", "blue"]
    rows = ["id\ttext\ttitle"]
    for i in range(16):
        rows.append(
            f"{i+1}\tthe color of item{i} is {colors[i % 2]}\titem{i // 2}")
    (d / "evidence.tsv").write_text("\n".join(rows) + "\n")
    qa = [f"what is the color of item{i}\t['{colors[i % 2]}']"
          for i in range(16)]
    (d / "qa.csv").write_text("\n".join(qa) + "\n")
    return d


def _data_args(d):
    return ["--vocab-file", str(d / "vocab.txt"),
            "--train-data", str(d / "qa.csv"),
            "--valid-data", str(d / "qa.csv"),
            "--evidence-data-path", str(d / "wiki"),
            "--embedding-path", str(d / "emb")]


def test_openqa_cli_lifecycle(workdir, capsys):
    d = workdir
    # 1. pre-tokenize the evidence TSV into the mmap corpus: the same
    # files as the JAX tool writes
    assert build(str(d / "evidence.tsv"), str(d / "wiki"),
                 str(d / "vocab.txt"), workers=2) == 16
    assert jax_build(str(d / "evidence.tsv"), str(d / "jax_wiki"),
                     str(d / "vocab.txt"), workers=2) == 16
    for part in ("_text", "_title"):
        for ext in (".bin", ".idx"):
            assert (d / f"wiki{part}{ext}").read_bytes() == \
                (d / f"jax_wiki{part}{ext}").read_bytes()

    # 2. offline evidence index from a fresh retriever
    assert build_index(["--evidence-data-path", str(d / "wiki"),
                        "--vocab-file", str(d / "vocab.txt"),
                        "--embedding-path", str(d / "emb"),
                        "--batch-size", "8"] + MODEL_ARGS) == 0
    assert len(EmbeddingStore.load(str(d / "emb")).ids) == 16

    # 3. OPENQA training: async refresher, interval save, valid EM
    rc = run_task(["--task", "OPENQA", "--save", str(d / "run"),
                   "--epochs", "1", "--log-interval", "1",
                   "--save-interval", "1", "--eval-interval", "2",
                   "--async-indexer", "--index-reload-interval", "1"]
                  + _data_args(d) + TASK_ARGS + MODEL_ARGS)
    assert rc == 0
    out = capsys.readouterr().out
    assert "iteration 2 | valid EM" in out and "final (2 iters)" in out
    assert latest_iteration(str(d / "run")) == 2      # 16 rows / batch 8

    # 4. evaluation only, from the checkpoint, at a batch that does not
    # divide the set: every example scored once
    rc = run_task(["--task", "OPENQA", "--load", str(d / "run"),
                   "--eval-only", "--eval-batch-size", "3"]
                  + _data_args(d) + TASK_ARGS + MODEL_ARGS)
    assert rc == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "over 16" in out

    # 5. the index rebuilt from the trained retriever: the builder's rows
    # with the checkpoint's weights
    assert build_index(["--evidence-data-path", str(d / "wiki"),
                        "--vocab-file", str(d / "vocab.txt"),
                        "--embedding-path", str(d / "emb2"),
                        "--load", str(d / "run"),
                        "--batch-size", "8"] + MODEL_ARGS) == 0
    from emdr2_tpu_torch.serving import QAPipeline
    from emdr2_tpu_torch.tasks.run import build_parser, make_config
    args = build_parser().parse_args(["--task", "OPENQA"] + _data_args(d)
                                     + TASK_ARGS + MODEL_ARGS)
    cfg = make_config(args)
    pipe = QAPipeline.load(str(d / "run"), str(d / "vocab.txt"),
                           str(d / "wiki"), str(d / "emb2"), cfg=cfg,
                           device="cpu", batch_size=4)
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    builder = EvidenceIndexBuilder(pipe.cfg, pipe.model, pipe.corpus,
                                   pipe.tok.cls_id, pipe.tok.sep_id,
                                   pipe.tok.pad_id)
    rows = EmbeddingStore.load(str(d / "emb2")).embeddings
    # the pipeline's towers are stored bf16 (bf16_eval_params) while the
    # tool embedded with fp32 ones
    np.testing.assert_allclose(np.asarray(rows, np.float32),
                               builder.embed_corpus().astype(np.float32),
                               atol=2e-2)

    # 6. serving from the checkpoint: answers, and the passage ids
    qs = ["what is the color of item0", "what is the color of item3"]
    answers = pipe.ask(qs)
    assert len(answers) == 2 and all(isinstance(a, str) for a in answers)
    with_ids = pipe.ask(qs, return_passages=True)
    assert [a for a, _ in with_ids] == answers
    assert all(len(ids) == 2 and all(1 <= i <= 16 for i in ids)
               for _, ids in with_ids)

    # 7. a trained retriever initializes a new run (iteration 0)
    rc = run_task(["--task", "OPENQA", "--train-iters", "1",
                   "--pretrained-dpr-load", str(d / "run"),
                   "--save-interval", "100", "--eval-interval", "100"]
                  + _data_args(d) + TASK_ARGS + MODEL_ARGS)
    assert rc == 0
    assert "initialized retriever from" in capsys.readouterr().out


def test_cli_refuses_flags_the_kernels_do_not_take(workdir):
    """On the card the attention kernels' limits are checked on the flags
    before anything is built (head dim 16 here): no quiet fallback."""
    args = ["--task", "OPENQA"] + _data_args(workdir) + TASK_ARGS + [
        a if a != "cpu" else "cuda" for a in MODEL_ARGS]
    with pytest.raises(ValueError, match="head_dim"):
        run_task(args)
