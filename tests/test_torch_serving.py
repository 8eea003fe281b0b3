"""The whole serving slice: a JAX ``QAPipeline`` and the port's, on the toy
world, with the same converted weights and the same 2048-row index (mapped
onto the 64-doc corpus through ``passage_ids``, so the search takes the
candidate-scan path: N > chunk_rows). The flash self-attention path is on
in both. Retrieved passage ids, reader token layouts and greedy tokens must
be identical."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.models import EMDR2Model as JaxEMDR2Model  # noqa: E402
from emdr2_tpu.models.decoding import greedy_decode as jax_greedy  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import (  # noqa: E402
    ShardedEvidenceIndex as JaxIndex,
)
from emdr2_tpu.serving import QAPipeline as JaxPipeline  # noqa: E402
from emdr2_tpu_torch.config import tiny_config, with_flash_attention  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.data.evidence import EvidenceCorpus  # noqa: E402
from emdr2_tpu_torch.data.indexed_dataset import MMapIndexedDataset  # noqa: E402
from emdr2_tpu_torch.data.tokenizer import (  # noqa: E402
    BertWordPieceTokenizer,
    toy_vocab,
)
from emdr2_tpu_torch.models import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.models.decoding import greedy_decode  # noqa: E402
from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex  # noqa: E402
from emdr2_tpu_torch.serving import QAPipeline  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_models import make_batch  # noqa: E402
from tests.test_torch_models import jax_flash_cfg, unboxed_numpy  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 2048
QUESTIONS = [f"what is the color of item{i}" for i in (0, 5, 17, 33, 63)]


def port_config(jcfg):
    """The port's tiny config resized to the toy tokenizer, flash on."""
    cfg = with_flash_attention(tiny_config())
    enc = dataclasses.replace(
        cfg.retriever.encoder,
        vocab_size=jcfg.retriever.encoder.vocab_size)
    t5c = dataclasses.replace(
        cfg.reader.transformer,
        vocab_size=jcfg.reader.transformer.vocab_size)
    return cfg.replace(
        retriever=dataclasses.replace(cfg.retriever, encoder=enc),
        reader=dataclasses.replace(cfg.reader, transformer=t5c))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    jcfg, jtok, jcorpus, _, _ = build_toy_world(root)
    jcfg = jax_flash_cfg(jcfg)
    n_docs = len(jcorpus)
    emb = np.random.RandomState(0).randn(
        N_ROWS, jcfg.index.embed_dim).astype(np.float32)
    pids = 1 + np.arange(N_ROWS) % n_docs

    jmodel = JaxEMDR2Model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         make_batch(jcfg))["params"]
    jindex = JaxIndex(build_mesh(), jcfg.index, emb, passage_ids=pids)
    jpipe = JaxPipeline(jcfg, params, jtok, jcorpus, jindex, batch_size=4)

    cfg = port_config(jcfg)
    model = EMDR2Model(cfg)
    model.load_state_dict(params_from_jax(unboxed_numpy(params)))
    words = [f"item{i}" for i in range(n_docs)] + [
        "red", "blue", "green", "gold", "color", "of", "is", "what", "the"]
    tok = BertWordPieceTokenizer(toy_vocab(words), vocab_extra_ids=10)
    corpus = EvidenceCorpus(MMapIndexedDataset(str(root / "text")),
                            MMapIndexedDataset(str(root / "title")))
    index = ShardedEvidenceIndex(cfg.index, emb, passage_ids=pids)
    pipe = QAPipeline(cfg, model, tok, corpus, index, batch_size=4)
    return jpipe, pipe


def test_retrieved_passages_identical(pipelines):
    jpipe, pipe = pipelines
    want = jpipe.retrieve_passages(QUESTIONS, k=6)
    got = pipe.retrieve_passages(QUESTIONS, k=6)
    assert got == want


def test_reader_layouts_and_greedy_tokens_identical(pipelines):
    jpipe, pipe = pipelines
    qs = QUESTIONS[:4]
    jbatch = jpipe._build_batch(qs)
    batch = pipe._build_batch(qs)
    np.testing.assert_array_equal(batch.reader_ids.numpy(),
                                  np.asarray(jbatch.reader_ids))
    want = jax_greedy(jpipe.session, jbatch, jpipe.tok.bos_id,
                      jpipe.tok.eos_id)
    got = greedy_decode(pipe.session, batch, pipe.tok.bos_id,
                        pipe.tok.eos_id)
    assert got == want


def test_ask_identical_with_tail_padding(pipelines):
    """5 questions at batch 4: the second batch pads with duplicates."""
    jpipe, pipe = pipelines
    got = pipe.ask(QUESTIONS)
    assert len(got) == len(QUESTIONS)
    assert all(isinstance(a, str) for a in got)
    assert got == jpipe.ask(QUESTIONS)


def test_serving_import_leaves_jax_out():
    """With jax installed and importable, the port's serving module still
    never pulls it (or the JAX package) in."""
    code = ("import sys, emdr2_tpu_torch.serving; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'emdr2_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
