"""The port's copies of the framework-free host modules give byte-identical
outputs to the JAX package's originals, and the port's package imports
neither jax nor emdr2_tpu."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.data import postprocess as jax_post  # noqa: E402
from emdr2_tpu.data.evidence import EvidenceCorpus as JaxCorpus  # noqa: E402
from emdr2_tpu.data.indexed_dataset import (  # noqa: E402
    MMapIndexedDataset as JaxDataset,
)
from emdr2_tpu.data.qa_dataset import (  # noqa: E402
    encode_question as jax_encode_question,
)
from emdr2_tpu.data.tokenizer import (  # noqa: E402
    BertWordPieceTokenizer as JaxTokenizer,
    toy_vocab as jax_toy_vocab,
)
from emdr2_tpu_torch.data import postprocess  # noqa: E402
from emdr2_tpu_torch.data.evidence import EvidenceCorpus  # noqa: E402
from emdr2_tpu_torch.data.indexed_dataset import (  # noqa: E402
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
)
from emdr2_tpu_torch.data.qa_dataset import encode_question  # noqa: E402
from emdr2_tpu_torch.data.tokenizer import (  # noqa: E402
    BertWordPieceTokenizer,
    toy_vocab,
)
from emdr2_tpu_torch.native import get_lib  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["what", "is", "the", "color", "of", "item", "red", "blue", "who",
         "wrote", "hamlet"]
TEXTS = ["What is the color of item7?", "who WROTE hamlet, 1603!",
         "unknown-words here", "", "red blue  red\tblue"]


@pytest.fixture(scope="module")
def toks():
    return (BertWordPieceTokenizer(toy_vocab(WORDS), vocab_extra_ids=10),
            JaxTokenizer(jax_toy_vocab(WORDS), vocab_extra_ids=10))


def test_tokenizer_and_encode_question(toks):
    tok, jtok = toks
    for attr in ("cls_id", "sep_id", "pad_id", "bos_id", "eos_id",
                 "padded_vocab_size"):
        assert getattr(tok, attr) == getattr(jtok, attr)
    for text in TEXTS:
        ids = tok.tokenize(text)
        assert ids == jtok.tokenize(text)
        assert tok.detokenize(ids) == jtok.detokenize(ids)
        assert encode_question(text, tok, 8) == jax_encode_question(
            text, jtok, 8)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory, toks):
    """One on-disk corpus (written by the port's MMapIndexedDatasetBuilder) read by both."""
    tok, _ = toks
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    text_p, title_p = str(d / "text"), str(d / "title")
    with MMapIndexedDatasetBuilder(text_p) as b:
        for i in range(40):
            b.add_item(rng.randint(5, 60, size=rng.randint(1, 30)).tolist())
    with MMapIndexedDatasetBuilder(title_p) as b:
        for i in range(40):
            b.add_item(tok.tokenize(f"item {i // 3}"))
    return (EvidenceCorpus(MMapIndexedDataset(text_p),
                           MMapIndexedDataset(title_p)),
            JaxCorpus(JaxDataset(text_p), JaxDataset(title_p)))


def test_dataset_and_corpus(corpora):
    corpus, jcorpus = corpora
    idx = [0, 5, 39, 5]
    got = corpus.passages.batch_padded(idx, 12, pad_id=0)
    want = jcorpus.passages.batch_padded(idx, 12, pad_id=0)
    assert got.tobytes() == want.tobytes()
    for doc in (1, 7, 40):
        assert corpus.neighbours(doc) == jcorpus.neighbours(doc)
        assert corpus.title_tokens(doc) == jcorpus.title_tokens(doc)


@pytest.mark.parametrize("path", ["native", "python"])
def test_postprocess_retrieved(corpora, toks, path):
    corpus, jcorpus = corpora
    tok, _ = toks
    rng = np.random.RandomState(1)
    enc = [encode_question(t, tok, 8) for t in TEXTS[:3]]
    q_ids = np.asarray([ids for ids, _ in enc], np.int32)
    lens = [n for _, n in enc]
    pids = rng.randint(1, 41, size=(3, 5))
    args = dict(query_uids=[-1, -2, -3], query_t5_ids=q_ids,
                query_t5_lens=lens, topk_passage_ids=pids, topk=5,
                retriever_seq_len=16, reader_seq_len=24, cls_id=tok.cls_id,
                sep_id=tok.sep_id, pad_id=tok.pad_id)
    if path == "native":
        get_lib()    # the port builds the shared C++ source on its own
        got = postprocess.postprocess_retrieved(corpus=corpus, **args)
    else:
        got = postprocess.postprocess_retrieved_python(corpus=corpus, **args)
    want = jax_post.postprocess_retrieved_python(corpus=jcorpus, **args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_masks_match_jax():
    import jax.numpy as jnp
    from emdr2_tpu.data import masks as jmasks
    from emdr2_tpu_torch.data import masks
    ids = np.random.RandomState(2).randint(0, 4, size=(3, 7)).astype(np.int32)
    t, j = torch.as_tensor(ids), jnp.asarray(ids)
    for got, want in (
            (masks.padding_bias(t), jmasks.padding_bias(j)),
            (masks.attention_mask(t, t[:, :5]),
             jmasks.attention_mask(j, j[:, :5])),
            (masks.self_attention_mask(t, causal=True),
             jmasks.self_attention_mask(j, causal=True)),
            (masks.mask_to_bias(masks.self_attention_mask(t)),
             jmasks.mask_to_bias(jmasks.self_attention_mask(j)))):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


_BLOCK_JAX = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "emdr2_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import emdr2_tpu_torch
import emdr2_tpu_torch.serving
for m in pkgutil.walk_packages(emdr2_tpu_torch.__path__, "emdr2_tpu_torch."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "emdr2_tpu")]
assert not bad, bad
print("ok")
"""


def test_port_never_imports_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
