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
    OpenQADataset as JaxOpenQADataset,
    encode_question as jax_encode_question,
)
from emdr2_tpu.data.samplers import (  # noqa: E402
    DistributedBatchSampler as JaxDistributedBatchSampler,
    RandomSampler as JaxRandomSampler,
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
from emdr2_tpu_torch.data.qa_dataset import (  # noqa: E402
    OpenQADataset,
    encode_question,
)
from emdr2_tpu_torch.data.samplers import (  # noqa: E402
    DistributedBatchSampler,
    RandomSampler,
)
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


def test_openqa_dataset_and_samplers(toks, tmp_path):
    """Same csv, same seeds: identical batches (answers sampled per access,
    epoch shuffles, per-rank slices, tail batch)."""
    tok, jtok = toks
    path = tmp_path / "qa.csv"
    path.write_text("".join(
        f"what is the color of item{i}\t['red', 'blue {i}', 'who']\n"
        for i in range(11)))
    ds = OpenQADataset([str(path)], tok, 16, 6, seed=3)
    jds = JaxOpenQADataset([str(path)], jtok, 16, 6, seed=3)
    for kw in (dict(seed=1), dict(seed=2, drop_last=False, shuffle=False),
               dict(seed=4, rank=1, world_size=2)):
        got = list(ds.epoch_batches(4, **kw))
        want = list(jds.epoch_batches(4, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
                else:
                    assert a == b
    a, b = RandomSampler(9, seed=5), JaxRandomSampler(9, seed=5)
    a.set_epoch(2)
    b.set_epoch(2)
    assert list(a) == list(b)
    assert list(DistributedBatchSampler(range(10), 4, False, 1, 2, True)) == \
        list(JaxDistributedBatchSampler(range(10), 4, False, 1, 2, True))


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


def _code_lines(path):
    """The source without its ``//`` comment lines."""
    with open(path, "rb") as f:
        return [ln for ln in f.read().splitlines()
                if not ln.lstrip().startswith(b"//")]


def test_store_ops_source_is_the_ports_own_identical_copy():
    """The port builds its own ``native/store_ops.cpp``: the JAX package's
    source, code line for code line (comment lines may differ: the copy's
    header names no path outside the repository)."""
    from emdr2_tpu_torch import native
    own = os.path.join(REPO, "emdr2_tpu_torch", "native", "store_ops.cpp")
    assert os.path.samefile(native._SRC, own)
    theirs = os.path.join(REPO, "emdr2_tpu", "native", "store_ops.cpp")
    assert _code_lines(own) == _code_lines(theirs)
    assert len(_code_lines(own)) > 100


def _port_sources():
    import glob
    return sorted(glob.glob(os.path.join(REPO, "emdr2_tpu_torch", "**",
                                         "*.py"), recursive=True)
                  ) + [os.path.join(REPO, "chip_smoke.py")]


@pytest.mark.parametrize("what,pattern", [
    ("an import of jax, flax or the JAX package",
     r"^\s*(import|from)\s+(jax|jaxlib|flax|emdr2_tpu)(\.|\s|$)"),
    ("a path into the JAX package's directory",
     r"[\"'/]emdr2_tpu[\"'/]|[\"']emdr2_tpu[\"']\s*[,)]"),
    ("an import of the JAX package's root bench.py",
     r"^\s*(import|from)\s+bench(\.|\s|$)"),
])
def test_port_sources_name_no_jax_import_and_no_jax_package_file(what,
                                                                 pattern):
    """Statically, over every module of the port and ``chip_smoke.py``: no
    import of jax / flax / emdr2_tpu or of the root ``bench.py`` (it
    imports jax and sets its PRNG), and no file path built into
    ``emdr2_tpu/`` (docstrings may name its files as ``emdr2_tpu/...``
    inside double backquotes or after "Replaces:")."""
    import re
    rx = re.compile(pattern)
    bad = []
    for path in _port_sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                code = line.split("#", 1)[0]
                if rx.search(code) and "``" not in line \
                        and '"replaces"' not in line:
                    bad.append(f"{os.path.relpath(path, REPO)}:{n}: "
                               f"{line.strip()}")
    assert not bad, f"{what}:\n" + "\n".join(bad)
