"""Retrieval evaluation of the port against the JAX package (CPU): the
answer matching of ``retrieval/qa_validation.py`` (the port's tokenizer is
written with ``unicodedata``, the JAX one with the ``regex`` package), and
``OpenRetrievalEvaluator`` on the toy world with the same converted weights
and the same 2048-row index (one shard, N > chunk_rows: the candidate-scan
path), bf16 and int8: equal retrieved passage ids and equal recall dicts.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import MeshConfig  # noqa: E402
from emdr2_tpu.models import EMDR2Model as JaxEMDR2Model  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import (  # noqa: E402
    ShardedEvidenceIndex as JaxIndex,
)
from emdr2_tpu.retrieval import qa_validation as jqv  # noqa: E402
from emdr2_tpu.retrieval.evaluate import (  # noqa: E402
    OpenRetrievalEvaluator as JaxEvaluator,
)
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.data.qa_dataset import read_qa_csv  # noqa: E402
from emdr2_tpu_torch.models import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex  # noqa: E402
from emdr2_tpu_torch.retrieval import qa_validation as qv  # noqa: E402
from emdr2_tpu_torch.retrieval.evaluate import (  # noqa: E402
    OpenRetrievalEvaluator,
)
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_models import make_batch  # noqa: E402
from tests.test_torch_models import unboxed_numpy  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

N_ROWS = 2048

TEXTS = [
    "The Eiffel Tower is in Paris, France.",
    "São Paulo (Brazil) — population 12,300,000; naïve café.",
    "東京 is the capital of Japan. Tōkyō!",
    "Albert Einstein's theory of relativity (1905)",
    "numbers: ١٢٣ and ½ of 3.14 km/h",
    "tab\tseparated\x00control​zero-width",
]
ANSWERS = [["Paris"], ["sao paulo", "12,300,000"], ["東京"],
           ["einstein's theory"], ["3.14"], ["zero-width"], ["tokyo"],
           ["relativity (1905)"], ["Par"]]


def test_simple_tokenizer_matches_jax():
    rng = np.random.RandomState(0)
    ranges = [(32, 0x2FF), (0x300, 0x36F), (0x4E00, 0x4E50),
              (0x2000, 0x206F), (0, 31), (0x1F600, 0x1F64F),
              (0x600, 0x6FF)]
    texts = list(TEXTS)
    for _ in range(300):
        texts.append("".join(chr(rng.randint(*ranges[rng.randint(7)]))
                             for _ in range(24)))
        # pure ASCII (the port's regular-expression route), controls too
        texts.append("".join(chr(rng.randint(0, 128)) for _ in range(24)))
    for t in texts:
        assert qv.SimpleTokenizer().tokenize(t) == \
            jqv.SimpleTokenizer().tokenize(t), t
        assert qv.SimpleTokenizer().words(t) == jqv.SimpleTokenizer().words(t)


@pytest.mark.parametrize("match_type", ["string", "regex"])
def test_has_answer_matches_jax(match_type):
    for answers in ANSWERS + [["paris|tokyo"], ["[unclosed"]]:
        for text in TEXTS:
            assert qv.has_answer(answers, text, qv.SimpleTokenizer(),
                                 match_type) == \
                jqv.has_answer(answers, text, jqv.SimpleTokenizer(),
                               match_type), (answers, text)


@pytest.mark.parametrize("workers", [1, 4])
def test_calculate_matches_matches_jax(workers):
    rng = np.random.RandomState(1)
    closest = [(rng.randint(0, len(TEXTS), size=4).tolist(),
                rng.randn(4).tolist()) for _ in ANSWERS]

    def text(i):
        return TEXTS[i]

    got = qv.calculate_matches(text, ANSWERS, closest, workers_num=workers)
    want = jqv.calculate_matches(text, ANSWERS, closest, workers_num=workers)
    assert got.top_k_hits == want.top_k_hits
    assert got.questions_doc_hits == want.questions_doc_hits


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    jcfg, tok, corpus, _, _ = build_toy_world(root, n_questions=24)
    jmodel = JaxEMDR2Model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         make_batch(jcfg))["params"]
    cfg = port_config(jcfg)
    cfg = cfg.replace(retriever=dataclasses.replace(
        cfg.retriever, encoder=dataclasses.replace(
            cfg.retriever.encoder, fid_flash_attention=False)))
    model = EMDR2Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(unboxed_numpy(params)))
    emb = np.random.RandomState(0).randn(
        N_ROWS, jcfg.index.embed_dim).astype(np.float32)
    pids = 1 + np.arange(N_ROWS) % len(corpus)
    return dict(jcfg=jcfg, cfg=cfg, tok=tok, corpus=corpus, jmodel=jmodel,
                params=params, model=model.eval(), emb=emb, pids=pids,
                qa=str(root / "qa.csv"))


def _evaluators(world, **index_fields):
    import jax.numpy as jnp
    jicfg = dataclasses.replace(world["jcfg"].index, **{
        k: (jnp.bfloat16 if v is torch.bfloat16 else v)
        for k, v in index_fields.items()})
    icfg = dataclasses.replace(world["cfg"].index, **index_fields)
    mesh = build_mesh(MeshConfig(dp=1, tp=1))
    jindex = JaxIndex(mesh, jicfg, world["emb"], passage_ids=world["pids"])
    index = ShardedEvidenceIndex(icfg, world["emb"],
                                 passage_ids=world["pids"], device="cpu")
    assert N_ROWS > icfg.chunk_rows          # the candidate scan runs
    qlen = world["cfg"].retriever.query_seq_len
    jev = JaxEvaluator(mesh, world["jmodel"], world["params"], jindex,
                       world["tok"], qlen, batch_size=8)
    ev = OpenRetrievalEvaluator(world["model"], index, world["tok"], qlen,
                                batch_size=8)
    return jev, ev


@pytest.mark.parametrize("index_fields", [
    {"dtype": torch.bfloat16}, {"quantize": "int8"}], ids=["bf16", "int8"])
def test_evaluator_matches_jax(world, index_fields, tmp_path):
    jev, ev = _evaluators(world, **index_fields)
    examples = read_qa_csv(world["qa"])
    questions = [e.question for e in examples]
    np.testing.assert_allclose(ev.encode_queries(questions).numpy(),
                               jev.encode_queries(questions), atol=1e-5)
    pids, scores = ev.retrieve(questions, k=10)
    jpids, jscores = jev.retrieve(questions, k=10)
    np.testing.assert_array_equal(pids, jpids)
    np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-4)

    def doc_text(pid):
        return world["tok"].detokenize(world["corpus"].doc_tokens(int(pid)))

    got = ev.evaluate_recall(examples, k=10, doc_text_fn=doc_text,
                             dump_path=str(tmp_path / "port.json"))
    want = jev.evaluate_recall(examples, k=10, doc_text_fn=doc_text,
                               dump_path=str(tmp_path / "jax.json"))
    assert got == want
    assert set(got) == {"recall@1", "recall@5", "recall@10"}
    dump = json.loads((tmp_path / "port.json").read_text())
    assert dump == json.loads((tmp_path / "jax.json").read_text())


def test_evaluator_tail_batch_and_embed_method(world):
    """5 questions at batch 8 (one padded batch) give the rows of a whole
    batch; a DualEncoder with ``DualEncoder.embed_query`` gives the same
    embeddings as the EMDR2 model's query tower."""
    from emdr2_tpu_torch.models.bert import DualEncoder
    _, ev = _evaluators(world)
    questions = [f"what is the color of item{i}" for i in range(13)]
    full = ev.encode_queries(questions)
    np.testing.assert_allclose(ev.encode_queries(questions[:5]).numpy(),
                               full[:5].numpy(), atol=1e-6)
    dual = OpenRetrievalEvaluator(world["model"].retriever, ev.index,
                                  world["tok"], ev.query_seq_len,
                                  batch_size=8,
                                  embed_method=DualEncoder.embed_query)
    torch.testing.assert_close(dual.encode_queries(questions), full)
