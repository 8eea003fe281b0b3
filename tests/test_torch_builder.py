"""The port's evidence-index build against the JAX package's: the embedding
store's files, the C++ context formatter's binding, and the builder's rows
by the host path and the device path, from the same converted weights on
the toy world.

Tolerance: the rows are fp16 (host path) or ``cfg.index.dtype`` (fp32 on
``tiny_config``, device path) of fp32 towers that sum in another order:
rtol 1e-3, atol 1e-3. Store files and formatted ids are held bit for bit.
"""

import copy
import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu import native as jax_native  # noqa: E402
from emdr2_tpu.config import MeshConfig  # noqa: E402
from emdr2_tpu.data.indexed_dataset import (  # noqa: E402
    MMapIndexedDataset as JaxDataset,
    MMapIndexedDatasetBuilder as JaxDatasetBuilder,
)
from emdr2_tpu.models import EMDR2Model as JaxModel  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import EmbeddingStore as JaxStore  # noqa: E402
from emdr2_tpu.retrieval.builder import (  # noqa: E402
    EvidenceIndexBuilder as JaxBuilder,
)
from emdr2_tpu_torch import native  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.data.indexed_dataset import MMapIndexedDataset  # noqa: E402
from emdr2_tpu_torch.models.emdr2 import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.retrieval import (  # noqa: E402
    EmbeddingStore,
    ShardedEvidenceIndex,
)
from emdr2_tpu_torch.retrieval.builder import (  # noqa: E402
    EvidenceIndexBuilder,
    context_tower,
)
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_models import jax_flash_cfg, unboxed_numpy  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

N_DOCS = 60          # not a multiple of the index group (8) or the batch
BATCH = 24           # 60 = 24 + 24 + a tail of 12, padded


@pytest.fixture(scope="module")
def builders(tmp_path_factory):
    """(JAX builder, its params, port builder, port model, port index),
    both from the same weights."""
    jcfg, tok, corpus, _, _ = build_toy_world(
        tmp_path_factory.mktemp("toy"), n_docs=N_DOCS)
    jcfg = jax_flash_cfg(jcfg)
    mesh = build_mesh(MeshConfig(dp=1, tp=1))
    jmodel = JaxModel(jcfg)
    # the context tower's parameters only (as the JAX index tool inits)
    ids = np.zeros((2, jcfg.retriever.seq_len), np.int32)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, ids, ids,
                         method=JaxModel.embed_context)["params"]
    jbuilder = JaxBuilder(jcfg, mesh, jmodel, corpus, tok.cls_id,
                          tok.sep_id, tok.pad_id, batch_size=BATCH)
    emb = np.zeros((N_DOCS, jcfg.index.embed_dim), np.float32)

    cfg = port_config(jcfg)
    model = EMDR2Model(cfg, device="cpu")
    prefix = "retriever.context_model."
    context_tower(model).load_state_dict(
        {k[len(prefix):]: v for k, v in
         params_from_jax(unboxed_numpy(params)).items()})
    builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                   tok.sep_id, tok.pad_id, batch_size=BATCH)
    index = ShardedEvidenceIndex(cfg.index, emb, device="cpu")
    return jbuilder, params, builder, model, index


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-3, atol=1e-3)


def test_embed_corpus_host_path_matches_jax(builders):
    jbuilder, params, builder, model, _ = builders
    want = jbuilder.embed_corpus(params)
    got = builder.embed_corpus()
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape == (N_DOCS, 64)
    _close(got, want)
    # a tower (what a refresher snapshots) embeds like the whole model
    np.testing.assert_array_equal(
        builder.embed_corpus(context_tower(model)), got)


def test_embed_corpus_device_path_matches_jax(builders):
    jbuilder, params, builder, _, index = builders
    assert index.n_padded == 64
    want = np.asarray(jbuilder.embed_corpus_device(
        params, out_rows=index.n_padded))
    got = builder.embed_corpus_device(None, index.n_padded)
    assert got.dtype == builder.cfg.index.dtype
    assert tuple(got.shape) == want.shape == (64, 64)
    # rows past the corpus hold copies of the last passage, as there
    _close(got.numpy(), want)
    _close(got[:N_DOCS].numpy(), builder.embed_corpus())


def test_builder_rows_equal_the_model_context_embedding(builders):
    _, _, builder, model, _ = builders
    doc_ids = np.array([1, 7, N_DOCS])
    ids, types = builder._format_rows(doc_ids)
    with torch.no_grad():
        want = model.retriever.embed_context(torch.tensor(ids).long(),
                                             torch.tensor(types).long())
    got = builder.embed_corpus()[doc_ids - 1]
    _close(got, want.numpy())


def test_embedder_devices_place_params_and_row_blocks(builders):
    """An embedder on two devices (batch i on device i mod 2; CPU here, the
    same code as on two cards) with the copies ``place_params`` made of the
    tower embeds bit for bit what one device embeds; a copy follows the
    weights it is refreshed from; a rank's block (``row_partition``) is
    those rows by either path, its padding zero."""
    _, _, builder, model, index = builders
    cpu = torch.device("cpu")
    tower = context_tower(model)
    two = EvidenceIndexBuilder(builder.cfg, model, builder.corpus,
                               builder.cls_id, builder.sep_id,
                               builder.pad_id, batch_size=BATCH,
                               devices=[cpu, cpu])
    placed = two.place_params(tower)
    assert len(placed) == 2 and all(p is not tower for p in placed)
    assert not any(q.requires_grad for p in placed for q in p.parameters())
    want = builder.embed_corpus()
    np.testing.assert_array_equal(two.embed_corpus(placed), want)
    np.testing.assert_array_equal(two.embed_corpus(), want)
    np.testing.assert_array_equal(
        two.embed_corpus_device(placed, index.n_padded).numpy(),
        builder.embed_corpus_device(None, index.n_padded).numpy())
    # a rank's block [24, 64) of the 64 padded rows: 36 passages, 4 pads
    block = builder.embed_corpus_device(None, row_partition=(24, 64))
    assert tuple(block.shape) == (40, 64)
    np.testing.assert_array_equal(
        block[:N_DOCS - 24].numpy(),
        builder.embed_corpus_device(None, 64)[24:N_DOCS].numpy())
    np.testing.assert_array_equal(
        two.embed_corpus(placed, row_partition=(24, 64)), want[24:])
    # the copies follow the weights handed over later
    moved = copy.deepcopy(tower)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1.5)
    assert two.place_params(moved, placed) is placed
    np.testing.assert_array_equal(two.embed_corpus(placed),
                                  builder.embed_corpus(moved))


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_a_block_made_where_the_rows_are_swaps_in_bit_equal(builders,
                                                            quantize):
    """``local_block`` run where the rows are (an embedder's card) and
    swapped in by ``update_from_process_local`` gives the index the host
    path's ``_to_device`` gives for the same rows: int8 rows and scales
    (or cast rows) bit for bit; a block of the wrong form is refused."""
    _, _, builder, _, _ = builders
    cfg = dataclasses.replace(builder.cfg.index, quantize=quantize)
    rows = builder.embed_corpus_device(None, 64)
    want = ShardedEvidenceIndex(cfg, np.zeros((N_DOCS, 64), np.float32),
                                device="cpu")
    want.update(rows)
    got = ShardedEvidenceIndex(cfg, np.zeros((N_DOCS, 64), np.float32),
                               device="cpu")
    block = got.local_block(rows)
    assert (block[1] is not None) == (quantize == "int8")
    got.update_from_process_local(block)
    assert torch.equal(got.embeddings, want.embeddings)
    if quantize == "int8":
        assert got.embeddings.dtype == torch.int8
        assert torch.equal(got.scales, want.scales)
    with pytest.raises(ValueError, match="block"):
        got.update_from_process_local((block[0][:8], block[1]))


def test_build_store_roundtrips_through_both_packages(builders, tmp_path):
    _, _, builder, _, _ = builders
    store = builder.build_store(path=str(tmp_path / "emb"))
    np.testing.assert_array_equal(store.ids, np.arange(1, N_DOCS + 1))
    back = JaxStore.load(str(tmp_path / "emb"))
    np.testing.assert_array_equal(back.ids, store.ids)
    np.testing.assert_array_equal(back.embeddings, store.embeddings)


def test_format_rows_raises_when_the_native_library_cannot_build(
        builders, monkeypatch, tmp_path):
    """No quiet fallback to the Python formatter (the JAX builder swallows
    the failure)."""
    _, _, builder, _, _ = builders
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "missing.so"))
    with pytest.raises(Exception):
        builder._format_rows(np.array([1, 2]))


@pytest.mark.parametrize("title_dtype,text_dtype", [
    (np.uint16, np.uint16), (np.int32, np.int32), (np.uint16, np.int32),
    (np.int32, np.uint16)])
def test_batch_context_format_matches_jax_binding(tmp_path, title_dtype,
                                                  text_dtype):
    rng = np.random.RandomState(3)
    for name, dtype, lo, hi in (("title", title_dtype, 1, 4),
                                ("text", text_dtype, 0, 40)):
        with JaxDatasetBuilder(str(tmp_path / name), dtype) as b:
            for _ in range(30):
                b.add_item(rng.randint(5, 900, size=rng.randint(lo, hi))
                           .tolist())
    doc_ids = np.array([1, 30, 2, 17, 17, 5])
    got = native.batch_context_format(
        MMapIndexedDataset(str(tmp_path / "title")),
        MMapIndexedDataset(str(tmp_path / "text")), doc_ids, 24, 101, 102, 0)
    want = jax_native.batch_context_format(
        JaxDataset(str(tmp_path / "title")),
        JaxDataset(str(tmp_path / "text")), doc_ids, 24, 101, 102, 0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def _files(prefix):
    return {p: open(p, "rb").read() for p in (f"{prefix}.ids.npy",
                                              f"{prefix}.emb.npy")}


@pytest.mark.parametrize("writer,reader", [(EmbeddingStore, JaxStore),
                                           (JaxStore, EmbeddingStore)])
def test_embedding_store_files_are_shared(tmp_path, writer, reader):
    """Shards written by one package merge and load in the other; the
    merged files are byte-equal whichever package wrote them."""
    rng = np.random.RandomState(0)
    emb = rng.randn(10, 8).astype(np.float16)
    for which, root in (("w", tmp_path / "a"), ("other", tmp_path / "b")):
        cls = writer if which == "w" else reader
        for rank, rows in enumerate((slice(5, 10), slice(0, 5))):
            s = cls(8)
            s.add_block(np.arange(1, 11)[rows], emb[rows])
            s.save_shard(str(root / "emb"), rank)
        cls.merge_shards(str(root / "emb"), expected_total=10)
    assert list(_files(str(tmp_path / "a" / "emb")).values()) == \
        list(_files(str(tmp_path / "b" / "emb")).values())
    for mmap in (True, False):
        back = reader.load(str(tmp_path / "a" / "emb"), mmap=mmap)
        np.testing.assert_array_equal(back.ids, np.arange(1, 11))
        np.testing.assert_array_equal(back.embeddings, emb)
    assert reader.exists(str(tmp_path / "a" / "emb"))
    assert not os.path.exists(str(tmp_path / "a" / "emb.shard0.ids.npy"))


def test_embedding_store_reference_pickle_and_accumulation(tmp_path):
    rng = np.random.RandomState(1)
    data = {int(i): rng.randn(6).astype(np.float16) for i in (9, 3, 5)}
    path = str(tmp_path / "ref.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    got, want = (EmbeddingStore.load_reference_pickle(path),
                 JaxStore.load_reference_pickle(path))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.embeddings, want.embeddings)

    blocks = [([4, 2], rng.randn(2, 6)), ([7], np.ones((1, 6)))]
    files = []
    for cls, name in ((EmbeddingStore, "port"), (JaxStore, "jax")):
        s = cls(6)
        s.add_block(*blocks[0])
        assert len(s) == 2
        s.add_block(*blocks[1])
        assert len(s) == 3
        s.save(str(tmp_path / name))
        files.append(list(_files(str(tmp_path / name)).values()))
    assert files[0] == files[1]
