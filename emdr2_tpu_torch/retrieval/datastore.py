"""Evidence embedding store (a copy of ``emdr2_tpu/retrieval/datastore.py``,
numpy only: a store that one package writes, the other loads).

Replaces the reference ``OpenRetreivalDataStore`` [sic]
(``megatron/data/emdr2_index.py:16-100``): a pickled
``{passage_id: fp16[768]}`` dict (32 GB for 21M passages, re-unpickled from
disk on every refresh). Here the store is a flat fp16/bf16 matrix plus an
int64 id vector, saved as raw ``.npy`` pairs that memory-map instantly —
loading is O(1) mmap instead of a 32 GB unpickle.

Shard-merge semantics are preserved: embedder shards write
``<path>.shard{r}.{ids,emb}.npy``; ``merge_shards`` concatenates, checks for
duplicate ids (the reference asserts no-overwrite, :58-59) and verifies full
corpus coverage (``indexer_emdr2.py:107-110``).

``load_reference_pickle`` ingests the reference's pickle format so MSS
precomputed embeddings can be reused directly.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np


class EmbeddingStore:
    """In-memory (or mmap-backed) flat embedding matrix with passage ids."""

    def __init__(self, embed_dim: int, dtype=np.float16):
        self.embed_dim = embed_dim
        self.dtype = np.dtype(dtype)
        self._ids: list = []
        self._blocks: list = []
        self.ids: Optional[np.ndarray] = None
        self.embeddings: Optional[np.ndarray] = None

    @classmethod
    def of_rows(cls, embeddings: np.ndarray) -> "EmbeddingStore":
        """A store of fp16 rows, row i holding passage i + 1 (what the
        index builder writes)."""
        store = cls(embeddings.shape[1], np.float16)
        store.ids = np.arange(1, len(embeddings) + 1, dtype=np.int64)
        store.embeddings = embeddings
        return store

    # ---- accumulation (parity with add_block_data, emdr2_index.py:44-60) ----

    def add_block(self, ids: Sequence[int], embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, self.dtype)
        assert embeddings.shape == (len(ids), self.embed_dim)
        self._ids.append(np.asarray(ids, np.int64))
        self._blocks.append(embeddings)

    def _consolidate(self) -> None:
        if self._blocks:
            new_ids = np.concatenate(self._ids)
            new_emb = np.concatenate(self._blocks)
            if self.ids is None:
                self.ids, self.embeddings = new_ids, new_emb
            else:
                self.ids = np.concatenate([self.ids, new_ids])
                self.embeddings = np.concatenate([self.embeddings, new_emb])
            self._ids, self._blocks = [], []
        if self.ids is None:
            self.ids = np.zeros((0,), np.int64)
            self.embeddings = np.zeros((0, self.embed_dim), self.dtype)

    def __len__(self) -> int:
        self._consolidate()
        return len(self.ids)

    # ---- shard files (parity with save_shard/merge_shards_and_save) --------

    @staticmethod
    def _shard_paths(path: str, rank: int) -> Tuple[str, str]:
        return f"{path}.shard{rank}.ids.npy", f"{path}.shard{rank}.emb.npy"

    def save_shard(self, path: str, rank: int) -> None:
        self._consolidate()
        ids_p, emb_p = self._shard_paths(path, rank)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(ids_p, self.ids)
        np.save(emb_p, self.embeddings)

    @classmethod
    def merge_shards(cls, path: str, expected_total: Optional[int] = None,
                     delete_shards: bool = True) -> "EmbeddingStore":
        """Concatenate all shard files into ``<path>.{ids,emb}.npy``."""
        shard_ids = sorted(glob.glob(f"{path}.shard*.ids.npy"))
        assert shard_ids, f"no shards found at {path}.shard*"
        all_ids, all_emb = [], []
        for ids_p in shard_ids:
            emb_p = ids_p.replace(".ids.npy", ".emb.npy")
            all_ids.append(np.load(ids_p))
            all_emb.append(np.load(emb_p))
        ids = np.concatenate(all_ids)
        emb = np.concatenate(all_emb)
        uniq = np.unique(ids)
        assert len(uniq) == len(ids), "duplicate passage ids across shards"
        if expected_total is not None:
            assert len(ids) == expected_total, (
                f"coverage check failed: {len(ids)} != {expected_total}")
        # sort by id so row order is deterministic
        order = np.argsort(ids, kind="stable")
        store = cls(emb.shape[1], emb.dtype)
        store.ids, store.embeddings = ids[order], emb[order]
        store.save(path)
        if delete_shards:
            for ids_p in shard_ids:
                os.remove(ids_p)
                os.remove(ids_p.replace(".ids.npy", ".emb.npy"))
        return store

    # ---- whole-store io ------------------------------------------------------

    def save(self, path: str) -> None:
        self._consolidate()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(f"{path}.ids.npy", self.ids)
        np.save(f"{path}.emb.npy", self.embeddings)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "EmbeddingStore":
        mode = "r" if mmap else None
        ids = np.load(f"{path}.ids.npy", mmap_mode=mode)
        emb = np.load(f"{path}.emb.npy", mmap_mode=mode)
        store = cls(emb.shape[1], emb.dtype)
        store.ids, store.embeddings = ids, emb
        return store

    @classmethod
    def exists(cls, path: str) -> bool:
        return (os.path.exists(f"{path}.ids.npy")
                and os.path.exists(f"{path}.emb.npy"))

    @classmethod
    def load_reference_pickle(cls, pickle_path: str) -> "EmbeddingStore":
        """Ingest the reference's ``{id: fp16 vec}`` pickle
        (emdr2_index.py:30-42) for MSS precomputed embeddings."""
        with open(pickle_path, "rb") as f:
            data = pickle.load(f)
        ids = np.fromiter(data.keys(), np.int64, len(data))
        emb = np.stack([np.asarray(v, np.float16) for v in data.values()])
        order = np.argsort(ids, kind="stable")
        store = cls(emb.shape[1], np.float16)
        store.ids, store.embeddings = ids[order], emb[order]
        return store
