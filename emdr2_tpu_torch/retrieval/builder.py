"""Evidence index builder: embed the corpus with the context tower (port of
``emdr2_tpu/retrieval/builder.py:EvidenceIndexBuilder``).

Every passage is formatted as [CLS] title [SEP] text [SEP] by the C++ of
``native/store_ops.cpp`` and goes through the context tower in batches of
``batch_size`` rows (the flash self-attention kernel at L = ``seq_len``),
with no dropout and no gradient. The result is an fp16 host array, row i
holding doc i+1 (``embed_corpus``; ``build_store`` wraps it in an
``EmbeddingStore``), or a tensor of the index's padded row count in
``cfg.index.dtype`` on the device (``embed_corpus_device``), which
``ShardedEvidenceIndex.update`` swaps in without a host round trip.

``embed_corpus(row_partition=(start, stop))`` embeds one data-parallel
rank's block of index rows (the JAX builder's ``row_partition``); the JAX
builder's ``place_params`` (weights onto an embedder mesh) waits for the
disjoint embedder group (ROADMAP A3).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from emdr2_tpu_torch.config import EMDR2Config
from emdr2_tpu_torch.data.evidence import EvidenceCorpus
from emdr2_tpu_torch.native import batch_context_format
from emdr2_tpu_torch.retrieval.datastore import EmbeddingStore


def context_tower(module: torch.nn.Module) -> torch.nn.Module:
    """The context tower of an ``EMDR2Model`` (``.retriever``) or of a
    ``DualEncoder`` (``.context_model``); a tower is its own."""
    module = getattr(module, "retriever", module)
    return getattr(module, "context_model", module)


def embed_context(module: torch.nn.Module, ids: torch.Tensor,
                  types: torch.Tensor) -> torch.Tensor:
    """The default ``embed_method``: the context tower's CLS state in fp32
    (``DualEncoder.embed_context``), no dropout."""
    return context_tower(module).embed(ids, types).float()


class EvidenceIndexBuilder:
    """Embeds every corpus passage through the context tower (parity with
    the JAX builder's formatting and row order)."""

    def __init__(self, cfg: EMDR2Config, model: torch.nn.Module,
                 corpus: EvidenceCorpus, cls_id: int, sep_id: int,
                 pad_id: int, batch_size: int = 128,
                 embed_method: Optional[Callable] = None):
        """``model``: an ``EMDR2Model``, a ``DualEncoder`` or a context
        tower; its device is where the passages are embedded.
        ``embed_method(module, ids, types) -> [n, d]`` maps a module of that
        kind to context embeddings (default ``embed_context``). Each embed
        call takes the module to embed with (default ``model``): a refresher
        passes its snapshot of the tower."""
        self.cfg = cfg
        self.model = model
        self.embed_method = embed_method or embed_context
        self.corpus = corpus
        self.cls_id, self.sep_id, self.pad_id = cls_id, sep_id, pad_id
        self.batch_size = max(1, batch_size)
        self.device = next(model.parameters()).device

    def _format_rows(self, doc_ids: np.ndarray):
        """(ids, types) int32 [n, seq_len] by the C++ formatter; a failed
        build of the native library raises (no slower fallback)."""
        return batch_context_format(
            self.corpus.titles, self.corpus.passages, doc_ids,
            self.cfg.retriever.seq_len, self.cls_id, self.sep_id,
            self.pad_id)

    def _batches(self, start: int = 0, stop: Optional[int] = None):
        """(lo, hi, doc_ids) per batch of rows [start, stop) (default all);
        the tail batch is padded with copies of its last doc so every batch
        has ``batch_size`` rows."""
        n, bs = len(self.corpus) if stop is None else stop, self.batch_size
        for lo in range(start, n, bs):
            hi = min(lo + bs, n)
            doc_ids = np.arange(lo + 1, hi + 1)
            if hi - lo < bs:
                doc_ids = np.concatenate(
                    [doc_ids, np.full(bs - (hi - lo), hi, np.int64)])
            yield lo, hi, doc_ids

    def _embed(self, module, doc_ids: np.ndarray) -> torch.Tensor:
        ids, types = self._format_rows(doc_ids)
        ids = torch.as_tensor(ids, dtype=torch.long).to(self.device)
        types = torch.as_tensor(types, dtype=torch.long).to(self.device)
        return self.embed_method(module, ids, types)

    @torch.inference_mode()
    def embed_corpus(self, module: Optional[torch.nn.Module] = None,
                     progress: Optional[Callable[[int, int], None]] = None,
                     row_partition: Optional[Tuple[int, int]] = None
                     ) -> np.ndarray:
        """[len(corpus), d] fp16 on the host, row i = doc i+1. The copy of
        one batch to the host waits only for that batch: the next one is
        already queued, and is formatted while the device runs it.

        ``row_partition=(start, stop)``: only the index rows [start, stop)
        that hold passages (a data-parallel rank's
        ``index.process_row_range()``), as [min(stop, N) - start, d]."""
        module = self.model if module is None else module
        n = len(self.corpus)
        start, stop = row_partition if row_partition is not None else (0, n)
        start, stop = min(start, n), min(stop, n)
        out = np.zeros((stop - start, self.cfg.index.embed_dim), np.float16)
        pending = None

        def finish(lo, hi, emb):
            out[lo - start:hi - start] = emb[:hi - lo].cpu().numpy()
            if progress is not None:
                progress(hi - start, stop - start)

        for lo, hi, doc_ids in self._batches(start, stop):
            emb = self._embed(module, doc_ids).to(torch.float16)
            if pending is not None:
                finish(*pending)
            pending = (lo, hi, emb)
        if pending is not None:
            finish(*pending)
        return out

    @torch.inference_mode()
    def embed_corpus_device(self, module: Optional[torch.nn.Module],
                            out_rows: int,
                            progress: Optional[Callable[[int, int], None]]
                            = None) -> torch.Tensor:
        """[out_rows, d] in ``cfg.index.dtype`` on the builder's device, the
        zero-copy refresh path. ``out_rows`` is the index's padded row count
        (``index.n_padded``); rows in [len(corpus), out_rows) may hold
        copies of the last passage, which the index masks."""
        module = self.model if module is None else module
        n = len(self.corpus)
        if out_rows < n:
            raise ValueError(f"out_rows {out_rows} < {n} passages")
        buf = torch.zeros((out_rows, self.cfg.index.embed_dim),
                          dtype=self.cfg.index.dtype, device=self.device)
        for lo, hi, doc_ids in self._batches():
            emb = self._embed(module, doc_ids)
            # the write may run past hi into the padding, never back
            size = min(self.batch_size, out_rows - lo)
            buf[lo:lo + size] = emb[:size].to(buf.dtype)
            if progress is not None:
                progress(hi, n)
        return buf

    def build_store(self, module: Optional[torch.nn.Module] = None,
                    path: Optional[str] = None) -> EmbeddingStore:
        store = EmbeddingStore.of_rows(self.embed_corpus(module))
        if path is not None:
            store.save(path)
        return store
