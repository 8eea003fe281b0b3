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

``row_partition=(start, stop)`` embeds one data-parallel rank's block of
index rows (the JAX builder's ``row_partition``), by either path.

The embedder's devices (``devices``, default the model's): with an
embedder group (``parallel.mesh.embed_devices``) they are cards of their
own, beside the trainer's on its host. ``place_params`` copies the tower to embed
with onto each of them once per refresh (the JAX builder's
``place_params``, the reference's checkpoint hand-off through the disk);
batch i of a pass runs on device i mod their count, so one host thread
keeps every card busy, and ``embed_corpus_device`` gathers the rows on
the first.

A tower split over tensor-parallel ranks (``parallel/tensor.py``) is never
embedded with as it is: each rank embeds its own block of rows, which a
split tower's collectives would mix. ``place_params`` gathers it whole over
tp (``tensor.unsharded_copy``, on the calling thread, every tp rank
alike) and the embedder runs the whole copy, as one process would.
"""

from __future__ import annotations

import collections
import copy
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from emdr2_tpu_torch.config import EMDR2Config
from emdr2_tpu_torch.data.evidence import EvidenceCorpus
from emdr2_tpu_torch.native import batch_context_format
from emdr2_tpu_torch.parallel.tensor import (all_gather_params, is_split,
                                             module_tp, unsharded_copy)
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


Modules = Union[torch.nn.Module, Sequence[torch.nn.Module]]


class EvidenceIndexBuilder:
    """Embeds every corpus passage through the context tower (parity with
    the JAX builder's formatting and row order)."""

    def __init__(self, cfg: EMDR2Config, model: torch.nn.Module,
                 corpus: EvidenceCorpus, cls_id: int, sep_id: int,
                 pad_id: int, batch_size: int = 128,
                 embed_method: Optional[Callable] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        """``model``: an ``EMDR2Model``, a ``DualEncoder`` or a context
        tower. ``devices``: where the passages are embedded (default the
        model's device). ``embed_method(module, ids, types) -> [n, d]``
        maps a module of that kind to context embeddings (default
        ``embed_context``). Each embed call takes the module to embed with
        (default ``model``), or its copies on the devices
        (``place_params``): a refresher passes its snapshot of the
        tower."""
        self.cfg = cfg
        self.model = model
        self.embed_method = embed_method or embed_context
        self.corpus = corpus
        self.cls_id, self.sep_id, self.pad_id = cls_id, sep_id, pad_id
        self.batch_size = max(1, batch_size)
        self.devices: List[torch.device] = (
            [torch.device(d) for d in devices] if devices
            else [next(model.parameters()).device])
        self.device = self.devices[0]

    @torch.no_grad()
    def place_params(self, module: torch.nn.Module,
                     placed: Optional[List[torch.nn.Module]] = None
                     ) -> List[torch.nn.Module]:
        """Copies of ``module`` on each of the builder's devices, without
        gradients: made on the first call, and with ``placed`` (an earlier
        call's result) the weights are copied into them in place, device to
        device on the calling thread's current streams (a copy between
        cards waits for the current streams of both). A tp-split
        ``module`` is first gathered whole (a collective over its tp
        group: every tp rank calls this at the same point)."""
        tp = module_tp(module)
        if is_split(tp) and placed is None:
            whole = unsharded_copy(module)
            return [copy.deepcopy(whole).to(dev).requires_grad_(False).eval()
                    for dev in self.devices]
        if is_split(tp):
            whole = all_gather_params(
                {n: p.detach() for n, p in module.named_parameters()}, tp)
            for twin in placed:
                for n, d in twin.named_parameters():
                    d.copy_(whole[n])
            return placed
        if placed is None:
            placed = []
            for dev in self.devices:
                # a Parameter's deepcopy leaves its .grad behind
                twin = copy.deepcopy(module).to(dev)
                placed.append(twin.requires_grad_(False).eval())
            return placed
        src = list(module.parameters())
        for twin in placed:
            dst = list(twin.parameters())
            if dst[0].device == src[0].device:
                torch._foreach_copy_(dst, src)
            else:
                for d, p in zip(dst, src):
                    d.copy_(p)
        return placed

    def _modules(self, module: Optional[Modules]) -> List[torch.nn.Module]:
        """One module a device: ``module`` (default the model) when there
        is one device and it lives there, the given copies, or copies
        placed now."""
        module = self.model if module is None else module
        if isinstance(module, (list, tuple)):
            if len(module) != len(self.devices):
                raise ValueError(f"{len(module)} modules for "
                                 f"{len(self.devices)} devices")
            return list(module)
        if (len(self.devices) == 1
                and next(module.parameters()).device == self.device
                and not is_split(module_tp(module))):
            return [module]
        return self.place_params(module)

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

    def _embed(self, module, doc_ids: np.ndarray,
               device: Optional[torch.device] = None) -> torch.Tensor:
        """``module``'s embeddings of ``doc_ids`` on ``device`` (default
        the first of the builder's), where ``module`` lives."""
        device = self.device if device is None else device
        ids, types = self._format_rows(doc_ids)
        ids = torch.as_tensor(ids, dtype=torch.long).to(device)
        types = torch.as_tensor(types, dtype=torch.long).to(device)
        return self.embed_method(module, ids, types)

    def _embedded(self, modules: List[torch.nn.Module], start: int,
                  stop: int):
        """(lo, hi, emb) per batch of rows [start, stop), batch i embedded
        on device i mod n; each is yielded once the next batch of every
        device is queued, so a consumer's wait overlaps their work."""
        n = len(modules)
        pending = collections.deque()
        for i, (lo, hi, doc_ids) in enumerate(self._batches(start, stop)):
            j = i % n
            pending.append((lo, hi, self._embed(modules[j], doc_ids,
                                                self.devices[j])))
            if len(pending) > n:
                yield pending.popleft()
        yield from pending

    def _rows(self, row_partition: Optional[Tuple[int, int]]
              ) -> Tuple[int, int]:
        """The passage rows [start, stop) of ``row_partition`` (all)."""
        n = len(self.corpus)
        start, stop = row_partition if row_partition is not None else (0, n)
        return min(start, n), min(stop, n)

    @torch.inference_mode()
    def embed_corpus(self, module: Optional[Modules] = None,
                     progress: Optional[Callable[[int, int], None]] = None,
                     row_partition: Optional[Tuple[int, int]] = None
                     ) -> np.ndarray:
        """[len(corpus), d] fp16 on the host, row i = doc i+1. The copy of
        one batch to the host waits only for that batch: the next ones are
        already queued, and are formatted while the devices run them.

        ``row_partition=(start, stop)``: only the index rows [start, stop)
        that hold passages (a data-parallel rank's
        ``index.process_row_range()``), as [min(stop, N) - start, d]."""
        start, stop = self._rows(row_partition)
        out = np.zeros((stop - start, self.cfg.index.embed_dim), np.float16)
        for lo, hi, emb in self._embedded(self._modules(module), start,
                                          stop):
            out[lo - start:hi - start] = emb[:hi - lo].to(
                torch.float16).cpu().numpy()
            if progress is not None:
                progress(hi - start, stop - start)
        return out

    @torch.inference_mode()
    def embed_corpus_device(self, module: Optional[Modules],
                            out_rows: Optional[int] = None,
                            progress: Optional[Callable[[int, int], None]]
                            = None,
                            row_partition: Optional[Tuple[int, int]] = None
                            ) -> torch.Tensor:
        """[out_rows, d] in ``cfg.index.dtype`` on the builder's (first)
        device, the zero-copy refresh path. Without ``row_partition``
        ``out_rows`` is the index's padded row count (``index.n_padded``);
        with it, the rank's block ``[start, stop)`` of padded rows and
        ``out_rows`` defaults to its size. Rows past the last passage may
        hold copies of it, which the index masks (or zeroes, int8)."""
        n = len(self.corpus)
        start = row_partition[0] if row_partition is not None else 0
        if out_rows is None:
            if row_partition is None:
                raise ValueError("out_rows or row_partition is needed")
            out_rows = row_partition[1] - row_partition[0]
        first, stop = self._rows(row_partition)
        if out_rows < stop - first:
            raise ValueError(f"out_rows {out_rows} < {stop - first} "
                             f"passages")
        buf = torch.zeros((out_rows, self.cfg.index.embed_dim),
                          dtype=self.cfg.index.dtype, device=self.device)
        for lo, hi, emb in self._embedded(self._modules(module), first,
                                          stop):
            # the write may run past hi into the padding, never back
            size = min(self.batch_size, out_rows - (lo - start))
            buf[lo - start:lo - start + size] = emb[:size].to(buf.dtype)
            if progress is not None:
                progress(hi - first, stop - first)
        return buf

    def build_store(self, module: Optional[torch.nn.Module] = None,
                    path: Optional[str] = None) -> EmbeddingStore:
        store = EmbeddingStore.of_rows(self.embed_corpus(module))
        if path is not None:
            store.save(path)
        return store
