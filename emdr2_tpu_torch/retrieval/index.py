"""Resident evidence index with MIPS search (port of
``emdr2_tpu/retrieval/index.py:ShardedEvidenceIndex``).

Without ``dp`` the [N, d] embedding matrix lives on one device. With a
data-parallel group ``dp`` (``parallel.mesh.DataParallel``) the rows split
over every rank of its grid, ``dp.world`` (``dp * tp`` ranks, the JAX
``index_sharding``): rank r holds only its block, ``process_row_range()``,
the padded rows split in W equal blocks of a whole number of groups;
``search`` runs ``ops.mips.sharded_mips_topk`` (the queries gathered over
dp, the candidates over the world) and returns global row ids, and
``update_from_process_local`` swaps in this rank's rows alone. Rows
live in ``cfg.dtype`` or, with
``cfg.quantize == "int8"``, as int8 rows plus one fp32 scale per
``group_size`` rows. Rows are padded with zeros to a multiple of the group
so the candidate scan never copies the index; pad rows are masked in the
search (``n_valid``). Host embeddings are cast or quantized on the host
before upload (the final bytes cross the link); embeddings that already
live on the device are cast or quantized there.

Streams. ``update`` runs on the trainer's stream while a search may run on
another one (the prefetch worker's) and a refresh may hand in a tensor
made on a third (the embedder's). Three rules keep the swap safe without a
device-wide synchronize:

- a search records its stream on the (rows, scales) it read, so the
  caching allocator does not hand their memory to another stream when an
  ``update`` drops them while the search's kernel is still queued;
- ``update`` makes its stream wait for the ``ready`` event of a tensor
  made on another stream before reading it, and records its stream on it;
  a tensor on another card (an embedder's, ``update_from_process_local``)
  is read by the copy on that card's current stream, which waits and is
  recorded instead, and PyTorch's copy makes the trainer's stream wait for
  the copy;
- ``update`` records an event after writing the new (rows, scales), and a
  search waits for it before reading them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from emdr2_tpu_torch.config import IndexConfig
from emdr2_tpu_torch.ops.mips import (NEG_INF, mips_topk, quantize_int8,
                                      sharded_mips_topk)
from emdr2_tpu_torch.parallel.mesh import DataParallel
from emdr2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class ShardedEvidenceIndex:
    """Flat MIPS index, on the card unless ``device`` says otherwise;
    ``row_to_passage_id`` maps (global) rows to corpus passage ids on the
    host.

    ``dp``: the data-parallel group whose ranks hold the rows (default
    ``DataParallel.local()``: one device holds them all). ``embeddings`` is the whole [N, d] matrix (each rank keeps
    its block), or with ``local=True`` this rank's block alone (up to
    ``process_row_range()`` rows; ``n_real`` then gives N)."""

    def __init__(self, cfg: IndexConfig,
                 embeddings: Union[np.ndarray, torch.Tensor],
                 passage_ids: Optional[np.ndarray] = None,
                 device=DEFAULT_DEVICE, dp=None, local: bool = False,
                 n_real: Optional[int] = None):
        if cfg.quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', "
                             f"got {cfg.quantize!r}")
        n, d = embeddings.shape
        if d != cfg.embed_dim:
            raise ValueError(f"embeddings are {d}-d, config says "
                             f"{cfg.embed_dim}")
        if local and n_real is None:
            raise ValueError("local rows need n_real")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.quantized = cfg.quantize == "int8"
        self.dp = dp = dp if dp is not None else DataParallel.local()
        # the ranks that hold the blocks: every rank of the grid
        self.blocks = blocks = getattr(dp, "world", dp)
        n = n_real if local else n
        self.n_real = n
        g = cfg.group_size
        # every rank holds an equal block of whole groups
        per_rank = -(-n // blocks.world_size)
        self.shard_rows = -(-per_rank // g) * g
        self.n_padded = self.shard_rows * blocks.world_size
        # (rows, scales, written) swapped as one tuple: a search snapshots
        # it whole; ``written`` (CUDA only) is recorded after the pair
        self._data: Tuple[torch.Tensor, Optional[torch.Tensor],
                          Optional[torch.cuda.Event]] = (
            self._to_device(embeddings if local
                            else self._own_rows(embeddings)))
        if passage_ids is None:
            passage_ids = np.arange(1, n + 1, dtype=np.int64)
        if passage_ids.shape != (n,):
            raise ValueError(f"passage_ids {passage_ids.shape} for {n} rows")
        self.row_to_passage_id = passage_ids

    def process_row_range(self) -> Tuple[int, int]:
        """This rank's [start, stop) of the padded rows (all of them on
        one rank), by its world rank."""
        return self.blocks.row_range(self.n_padded)

    def _own_rows(self, embeddings):
        """This rank's rows of the whole matrix (up to n_real)."""
        start, stop = self.process_row_range()
        return embeddings[start:min(stop, embeddings.shape[0])]

    @property
    def embeddings(self) -> torch.Tensor:
        return self._data[0]

    @property
    def scales(self) -> Optional[torch.Tensor]:
        return self._data[1]

    def local_block(self, embeddings) -> Tuple[torch.Tensor,
                                               Optional[torch.Tensor]]:
        """This rank's rows (numpy on the host, or a tensor anywhere; its
        real rows or its whole padded block) -> (rows, scales) as the index
        holds them, computed where the embeddings are: padded to
        ``shard_rows``, cast, or quantized to int8 rows and group scales.
        Padded input keeps its tail rows (the search masks them) unless the
        index is quantized: then they are zeroed, so they do not enter the
        last group's scale. An embedder on a card of its own runs this
        there, so an int8 block crosses to the trainer's card at half the
        bytes of its bf16 rows (``update_from_process_local``)."""
        t = torch.as_tensor(embeddings)
        start, stop = self.process_row_range()
        real = max(0, min(self.n_real, stop) - start)
        if self.quantized and t.shape[0] != real:
            t = t[:real]
        if t.shape[0] != self.shard_rows:
            t = F.pad(t, (0, 0, 0, self.shard_rows - t.shape[0]))
        if self.quantized:
            return quantize_int8(t, self.cfg.group_size)
        return t.to(self.cfg.dtype), None

    def _place(self, block):
        """(rows, scales) -> a fresh (rows, scales, written) triple on
        ``self.device``; ``written`` (CUDA only) is recorded after it."""
        rows, scales = block
        rows = rows.to(self.device).contiguous()
        if scales is not None:
            scales = scales.to(self.device)
        written = None
        if self.device.type == "cuda":
            written = torch.cuda.Event()
            written.record(torch.cuda.current_stream(self.device))
        return rows, scales, written

    def _to_device(self, embeddings):
        """This rank's rows -> (rows, scales, written) on ``self.device``;
        the cast or quantization runs where the embeddings are."""
        return self._place(self.local_block(embeddings))

    def update(self, embeddings: Union[np.ndarray, torch.Tensor],
               passage_ids: Optional[np.ndarray] = None,
               ready: Optional[torch.cuda.Event] = None) -> None:
        """Swap in fresh embeddings of the same shape — from the host, or a
        tensor already on the device (the JAX ``swap_device_array``, which
        takes the ``n_padded`` rows an embedder writes). ``ready``: the
        event after which a device tensor made on another stream is
        complete; the current stream waits for it."""
        if tuple(embeddings.shape) not in ((self.n_real, self.cfg.embed_dim),
                                           (self.n_padded,
                                            self.cfg.embed_dim)):
            raise ValueError(f"update must keep the shape "
                             f"{(self.n_real, self.cfg.embed_dim)} (or "
                             f"{self.n_padded} padded rows)")
        self._swap(self._own_rows(embeddings), passage_ids, ready)

    def update_from_process_local(self, local_rows, passage_ids=None,
                                  ready=None) -> None:
        """Swap in this rank's rows alone (``process_row_range()``: its
        real rows or the whole padded block), or the (rows, scales) pair
        ``local_block`` made of them; no rows cross between ranks. The
        refresh under data parallelism, where each rank embeds its own
        range. A block on another card (an embedder's) is copied card to
        card after ``ready``, the event after its last write."""
        if isinstance(local_rows, tuple):
            rows, scales = local_rows
            if (tuple(rows.shape) != (self.shard_rows, self.cfg.embed_dim)
                    or (scales is None) == self.quantized):
                raise ValueError(f"a block of {tuple(rows.shape)} rows "
                                 f"(scales {scales is not None}): want "
                                 f"{self.shard_rows} x {self.cfg.embed_dim}"
                                 f", scales {self.quantized}")
            self._swap(local_rows, passage_ids, ready, prepared=True)
            return
        start, stop = self.process_row_range()
        real = max(0, min(self.n_real, stop) - start)
        if (local_rows.shape[0] not in (real, stop - start)
                or local_rows.shape[1] != self.cfg.embed_dim):
            raise ValueError(f"rank rows {tuple(local_rows.shape)}: want "
                             f"{real} (or {stop - start}) x "
                             f"{self.cfg.embed_dim}")
        self._swap(local_rows, passage_ids, ready)

    def _swap(self, embeddings, passage_ids, ready,
              prepared: bool = False) -> None:
        """Make the tensors of ``embeddings`` (rows, or a prepared (rows,
        scales) pair) safe to read here, then place them. A CUDA tensor is
        read by the copy on the current stream of its own card (the
        trainer's stream when it lives there): that stream waits for
        ``ready`` and is recorded on the tensor, whose maker may free it as
        soon as this returns; a copy from another card also makes the
        trainer's stream wait for it (PyTorch's copy between devices)."""
        if passage_ids is not None:
            self.row_to_passage_id = passage_ids
        parts = embeddings if prepared else (embeddings,)
        for t in parts:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                stream = torch.cuda.current_stream(t.device)
                if ready is not None:
                    stream.wait_event(ready)
                t.record_stream(stream)
        self._data = (self._place(embeddings) if prepared
                      else self._to_device(embeddings))

    def search(self, query_embeds: torch.Tensor, k: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_embeds [nq, d] -> (scores [nq, k] fp32, row ids [nq, k]),
        on the index device. With ``dp`` every rank calls it with its own
        queries (equal nq) and gets global row ids."""
        cfg = self.cfg
        k = k if k is not None else cfg.topk
        # int8 index: queries stay fp32 (mips_topk quantizes per query)
        q = query_embeds.to(self.device,
                            torch.float32 if self.quantized else cfg.dtype)
        emb, scales, written = self._data
        if written is not None:
            # the pair was written on the updater's stream; it is read on
            # this one, and may be dropped by an update while the scan
            # below is still queued (the allocator ignores the stream
            # that made a tensor, so this is a no-op there)
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(written)
            for t in (emb, scales):
                if t is not None:
                    t.record_stream(stream)
        if self.blocks.distributed:
            return sharded_mips_topk(
                q, emb, k, self.dp, n_real=self.n_real, exact=cfg.exact,
                chunk_rows=cfg.chunk_rows, group_size=cfg.group_size,
                cands_per_group=cfg.cands_per_group, local_scales=scales)
        n_valid = self.n_real if self.n_padded != self.n_real else None
        vals, idx = mips_topk(q, emb, k, exact=cfg.exact,
                              chunk_rows=cfg.chunk_rows,
                              group_size=cfg.group_size,
                              cands_per_group=cfg.cands_per_group,
                              n_valid=n_valid, shard_scales=scales)
        vals = torch.where(idx < self.n_real, vals,
                           torch.full_like(vals, NEG_INF))
        return vals, idx

    def lookup_passage_ids(self, rows) -> np.ndarray:
        """Row ids -> passage ids on the host."""
        return np.take(self.row_to_passage_id, np.asarray(rows), mode="clip")
