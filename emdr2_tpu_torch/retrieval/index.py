"""Resident evidence index with MIPS search (one-device port of
``emdr2_tpu/retrieval/index.py:ShardedEvidenceIndex``).

The [N, d] embedding matrix lives on one device, in ``cfg.dtype`` or, with
``cfg.quantize == "int8"``, as int8 rows plus one fp32 scale per
``group_size`` rows. Rows are padded with zeros to a multiple of the group
so the candidate scan never copies the index; pad rows are masked in the
search (``n_valid``). Host embeddings are cast or quantized on the host
before upload (the final bytes cross the link); embeddings that already
live on the device are cast or quantized there.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from emdr2_tpu_torch.config import IndexConfig
from emdr2_tpu_torch.ops.mips import NEG_INF, mips_topk, quantize_int8


class ShardedEvidenceIndex:
    """Flat MIPS index; ``row_to_passage_id`` maps rows to corpus passage
    ids on the host."""

    def __init__(self, cfg: IndexConfig,
                 embeddings: Union[np.ndarray, torch.Tensor],
                 passage_ids: Optional[np.ndarray] = None,
                 device="cpu"):
        if cfg.quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', "
                             f"got {cfg.quantize!r}")
        n, d = embeddings.shape
        if d != cfg.embed_dim:
            raise ValueError(f"embeddings are {d}-d, config says "
                             f"{cfg.embed_dim}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.quantized = cfg.quantize == "int8"
        self.n_real = n
        g = cfg.group_size
        self.n_padded = -(-n // g) * g
        # (rows, scales) swapped as one tuple: a search snapshots the pair
        self._data: Tuple[torch.Tensor, Optional[torch.Tensor]] = (
            self._to_device(embeddings))
        if passage_ids is None:
            passage_ids = np.arange(1, n + 1, dtype=np.int64)
        if passage_ids.shape != (n,):
            raise ValueError(f"passage_ids {passage_ids.shape} for {n} rows")
        self.row_to_passage_id = passage_ids

    @property
    def embeddings(self) -> torch.Tensor:
        return self._data[0]

    @property
    def scales(self) -> Optional[torch.Tensor]:
        return self._data[1]

    def _to_device(self, embeddings):
        """Embeddings (numpy on the host, or a tensor anywhere) -> a fresh
        (rows, scales) pair on ``self.device``; the cast or quantization
        runs where the embeddings are."""
        t = torch.as_tensor(embeddings)
        if self.n_padded != self.n_real:
            t = F.pad(t, (0, 0, 0, self.n_padded - self.n_real))
        if self.quantized:
            q8, scales = quantize_int8(t, self.cfg.group_size)
            return (q8.to(self.device).contiguous(),
                    scales.to(self.device))
        return t.to(self.cfg.dtype).to(self.device).contiguous(), None

    def update(self, embeddings: Union[np.ndarray, torch.Tensor],
               passage_ids: Optional[np.ndarray] = None) -> None:
        """Swap in fresh embeddings of the same shape — from the host, or a
        tensor already on the device (the JAX ``swap_device_array``)."""
        if tuple(embeddings.shape) != (self.n_real, self.cfg.embed_dim):
            raise ValueError(f"update must keep the shape "
                             f"{(self.n_real, self.cfg.embed_dim)}")
        if passage_ids is not None:
            self.row_to_passage_id = passage_ids
        self._data = self._to_device(embeddings)

    def search(self, query_embeds: torch.Tensor, k: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_embeds [nq, d] -> (scores [nq, k] fp32, row ids [nq, k]),
        on the index device."""
        cfg = self.cfg
        k = k if k is not None else cfg.topk
        # int8 index: queries stay fp32 (mips_topk quantizes per query)
        q = query_embeds.to(self.device,
                            torch.float32 if self.quantized else cfg.dtype)
        emb, scales = self._data
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
