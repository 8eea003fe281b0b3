"""EMDR2 joint retriever + reader (port of the generation-time entry points
of ``emdr2_tpu/models/emdr2.py``). The training forward (retriever scores,
teacher) comes with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from emdr2_tpu_torch.config import EMDR2Config
from emdr2_tpu_torch.data import masks
from emdr2_tpu_torch.models.bert import DualEncoder
from emdr2_tpu_torch.models.layers import DecodeCache, init_weights
from emdr2_tpu_torch.models.t5 import T5Model


class EMDR2Batch(NamedTuple):
    """Device inputs for one batch after host-side retrieval. Shapes: B =
    batch, K = topk, Lq/Lc = retriever query/context lengths, Lr = reader
    length, Ld = decoder length."""

    query_bert_ids: torch.Tensor        # [B, Lq]  int
    context_bert_ids: torch.Tensor      # [B, K, Lc]
    context_bert_types: torch.Tensor    # [B, K, Lc]
    reader_ids: torch.Tensor            # [B, K, Lr] query + extended context
    reader_one_ctx_ids: torch.Tensor    # [B, K, Lr] query + single context
    dec_ids: torch.Tensor               # [B, Ld]
    labels: torch.Tensor                # [B, Ld]
    loss_mask: torch.Tensor             # [B, Ld] float


class EMDR2Model(nn.Module):

    def __init__(self, config: EMDR2Config, device=None,
                 generator: Optional[torch.Generator] = None):
        """Parameters are made on ``device`` and initialized from
        ``generator`` like the JAX package's init (load converted weights
        with ``load_state_dict`` to replace them)."""
        super().__init__()
        self.config = config
        self.retriever = DualEncoder(config.retriever, device)
        self.reader = T5Model(config.reader.transformer, device)
        init_weights(self, generator)

    def embed_query(self, query_bert_ids):
        """[B, Lq] -> [B, d] fp32 query embeddings for the MIPS search."""
        return self.retriever.embed_query(query_bert_ids)

    def fid_encode(self, reader_ids):
        """[B, Kc, Lr] -> (hidden [B, Kc*Lr, H], flat ids [B, Kc*Lr]); each
        context row encodes independently, so K-blocks may be encoded
        separately and concatenated."""
        B, K, Lr = reader_ids.shape
        hidden = self.reader.encode(reader_ids.reshape(B * K, Lr))
        return (hidden.reshape(B, K * Lr, hidden.shape[-1]),
                reader_ids.reshape(B, K * Lr))

    def encode_for_generation(self, batch: EMDR2Batch):
        """-> (None, enc_hidden, enc_flat_ids): generation needs only the FiD
        encoder states (the JAX ``with_scores=False`` path; the retriever
        scores come with the training slice)."""
        enc_hidden, enc_flat_ids = self.fid_encode(batch.reader_ids)
        return None, enc_hidden, enc_flat_ids

    def decode_step(self, dec_ids, enc_flat_ids, cross_kvs,
                    cache: DecodeCache, position_offset: int = 0):
        """Incremental decode of dec_ids [B, Lq] over precomputed per-layer
        cross K/V and the self-attention cache -> [B, Lq, V] fp32 logits."""
        cross_bias = masks.padding_bias(enc_flat_ids)
        return self.reader.decode(dec_ids, cross_kvs, cross_bias, cache,
                                  position_offset)
