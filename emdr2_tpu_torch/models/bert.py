"""BERT encoder and dual encoder (port of ``emdr2_tpu/models/bert.py``).

The retrieval embedding is the raw CLS-token hidden state, in fp32. Both
towers train: ``drop`` (the step's ``DropoutSeeds``, ``None`` to evaluate)
turns dropout on.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from emdr2_tpu_torch.config import RetrieverConfig, TransformerConfig
from emdr2_tpu_torch.data import masks
from emdr2_tpu_torch.models.layers import Embeddings, TransformerStack
from emdr2_tpu_torch.ops.hashing import DropoutSeeds, fold


class BertEncoder(nn.Module):
    """Embeddings (word + position + tokentype) + pre-LN transformer."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.embeddings = Embeddings(cfg, device)
        self.encoder = TransformerStack(cfg, device=device)

    def forward(self, ids, tokentype_ids=None,
                drop: Optional[DropoutSeeds] = None):
        x = self.embeddings(ids, tokentype_ids=tokentype_ids,
                            drop=fold(drop, 0))
        return self.encoder.encode(x, masks.padding_bias(ids), fold(drop, 1))

    def embed(self, ids, tokentype_ids=None,
              drop: Optional[DropoutSeeds] = None):
        """CLS-token hidden state [B, H] as the retrieval embedding."""
        return self(ids, tokentype_ids, drop)[:, 0, :]


class DualEncoder(nn.Module):
    """Separate query and context towers."""

    def __init__(self, cfg: RetrieverConfig, device=None):
        super().__init__()
        self.query_model = BertEncoder(cfg.encoder, device)
        self.context_model = BertEncoder(cfg.encoder, device)

    def embed_query(self, ids, tokentype_ids=None,
                    drop: Optional[DropoutSeeds] = None) -> torch.Tensor:
        return self.query_model.embed(ids, tokentype_ids, drop).float()

    def embed_context(self, ids, tokentype_ids=None,
                      drop: Optional[DropoutSeeds] = None) -> torch.Tensor:
        return self.context_model.embed(ids, tokentype_ids, drop).float()
