"""BERT encoder, BERT with its pretraining heads, and the dual encoder
(port of ``emdr2_tpu/models/bert.py``).

The retrieval embedding is the raw CLS-token hidden state, in fp32. Both
towers train: ``drop`` (the step's ``DropoutSeeds``, ``None`` to evaluate)
turns dropout on. ``BertPretrainModel`` carries the masked-LM and binary
heads that the reference's BERT checkpoints hold
(``tools/convert_reference_checkpoint.py`` converts them into it). Every
module takes ``tp``, the tensor-parallel group its layers split over
(``models/layers.py``); the embedding and the towers' outputs are whole
on every tp rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from emdr2_tpu_torch.config import RetrieverConfig, TransformerConfig
from emdr2_tpu_torch.data import masks
from emdr2_tpu_torch.models.layers import (Dense, Embeddings, LayerNorm,
                                           TransformerStack, gelu)
from emdr2_tpu_torch.ops.fid_attention import check_kernel_limits
from emdr2_tpu_torch.ops.hashing import DropoutSeeds, fold
from emdr2_tpu_torch.parallel.mesh import Group
from emdr2_tpu_torch.parallel.tensor import gather_from_tp


class BertEncoder(nn.Module):
    """Embeddings (word + position + tokentype) + pre-LN transformer."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 tp: Optional[Group] = None):
        super().__init__()
        self.embeddings = Embeddings(cfg, device, tp)
        self.encoder = TransformerStack(cfg, device=device, tp=tp)

    def forward(self, ids, tokentype_ids=None,
                drop: Optional[DropoutSeeds] = None):
        x = self.embeddings(ids, tokentype_ids=tokentype_ids,
                            drop=fold(drop, 0))
        return self.encoder.encode(x, masks.padding_bias(ids), fold(drop, 1))

    def embed(self, ids, tokentype_ids=None,
              drop: Optional[DropoutSeeds] = None):
        """CLS-token hidden state [B, H] as the retrieval embedding."""
        return self(ids, tokentype_ids, drop)[:, 0, :]


class BertPretrainModel(nn.Module):
    """BERT with the pretraining heads: the masked-LM head (dense -> GELU ->
    LayerNorm -> projection onto the tied word embeddings + a vocab bias)
    and, with ``add_binary_head``, a tanh pooler over the CLS state and a
    two-way head. ``forward`` returns (lm_logits [B, L, V] fp32,
    binary_logits [B, 2] fp32 or None). Under ``tp`` the LM bias splits
    over the vocabulary with the word embeddings, and the rank's logits
    are gathered over tp."""

    def __init__(self, cfg: TransformerConfig, add_binary_head: bool = True,
                 device=None, tp: Optional[Group] = None):
        super().__init__()
        h, dt, std = cfg.hidden_size, cfg.dtype, cfg.init_std
        self.cfg = cfg
        self.tp = tp if tp is not None else Group.local()
        self.bert = BertEncoder(cfg, device, tp)
        self.lm_dense = Dense(h, h, dt, std, device=device)
        self.lm_layernorm = LayerNorm(h, cfg.layernorm_epsilon, device)
        self.lm_bias = nn.Parameter(torch.empty(
            cfg.vocab_size // self.tp.world_size, dtype=torch.float32,
            device=device))
        self.add_binary_head = add_binary_head
        if add_binary_head:
            self.pooler = Dense(h, h, dt, std, device=device)
            self.binary_head = Dense(h, 2, dt, std, device=device)

    def reset_parameters(self, generator=None):
        nn.init.zeros_(self.lm_bias)

    def forward(self, ids, tokentype_ids=None,
                drop: Optional[DropoutSeeds] = None):
        hidden = self.bert(ids, tokentype_ids, drop)
        h = self.lm_layernorm(gelu(self.lm_dense(hidden),
                                   self.cfg.gelu_variant))
        lm_logits = gather_from_tp(
            self.bert.embeddings.attend(h) + self.lm_bias.float(), self.tp)
        binary = None
        if self.add_binary_head:
            pooled = torch.tanh(self.pooler(hidden[:, 0, :]))
            binary = self.binary_head(pooled).float()
        return lm_logits, binary


class DualEncoder(nn.Module):
    """Separate query and context towers. Either tower can be used alone;
    ``forward`` returns (query embeddings, context embeddings) in fp32,
    ``None`` for a tower given no ids."""

    def __init__(self, cfg: RetrieverConfig, device=None,
                 tp: Optional[Group] = None):
        """On a card, a configuration the attention kernels do not take
        (``ops.fid_attention.kernel_limits``) raises here. ``tp``: the
        tensor-parallel group both towers split over."""
        super().__init__()
        enc = cfg.encoder
        if device is not None and torch.device(device).type == "cuda":
            check_kernel_limits(f"DualEncoder on {device}", enc.dtype,
                                enc.head_dim, None, enc.fid_flash_attention)
        self.query_model = BertEncoder(cfg.encoder, device, tp)
        self.context_model = BertEncoder(cfg.encoder, device, tp)

    def forward(self, query_ids=None, context_ids=None, query_types=None,
                context_types=None, drop: Optional[DropoutSeeds] = None):
        q = c = None
        if query_ids is not None:
            q = self.embed_query(query_ids, query_types, fold(drop, 0))
        if context_ids is not None:
            c = self.embed_context(context_ids, context_types, fold(drop, 1))
        return q, c

    def embed_query(self, ids, tokentype_ids=None,
                    drop: Optional[DropoutSeeds] = None) -> torch.Tensor:
        return self.query_model.embed(ids, tokentype_ids, drop).float()

    def embed_context(self, ids, tokentype_ids=None,
                      drop: Optional[DropoutSeeds] = None) -> torch.Tensor:
        return self.context_model.embed(ids, tokentype_ids, drop).float()
