"""T5 reader with learned absolute positions (port of the eval side of
``emdr2_tpu/models/t5.py``): shared word embeddings, a tied LM head with a
trainable bias, and an encoder whose states the FiD decoder cross-attends.

Decoding here is incremental only (``decode_step=True`` in the JAX package):
a ``DecodeCache`` holds the decoder self-attention K/V and the
cross-attention K/V arrive precomputed per layer. The teacher's
``decode_gold_log_probs`` and the whole-prefix decode come with training.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from emdr2_tpu_torch.config import TransformerConfig
from emdr2_tpu_torch.data import masks
from emdr2_tpu_torch.models.layers import (DecodeCache, Embeddings,
                                           TransformerStack)


class T5Model(nn.Module):

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.shared_embeddings = Embeddings(cfg, device)
        self.encoder = TransformerStack(cfg, device=device)
        self.decoder = TransformerStack(cfg, has_cross_attention=True,
                                        device=device)
        self.lm_bias = nn.Parameter(torch.empty(cfg.vocab_size,
                                                dtype=torch.float32,
                                                device=device))

    def reset_parameters(self, generator=None):
        nn.init.zeros_(self.lm_bias)

    def encode(self, enc_ids):
        """[B, L] ids -> [B, L, H] encoder states (key-side pad bias; the
        flash kernel runs when configured)."""
        x = self.shared_embeddings(enc_ids)
        return self.encoder.encode(x, masks.padding_bias(enc_ids))

    def _decode_hidden(self, dec_ids, cross_kvs, cross_bias,
                       cache: DecodeCache, position_offset: int = 0):
        """New decoder positions dec_ids [B, Lq] -> pre-head hidden
        [B, Lq, H]; self-attention causality comes from the cache."""
        x = self.shared_embeddings(dec_ids, position_offset=position_offset)
        return self.decoder.decode(x, cache, cross_kvs, cross_bias)

    def decode(self, dec_ids, cross_kvs, cross_bias, cache: DecodeCache,
               position_offset: int = 0):
        """-> [B, Lq, V] fp32 logits. ``cross_bias`` [B, Lk] is the
        key-side bias of the encoder positions."""
        x = self._decode_hidden(dec_ids, cross_kvs, cross_bias, cache,
                                position_offset)
        return self.shared_embeddings.attend(x) + self.lm_bias
