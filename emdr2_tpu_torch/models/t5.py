"""T5 reader with learned absolute positions (port of
``emdr2_tpu/models/t5.py``): shared word embeddings, a tied LM head with a
trainable bias, and an encoder whose states the FiD decoder cross-attends.
With T5 v1.1's block (``config.t5_v11``: relative positions held by each
stack, no position embeddings) the head is ``lm_head`` [V, H], untied,
with no bias and no rescale; such a reader trains and scores (``encode``,
``decode``, ``decode_gold_log_probs``) but neither generates
(``decode_step``, the K5 kernel) nor splits over tensor parallelism: both
raise, naming what is missing.

Two decoders share the weights: ``decode`` runs the whole prefix (training
and the teacher; causal self-attention bias, FiD cross-attention through the
K2 flash kernel when configured), and ``decode_step`` runs new positions
incrementally for generation over a ``DecodeCache`` and cross-attention K/V
precomputed per layer. ``decode_gold_log_probs`` is the teacher's head: an
online logsumexp over vocab chunks, never holding the [*, L, V] logits.

Tensor parallelism (``tp``): the layers split over it (``models/layers.py``)
and so does the vocabulary: ``decode`` gives the rank's [B, Ld, V/tp]
logits (the reader loss is vocab-parallel, ``training/losses.py``),
``decode_step`` the whole [B, Lq, V] (gathered over tp, so every rank
picks the same tokens), and ``decode_gold_log_probs`` combines the ranks'
online logsumexps with a max and a sum over tp (the JAX
``_vocab_parallel_gold_log_probs``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from emdr2_tpu_torch.config import TransformerConfig
from emdr2_tpu_torch.data import masks
from emdr2_tpu_torch.models.layers import (DecodeCache, Embeddings,
                                           TransformerStack)
from emdr2_tpu_torch.ops.hashing import DropoutSeeds, fold
from emdr2_tpu_torch.parallel.mesh import Group
from emdr2_tpu_torch.parallel.tensor import gather_from_tp, is_split


class T5Model(nn.Module):

    def __init__(self, cfg: TransformerConfig, device=None,
                 tp: Optional[Group] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp if tp is not None else Group.local()
        if cfg.block == "t5_v11" and is_split(self.tp):
            raise NotImplementedError(
                "tensor parallelism (--tp > 1) is not built for T5 v1.1's "
                "block: the relative-position table, the gated MLP and the "
                "untied head have no split layouts")
        self.shared_embeddings = Embeddings(cfg, device, tp)
        self.encoder = TransformerStack(cfg, device=device, tp=tp)
        self.decoder = TransformerStack(cfg, has_cross_attention=True,
                                        device=device, tp=tp)
        V = cfg.vocab_size // self.tp.world_size
        if cfg.block == "megatron":
            self.lm_bias = nn.Parameter(torch.empty(
                V, dtype=torch.float32, device=device))
            self.register_parameter("lm_head", None)
        else:
            self.register_parameter("lm_bias", None)
            self.lm_head = nn.Parameter(torch.empty(
                V, cfg.hidden_size, dtype=torch.float32, device=device))

    def reset_parameters(self, generator=None):
        if self.lm_bias is not None:
            nn.init.zeros_(self.lm_bias)
        else:
            with torch.no_grad():
                self.lm_head.normal_(0.0, self.cfg.init_std,
                                     generator=generator)

    def head(self, x):
        """[..., H] -> fp32 logits (this rank's V/tp): the tied embeddings
        and the bias, or the untied head."""
        if self.lm_head is not None:
            return self.shared_embeddings.attend(x, self.lm_head)
        return self.shared_embeddings.attend(x) + self.lm_bias

    def encode(self, enc_ids, drop: Optional[DropoutSeeds] = None):
        """[B, L] ids -> [B, L, H] encoder states (key-side pad bias; the
        flash kernel runs when configured)."""
        x = self.shared_embeddings(enc_ids, drop=fold(drop, 0))
        return self.encoder.encode(x, masks.padding_bias(enc_ids),
                                   fold(drop, 1))

    def _decode_hidden(self, dec_ids, enc_hidden, enc_dec_mask,
                       drop: Optional[DropoutSeeds] = None):
        """Whole-prefix decoder -> [B, Ld, H] pre-head hidden states, shared
        by ``decode`` and ``decode_gold_log_probs``. ``enc_dec_mask``
        [B, Ld, Lk] bool (True = may attend). The flash path's key-side bias
        is row 0 of that mask, as in the JAX package; the plain path takes
        the whole [B, 1, Ld, Lk] bias."""
        x = self.shared_embeddings(dec_ids, drop=fold(drop, 2))
        self_bias = masks.mask_to_bias(
            masks.self_attention_mask(dec_ids, causal=True))[:, None]
        kv_bias = cross_bias = None
        if self.cfg.fid_flash_attention:
            kv_bias = masks.mask_to_bias(enc_dec_mask[:, 0, :])
        else:
            cross_bias = masks.mask_to_bias(enc_dec_mask)[:, None]
        return self.decoder.decode_full(x, enc_hidden, self_bias, kv_bias,
                                        cross_bias, fold(drop, 3))

    def decode(self, dec_ids, enc_hidden, enc_dec_mask,
               drop: Optional[DropoutSeeds] = None):
        """Whole-prefix decoder -> [B, Ld, V] fp32 logits (this rank's
        [B, Ld, V/tp] under tp)."""
        x = self._decode_hidden(dec_ids, enc_hidden, enc_dec_mask, drop)
        return self.head(x)

    def decode_gold_log_probs(self, dec_ids, enc_hidden, enc_dec_mask,
                              labels, drop: Optional[DropoutSeeds] = None):
        """Gold-token log-probs [B, Ld] fp32 of the whole-prefix decoder,
        the LM head taken as an online logsumexp over 4 vocab chunks (a
        dense head when the vocab does not divide by 4): exact up to
        summation order against ``decode``. Under tp each rank runs the
        online pass over its ``V / tp`` rows, then the ranks' maxima (a
        max over tp), rescaled sums of exps and masked gold picks (one sum
        over tp) combine: no [*, L, V] tensor, no gathered vocabulary."""
        x = self._decode_hidden(dec_ids, enc_hidden, enc_dec_mask, drop)
        emb = (self.shared_embeddings.word_embeddings if self.lm_head is None
               else self.lm_head)                          # [V/tp, H] fp32
        V = emb.shape[0]
        base0 = self.tp.rank * V if is_split(self.tp) else 0
        xf = x.float()
        if V % 4:
            logits = self.head(x).float()
            if not is_split(self.tp):
                lse = torch.logsumexp(logits, dim=-1)
                picked = logits.gather(-1, labels[..., None])[..., 0]
                return picked - lse
            m = logits.amax(dim=-1)
            s = torch.exp(logits - m[..., None]).sum(dim=-1)
            mine = (labels >= base0) & (labels < base0 + V)
            idx = (labels - base0).clamp(0, V - 1)
            val = logits.gather(-1, idx[..., None])[..., 0]
            picked = torch.where(mine, val, torch.zeros_like(val))
            return self._combine_vocab(m, s, picked)
        chunk = V // 4
        m = torch.full(labels.shape, -float("inf"), device=x.device)
        s = torch.zeros(labels.shape, device=x.device)
        picked = torch.zeros(labels.shape, device=x.device)
        for c in range(4):
            lo = c * chunk
            w = emb[lo:lo + chunk].to(x.dtype).float()
            lc = torch.matmul(xf, w.T)
            if self.lm_bias is not None:
                lc = lc + self.lm_bias[lo:lo + chunk]
            m_new = torch.maximum(m, lc.amax(dim=-1))
            s = (s * torch.exp(m - m_new)
                 + torch.exp(lc - m_new[..., None]).sum(dim=-1))
            base = base0 + lo
            in_chunk = (labels >= base) & (labels < base + chunk)
            idx = (labels - base).clamp(0, chunk - 1)
            val = lc.gather(-1, idx[..., None])[..., 0]
            picked = torch.where(in_chunk, val, picked)
            m = m_new
        return self._combine_vocab(m, s, picked)

    def _combine_vocab(self, m, s, picked):
        """gold - logsumexp from a rank's (max, sum of exp(l - max), masked
        gold pick) over its vocabulary rows: with one rank the rows are the
        whole vocabulary; under tp a max over the ranks (no gradient: the
        shift cancels), then one sum of the rescaled sums and the picks."""
        if not is_split(self.tp):
            return picked - (torch.log(s) + m)
        g = self.tp.all_reduce_max_(m.detach().clone())
        both = self.tp.all_reduce_sum_(torch.stack(
            [s * torch.exp(m - g), picked]))
        return both[1] - (torch.log(both[0]) + g)

    def _decode_step_hidden(self, dec_ids, cross_kvs, cross_bias,
                            cache: DecodeCache, position_offset: int = 0):
        """New decoder positions dec_ids [B, Lq] -> pre-head hidden
        [B, Lq, H]; self-attention causality comes from the cache."""
        if self.cfg.block == "t5_v11":
            raise NotImplementedError(
                "generation (decode_step and the K5 int8 decode kernel) is "
                "not built for the relative-position block: the KV-cached "
                "decoder has no relative-position bias")
        x = self.shared_embeddings(dec_ids, position_offset=position_offset)
        return self.decoder.decode(x, cache, cross_kvs, cross_bias)

    def decode_step(self, dec_ids, cross_kvs, cross_bias, cache: DecodeCache,
                    position_offset: int = 0):
        """Incremental decoder -> [B, Lq, V] fp32 logits, whole on every
        rank (gathered over tp). ``cross_bias`` [B, Lk] is the key-side
        bias of the encoder positions."""
        x = self._decode_step_hidden(dec_ids, cross_kvs, cross_bias, cache,
                                     position_offset)
        return gather_from_tp(self.head(x), self.tp)
