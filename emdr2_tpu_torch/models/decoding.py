"""Greedy answer generation (port of the greedy side of
``emdr2_tpu/models/decoding.py``).

Retrieval and FiD encoding happen once per batch; the token loop then runs
over a decoder self-attention ``DecodeCache`` and per-layer cross-attention
K/V projected once (``DecoderSession.cross_kvs``), pre-headed as
[B, nh, Lk, hd]. The loop is a host loop of eager steps that exits early
once every row has produced EOS. Beam search, sampling and int8 cross K/V
(the K5 kernel) come in later work.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from emdr2_tpu_torch.models.emdr2 import EMDR2Batch, EMDR2Model
from emdr2_tpu_torch.models.layers import DecodeCache
from emdr2_tpu_torch.utils.timing import StageTimer, stage


def bf16_eval_params(model: nn.Module) -> nn.Module:
    """Store every fp32 kernel of rank >= 2 in bf16, in place; returns
    ``model``.

    Outputs are unchanged: the layers cast kernels to the compute dtype at
    the use site, so pre-rounded storage hands the matmuls the same
    operands. Rank-0/1 parameters (LayerNorm, biases, the LM bias) and the
    embedding tables stay fp32 — the embeddings are summed in fp32 before
    the cast, so rounding the tables would change that sum."""
    for name, p in model.named_parameters():
        if p.dtype == torch.float32 and p.dim() >= 2 \
                and "embeddings" not in name:
            p.data = p.data.to(torch.bfloat16)
    return model


# Row budget per FiD-encode block: batches with B*K above it encode in
# K-blocks of at most this many rows (exact: rows encode independently).
ENCODE_CHUNK_ROWS_AUTO = 400


def _encode_chunk_k(B: int, K: int, max_rows: int) -> int:
    """Largest divisor of K whose block (B * chunk_k rows) fits the budget;
    K itself when the whole batch fits (no chunking)."""
    if B * K <= max_rows:
        return K
    best = 1
    for d in range(1, K + 1):
        if K % d == 0 and B * d <= max_rows:
            best = d
    return best


class DecoderSession:
    """Encode a batch once, then decode tokens over cached states."""

    def __init__(self, model: EMDR2Model, max_decode_len: int,
                 encode_chunk_rows: Optional[int] = None,
                 timer: Optional[StageTimer] = None):
        self.model = model
        self.max_decode_len = max_decode_len
        self.encode_chunk_rows = (ENCODE_CHUNK_ROWS_AUTO
                                  if encode_chunk_rows is None
                                  else encode_chunk_rows)
        self.timer = timer

    @torch.inference_mode()
    def encode(self, batch: EMDR2Batch):
        """-> (per-layer cross K/V, enc_flat_ids [B, K*Lr])."""
        with stage(self.timer, "encode"):
            reader_ids = batch.reader_ids
            B, K, Lr = reader_ids.shape
            chunk_k = _encode_chunk_k(B, K, self.encode_chunk_rows)
            if chunk_k == K:
                _, hidden, flat = self.model.encode_for_generation(batch)
            else:
                blocks = [self.model.fid_encode(
                    reader_ids[:, c:c + chunk_k])[0]
                    for c in range(0, K, chunk_k)]
                hidden = torch.cat(blocks, dim=1)
                flat = reader_ids.reshape(B, K * Lr)
        with stage(self.timer, "cross_kv"):
            kvs = self.cross_kvs(hidden)
        return kvs, flat

    def cross_kvs(self, enc_hidden: torch.Tensor):
        """Per decoder layer, the encoder-state (k, v) projections, each
        [B, nh, Lk, hd]. k is held as fp32 copies of its compute-dtype
        values, so each step's score product yields fp32 scores (the JAX
        package's preferred_element_type) without a per-step cast."""
        cfg = self.model.config.reader.transformer
        B, Lk = enc_hidden.shape[:2]
        nh, hd = cfg.num_heads, cfg.head_dim
        decoder = self.model.reader.decoder
        outs = []
        for i in range(cfg.num_layers):
            kv = decoder.layer(i).cross_attention.key_value(enc_hidden)
            kv = kv.view(B, Lk, 2, nh, hd).permute(2, 0, 3, 1, 4)
            outs.append((kv[0].float().contiguous(), kv[1].contiguous()))
        return outs

    def new_cache(self, rows: int, device) -> DecodeCache:
        cfg = self.model.config.reader.transformer
        return DecodeCache(cfg.num_layers, rows, cfg.num_heads,
                           self.max_decode_len, cfg.head_dim, cfg.dtype,
                           device)

    @torch.inference_mode()
    def greedy_loop(self, kvs, enc_flat_ids, bos_id: int,
                    eos_id: int) -> torch.Tensor:
        """Argmax token loop -> [B, max_decode_len] ids (0 past the exit).
        Stops once every row has emitted EOS."""
        with stage(self.timer, "decode"):
            B = enc_flat_ids.shape[0]
            dev = enc_flat_ids.device
            cache = self.new_cache(B, dev)
            tok = torch.full((B, 1), bos_id, dtype=torch.long, device=dev)
            out = torch.zeros((B, self.max_decode_len), dtype=torch.long,
                              device=dev)
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            for pos in range(self.max_decode_len):
                logits = self.model.decode_step(tok, enc_flat_ids, kvs, cache,
                                                position_offset=pos)
                lp = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
                ys = torch.argmax(lp, dim=-1)        # first max on ties
                out[:, pos] = ys
                done |= ys == eos_id
                tok = ys[:, None]
                if bool(done.all()):
                    break
            return out


def _strip_eos(rows: np.ndarray, eos_id: int) -> List[List[int]]:
    """Cut at first EOS; empty -> [1]."""
    outs = []
    for y in rows:
        y = [int(t) for t in y]
        if eos_id in y:
            y = y[: y.index(eos_id)]
        outs.append(y if y else [1])
    return outs


def greedy_decode(session: DecoderSession, batch: EMDR2Batch,
                  bos_id: int, eos_id: int) -> List[List[int]]:
    """Greedy generation for every row of ``batch``."""
    kvs, enc_flat_ids = session.encode(batch)
    out = session.greedy_loop(kvs, enc_flat_ids, bos_id, eos_id)
    return _strip_eos(out.cpu().numpy(), eos_id)
