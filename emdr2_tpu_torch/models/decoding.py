"""Answer generation: greedy or sampling, and length-normalized beam search
(port of ``emdr2_tpu/models/decoding.py``).

Retrieval and FiD encoding happen once per batch; the token loops then run
over a decoder self-attention ``DecodeCache`` and per-layer cross-attention
K/V projected once (``DecoderSession.cross_kvs``), pre-headed as
[B, nh, Lk, hd], or, with ``kv_quant="int8"``, stored as int8 rows with
per-row scales and read by the K5 decode kernel
(``ops/decode_attention.py``). Beam search keeps the K/V at one row per
example: the beams fold into query rows (``layers.Attention.cross``).

Beam search follows the JAX package step for step: polynomial length
normalization during the search (``length_penalty``), an ended hypothesis
frozen (its score kept, only its first continuation alive through a -1e4
bias, its token forced to EOS), parent gather and cache reorder per step,
the best hypothesis per example at the end. Ties in a top-k go to the lower
index, as ``jax.lax.top_k`` breaks them.

The loops are host loops of eager steps that exit early once every row has
produced EOS. All of it runs under ``torch.inference_mode``, no dropout.

Under tensor parallelism each rank holds the cross K/V and the cache of
its ``nh / tp`` heads (the int8 form and K5 too, as the JAX
``decode_cross_attention_int8_sharded`` runs it), and each step's logits
are gathered over tp before the top-k or the draw
(``T5Model.decode_step``), so every rank picks the same tokens.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from emdr2_tpu_torch.models.emdr2 import EMDR2Batch, EMDR2Model
from emdr2_tpu_torch.models.layers import DecodeCache
from emdr2_tpu_torch.ops.decode_attention import (padded_rows,
                                                  quantize_kv_rows)
from emdr2_tpu_torch.utils.timing import StageTimer, stage


def length_penalty(n, alpha: float = 0.6):
    """Polynomial length normalization ``(5+n)^alpha / 6^alpha`` (``n`` a
    number or an fp32 tensor)."""
    return (5.0 + n) ** alpha / (5.0 + 1.0) ** alpha


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equals (``torch.topk`` does not promise an order on
    ties; a stable descending sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    """Encode a batch once, then decode tokens over cached states.
    ``kv_quant="int8"`` stores the cross K/V slab as int8 rows with per-row
    scales: half the bytes held and read per step."""

    def __init__(self, model: EMDR2Model, max_decode_len: int,
                 kv_quant: Optional[str] = None,
                 encode_chunk_rows: Optional[int] = None,
                 timer: Optional[StageTimer] = None):
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', {kv_quant!r}")
        self.model = model
        self.max_decode_len = max_decode_len
        self.kv_quant = kv_quant
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
        """Per decoder layer, the encoder-state K/V projections, pre-headed
        [B, nh, Lk, hd]: (k, v), with k held as fp32 copies of its
        compute-dtype values, so each step's score product yields fp32
        scores (the JAX package's preferred_element_type) without a
        per-step cast; or, under ``kv_quant="int8"``, (k8, kscale, v8,
        vscale) with the key rows padded to ``padded_rows(Lk)`` at value 0
        and scale 1 (the attention bias marks them -1e9), and no fp32 copy
        of k."""
        cfg = self.model.config.reader.transformer
        B, Lk = enc_hidden.shape[:2]
        nh, hd = self._heads(), cfg.head_dim
        decoder = self.model.reader.decoder
        decoder.check_decode()
        outs = []
        for i in range(cfg.num_layers):
            kv = decoder.layer(i).cross_attention.key_value(enc_hidden)
            kv = kv.view(B, Lk, 2, nh, hd).permute(2, 0, 3, 1, 4)
            if self.kv_quant == "int8":
                pad = padded_rows(Lk) - Lk
                k8, ks = quantize_kv_rows(kv[0])
                v8, vs = quantize_kv_rows(kv[1])
                if pad:
                    k8, v8 = (F.pad(a, (0, 0, 0, pad)) for a in (k8, v8))
                    ks, vs = (F.pad(a, (0, pad), value=1.0) for a in (ks, vs))
                outs.append(tuple(a.contiguous() for a in (k8, ks, v8, vs)))
            else:
                outs.append((kv[0].float().contiguous(), kv[1].contiguous()))
        return outs

    def _heads(self) -> int:
        """The decoder heads of this rank (``num_heads / tp``)."""
        return self.model.reader.decoder.layer(0).self_attention.nh

    def new_cache(self, rows: int, device) -> DecodeCache:
        cfg = self.model.config.reader.transformer
        return DecodeCache(cfg.num_layers, rows, self._heads(),
                           self.max_decode_len, cfg.head_dim, cfg.dtype,
                           device)

    def _step_lp(self, tok, enc_flat_ids, kvs, cache, pos: int):
        """One decoder step -> log-probs [rows, V] fp32."""
        logits = self.model.decode_step(tok, enc_flat_ids, kvs, cache,
                                        position_offset=pos)
        return torch.log_softmax(logits[:, -1, :].float(), dim=-1)

    @torch.inference_mode()
    def token_loop(self, kvs, enc_flat_ids, bos_id: int, eos_id: int,
                   rng: Optional[torch.Generator] = None,
                   sample: bool = False,
                   rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Argmax token loop, or with ``sample`` a draw from each step's
        categorical by ``rng`` (a generator on the model's device) ->
        [B, max_decode_len] ids (0 past the exit). Stops once every row has
        emitted EOS.

        A draw is by inverse CDF from one uniform a row a step, the
        uniforms of the global batch drawn in one call: ``rows`` = (this
        batch's first global row, the global batch's rows) under data
        parallelism, so rank r's rows get the draws a single process gets
        for them (every rank seeds ``rng`` alike)."""
        if sample and rng is None:
            raise ValueError("sampling decode needs an rng generator")
        with stage(self.timer, "decode"):
            B = enc_flat_ids.shape[0]
            dev = enc_flat_ids.device
            cache = self.new_cache(B, dev)
            tok = torch.full((B, 1), bos_id, dtype=torch.long, device=dev)
            out = torch.zeros((B, self.max_decode_len), dtype=torch.long,
                              device=dev)
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            for pos in range(self.max_decode_len):
                lp = self._step_lp(tok, enc_flat_ids, kvs, cache, pos)
                if sample:
                    first, total = rows if rows is not None else (0, B)
                    u = torch.rand(total, generator=rng, device=dev,
                                   dtype=torch.float32)[first:first + B]
                    ys = _inverse_cdf(lp, u)
                else:
                    ys = torch.argmax(lp, dim=-1)    # first max on ties
                out[:, pos] = ys
                done |= ys == eos_id
                tok = ys[:, None]
                if bool(done.all()):
                    break
            return out

    @torch.inference_mode()
    def beam_loop(self, kvs, enc_flat_ids, bos_id: int, eos_id: int,
                  beam_size: int, alpha: float) -> torch.Tensor:
        """Length-normalized beam search -> the best hypothesis per example,
        [B, max_decode_len] ids.

        Step 0 runs on B rows and fans out to B*k; later steps run B*k rows
        (the k beams of an example consecutive) against the K/V of B
        examples. ``total`` holds the length-normalized running score; each
        step un-normalizes by lp(len-1), adds the token log-prob and
        re-normalizes by lp(len)."""
        with stage(self.timer, "decode"):
            k = beam_size
            B = enc_flat_ids.shape[0]
            dev = enc_flat_ids.device
            max_len = self.max_decode_len
            cache = self.new_cache(B, dev)
            tok0 = torch.full((B, 1), bos_id, dtype=torch.long, device=dev)
            lp0 = self._step_lp(tok0, enc_flat_ids, kvs, cache, 0)
            top_sc, top_idx = _top_k(lp0, k)                     # [B, k]
            cache.take_rows(torch.arange(B, device=dev).repeat_interleave(k))

            seqs = torch.zeros((B * k, max_len), dtype=torch.long, device=dev)
            seqs[:, 0] = top_idx.reshape(-1)
            total = top_sc.reshape(-1)                           # lp(1) == 1
            ended = seqs[:, 0] == eos_id
            first = torch.arange(k, device=dev)[None, :] == 0
            base = torch.arange(B, device=dev)[:, None] * k
            pos = 1
            while pos < max_len and not bool(ended.all()):
                lp = self._step_lp(seqs[:, pos - 1:pos], enc_flat_ids, kvs,
                                   cache, pos)
                cand_lp, cand_idx = _top_k(lp, k)                # [B*k, k]

                new_len = torch.tensor(float(pos + 1), device=dev)
                norm = (total[:, None] * length_penalty(new_len - 1.0, alpha)
                        + cand_lp) / length_penalty(new_len, alpha)
                frozen = total[:, None] + torch.where(first, 0.0, -1e4)
                scores = torch.where(ended[:, None], frozen, norm)
                cand_tok = torch.where(ended[:, None], eos_id, cand_idx)

                best_sc, best = _top_k(scores.reshape(B, k * k), k)  # [B, k]
                total = best_sc.reshape(-1)
                parent = (best // k + base).reshape(-1)
                chosen = torch.gather(cand_tok.reshape(B, k * k), 1,
                                      best).reshape(-1)

                seqs = seqs.index_select(0, parent)
                seqs[:, pos] = chosen
                ended = ended.index_select(0, parent) | (chosen == eos_id)
                cache.take_rows(parent)
                pos += 1

            best_row = torch.argmax(total.reshape(B, k), dim=1)
            return seqs.reshape(B, k, max_len)[
                torch.arange(B, device=dev), best_row]


def _inverse_cdf(lp: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Row i's token: the first whose cumulative probability exceeds
    u[i] times the row's total (log-probs lp [B, V], u [B] in [0, 1))."""
    c = torch.cumsum(torch.exp(lp), dim=-1)
    ys = torch.searchsorted(c, (u * c[:, -1])[:, None], right=True)[:, 0]
    return ys.clamp_(max=lp.shape[-1] - 1)


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
                  bos_id: int, eos_id: int,
                  rng: Optional[torch.Generator] = None,
                  sample: bool = False,
                  rows: Optional[Tuple[int, int]] = None) -> List[List[int]]:
    """Greedy (or, with ``sample``, multinomial-sampling) generation for
    every row of ``batch``. Sampling draws from ``rng``, a
    ``torch.Generator`` on the model's device: the same seed reproduces the
    tokens (they are not those of ``jax.random.categorical``). ``rows``:
    (first global row, global rows) of a data-parallel slice
    (``DecoderSession.token_loop``)."""
    kvs, enc_flat_ids = session.encode(batch)
    out = session.token_loop(kvs, enc_flat_ids, bos_id, eos_id, rng, sample,
                             rows)
    return _strip_eos(out.cpu().numpy(), eos_id)


def beam_search_decode(session: DecoderSession, batch: EMDR2Batch,
                       bos_id: int, eos_id: int, beam_size: int = 5,
                       alpha: float = 0.6) -> List[List[int]]:
    """Length-normalized beam search for every row of ``batch``."""
    kvs, enc_flat_ids = session.encode(batch)
    out = session.beam_loop(kvs, enc_flat_ids, bos_id, eos_id, beam_size,
                            alpha)
    return _strip_eos(out.cpu().numpy(), eos_id)
