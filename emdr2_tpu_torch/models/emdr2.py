"""EMDR2 joint retriever + reader (port of ``emdr2_tpu/models/emdr2.py``).

``forward`` (the JAX ``__call__``) is the differentiable core of a train
step: fresh query and context embeddings with gradient -> ``topk_log_probs``
over the retrieved K; the FiD reader (T5 encoder over B*K rows, decoder over
the K*Lr encoder states) -> ``lm_logits``; and the stop-gradient teacher
(T5 over the query plus one context per document) -> per-document gold
log-probs. Gradient reaches the dual encoder only through
``topk_log_probs``. ``drop`` (the step's ``DropoutSeeds``) turns dropout on,
in the teacher too, as in the JAX forward. Generation uses ``fid_encode``
and ``decode_step``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from emdr2_tpu_torch.config import EMDR2Config
from emdr2_tpu_torch.data import masks
from emdr2_tpu_torch.models.bert import DualEncoder
from emdr2_tpu_torch.models.layers import DecodeCache, init_weights
from emdr2_tpu_torch.models.t5 import T5Model
from emdr2_tpu_torch.ops.fid_attention import check_kernel_limits
from emdr2_tpu_torch.ops.hashing import DropoutSeeds, fold
from emdr2_tpu_torch.parallel.mesh import Group, check_tp_divides
from emdr2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from emdr2_tpu_torch.utils.timing import StageTimer, stage


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


class EMDR2Output(NamedTuple):
    lm_logits: torch.Tensor             # [B, Ld, V] fp32 ([.., V/tp] under tp)
    topk_log_probs: torch.Tensor        # [B, K] fp32 (grad -> dual encoder)
    gold_log_probs: torch.Tensor        # [B, K, Ld] fp32, no gradient


class EMDR2Model(nn.Module):

    def __init__(self, config: EMDR2Config, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 tp: Optional[Group] = None):
        """Parameters are made on ``device`` (the card unless the caller
        names another; no card there raises) and initialized from
        ``generator`` like the JAX package's init (load converted weights
        with ``load_state_dict`` to replace them). On a card a configuration
        that the attention kernels do not take
        (``ops.fid_attention.kernel_limits``) raises here, before any work:
        nothing is routed to a plain version. ``tp``: the tensor-parallel
        group the model splits over (its heads, MLP widths and vocabulary
        must divide by its size); each rank holds the parts of what one
        process initializes from the same generator. Each block is
        initialized by its kind (``TransformerConfig.block``):
        Megatron's N(0, init_std) for the BERT towers and the default
        reader, T5's fan-in scaled normals for a T5 v1.1 reader."""
        super().__init__()
        device = resolve_device(device)
        if tp is not None:
            check_tp_divides(tp.world_size, config)
        if device.type == "cuda":
            for name, cfg, decoder_len in (
                    ("retriever.encoder", config.retriever.encoder, None),
                    ("reader.transformer", config.reader.transformer,
                     config.reader.decoder_seq_len)):
                check_kernel_limits(f"EMDR2Model on {device}, {name}",
                                    cfg.dtype, cfg.head_dim, decoder_len,
                                    cfg.fid_flash_attention)
        t5c = config.reader.transformer
        if t5c.block == "t5_v11" and t5c.fid_flash_attention \
                and t5c.flash_key_chunk < config.reader.seq_len:
            raise ValueError(
                f"the relative-position bias runs in K1 only (the general "
                f"kernel K4 has none): flash_key_chunk "
                f"({t5c.flash_key_chunk}) must be at least the reader's "
                f"seq_len ({config.reader.seq_len})")
        self.config = config
        self.tp = tp if tp is not None else Group.local()
        self.retriever = DualEncoder(config.retriever, device, tp)
        self.reader = T5Model(config.reader.transformer, device, tp)
        init_weights(self, generator)

    def embed_query(self, query_bert_ids):
        """[B, Lq] -> [B, d] fp32 query embeddings for the MIPS search."""
        return self.retriever.embed_query(query_bert_ids)

    # ---- retriever scores ---------------------------------------------------

    def _topk_log_probs(self, batch: EMDR2Batch,
                        drop: Optional[DropoutSeeds] = None):
        """[B, K] log-softmax over the fp32 query . context scores (divided
        by sqrt(hidden) with ``retriever_score_scaling``)."""
        cfg = self.config
        B, K, Lc = batch.context_bert_ids.shape
        q = self.retriever.embed_query(batch.query_bert_ids,
                                       drop=fold(drop, 0))
        c = self.retriever.context_model.embed(
            batch.context_bert_ids.reshape(B * K, Lc),
            tokentype_ids=batch.context_bert_types.reshape(B * K, Lc),
            drop=fold(drop, 1)).float().reshape(B, K, -1)
        scores = torch.einsum("bd,bkd->bk", q, c)
        if cfg.retriever_score_scaling:
            scores = scores / math.sqrt(cfg.retriever.encoder.hidden_size)
        return torch.log_softmax(scores, dim=-1)

    # ---- FiD reader ----------------------------------------------------------

    def fid_encode(self, reader_ids, drop: Optional[DropoutSeeds] = None):
        """[B, Kc, Lr] -> (hidden [B, Kc*Lr, H], flat ids [B, Kc*Lr]); each
        context row encodes independently, so K-blocks may be encoded
        separately and concatenated."""
        B, K, Lr = reader_ids.shape
        hidden = self.reader.encode(reader_ids.reshape(B * K, Lr), drop)
        return (hidden.reshape(B, K * Lr, hidden.shape[-1]),
                reader_ids.reshape(B, K * Lr))

    def forward(self, batch: EMDR2Batch, drop: Optional[DropoutSeeds] = None,
                update_retriever: Optional[bool] = None,
                timer: Optional[StageTimer] = None) -> EMDR2Output:
        """``timer`` records the ``retriever_forward``, ``reader_forward``
        and ``teacher_forward`` stages (outside every rematerialised call,
        so the backward's recompute opens none)."""
        cfg = self.config
        update_retriever = (cfg.update_retriever if update_retriever is None
                            else update_retriever)
        with stage(timer, "retriever_forward"):
            topk_log_probs = self._topk_log_probs(batch, fold(drop, 0))
        with stage(timer, "reader_forward"):
            enc_hidden, enc_flat_ids = self.fid_encode(batch.reader_ids,
                                                       fold(drop, 1))
            enc_dec_mask = masks.attention_mask(batch.dec_ids, enc_flat_ids)
            lm_logits = self.reader.decode(batch.dec_ids, enc_hidden,
                                           enc_dec_mask, fold(drop, 2)).float()
        with stage(timer, "teacher_forward"):
            if update_retriever:
                with torch.no_grad():
                    gold_log_probs = self._teacher_gold_log_probs(
                        batch, fold(drop, 3))
            else:
                B, K = topk_log_probs.shape
                gold_log_probs = torch.zeros((B, K, batch.labels.shape[-1]),
                                             device=lm_logits.device)
        return EMDR2Output(lm_logits, topk_log_probs, gold_log_probs)

    def _teacher_gold_log_probs(self, batch: EMDR2Batch,
                                drop: Optional[DropoutSeeds] = None):
        """Per-document teacher: T5 over query + one context, gold-token
        log-probs [B, K, Ld] through the chunked head."""
        B, K, Lr = batch.reader_one_ctx_ids.shape
        Ld = batch.dec_ids.shape[-1]
        flat_ids = batch.reader_one_ctx_ids.reshape(B * K, Lr)
        dec_rep = batch.dec_ids.repeat_interleave(K, dim=0)   # [B*K, Ld]
        labels_rep = batch.labels.repeat_interleave(K, dim=0)
        enc_hidden = self.reader.encode(flat_ids, fold(drop, 0))
        enc_dec_mask = masks.attention_mask(dec_rep, flat_ids)
        gold = self.reader.decode_gold_log_probs(
            dec_rep, enc_hidden, enc_dec_mask, labels_rep, fold(drop, 1))
        return gold.reshape(B, K, Ld)

    # ---- generation-time entry points ---------------------------------------

    def encode_for_generation(self, batch: EMDR2Batch):
        """-> (None, enc_hidden, enc_flat_ids): generation needs only the FiD
        encoder states (the JAX ``with_scores=False`` path)."""
        enc_hidden, enc_flat_ids = self.fid_encode(batch.reader_ids)
        return None, enc_hidden, enc_flat_ids

    def decode_step(self, dec_ids, enc_flat_ids, cross_kvs,
                    cache: DecodeCache, position_offset: int = 0):
        """Incremental decode of dec_ids [rows, Lq] over precomputed
        per-layer cross K/V and the self-attention cache -> [rows, Lq, V]
        fp32 logits. ``enc_flat_ids`` and the K/V hold one row per example;
        in beam search ``rows`` is a multiple of that (the beams of an
        example are consecutive rows)."""
        cross_bias = masks.padding_bias(enc_flat_ids)
        return self.reader.decode_step(dec_ids, cross_kvs, cross_bias, cache,
                                       position_offset)
