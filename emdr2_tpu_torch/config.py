"""Configuration for the PyTorch port (mirrors ``emdr2_tpu/config.py``).

The same frozen dataclasses and field names as the JAX package, so a config
reads the same in both. Differences: ``dtype`` fields are ``torch.dtype``s,
and there is no ``mesh`` field (the port runs on one device). The training
sections (``MeshConfig``, ``TrainConfig``, ``OptimizerConfig``, remat) and
the TPU query tiling come with the slices that need them.

Defaults reproduce the flagship NQ recipe: BERT-base retriever, T5-base
reader, top-50 retrieval, sequence lengths 512/256/64/32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _field(**kw):
    return dataclasses.field(**kw)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Shared transformer trunk hyperparameters: pre-LN blocks, learned
    absolute position embeddings, GELU MLP."""

    vocab_size: int = 30592          # 30522 padded to a multiple of 128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position_embeddings: int = 512
    num_tokentypes: int = 0          # BERT uses 2; T5 uses 0
    hidden_dropout: float = 0.1      # unused: the port is eval-only so far
    attention_dropout: float = 0.1   # unused: the port is eval-only so far
    layernorm_epsilon: float = 1e-5
    init_std: float = 0.02
    gelu_variant: str = "erf"        # erf | tanh
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    # layer parameter sharing: not ported yet (TransformerStack refuses it)
    num_unique_layers: Optional[int] = None
    param_sharing_style: str = "grouped"  # grouped | spaced
    # Padding-masked encoder self-attention runs the hand-written flash
    # kernel (ops/fid_attention.py) when set — the flagship recipe's
    # --fid-flash-attention. Off: plain materialized-score attention.
    fid_flash_attention: bool = False
    flash_key_chunk: int = 512

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads


def bert_base(**overrides) -> TransformerConfig:
    return dataclasses.replace(
        TransformerConfig(num_tokentypes=2, max_position_embeddings=512),
        **overrides)


def t5_base(**overrides) -> TransformerConfig:
    # BERT wordpiece + [BOS]/[EOS] + 100 sentinels, padded to 128 -> 30720
    return dataclasses.replace(
        TransformerConfig(vocab_size=30720, num_tokentypes=0,
                          max_position_embeddings=512),
        **overrides)


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    """Dual-encoder retriever."""

    encoder: TransformerConfig = _field(default_factory=bert_base)
    embed_dim: int = 768
    seq_len: int = 256
    query_seq_len: int = 64


@dataclasses.dataclass(frozen=True)
class ReaderConfig:
    """T5 Fusion-in-Decoder reader."""

    transformer: TransformerConfig = _field(default_factory=t5_base)
    seq_len: int = 512
    decoder_seq_len: int = 32


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Flat MIPS index over evidence embeddings, resident on the device."""

    embed_dim: int = 768
    dtype: torch.dtype = torch.bfloat16
    topk: int = 50
    allow_trivial_doc: bool = True   # else fetch K+1 and drop the source doc
    # shards of at most chunk_rows rows are searched exactly (no kernel) —
    # the JAX package's small-shard rule, kept so both pick the same path
    chunk_rows: int = 8192
    group_size: int = 128            # candidate group-max reduction factor
    cands_per_group: int = 2
    exact: bool = False              # exact top-k instead of the scan
    quantize: str = "none"           # "none" | "int8"


@dataclasses.dataclass(frozen=True)
class EMDR2Config:
    """Top-level joint model configuration."""

    retriever: RetrieverConfig = _field(default_factory=RetrieverConfig)
    reader: ReaderConfig = _field(default_factory=ReaderConfig)
    index: IndexConfig = _field(default_factory=IndexConfig)
    # training objective flags: unused until the training slice
    update_retriever: bool = True
    retriever_score_scaling: bool = True
    use_kl_div_loss: bool = False

    def replace(self, **kw) -> "EMDR2Config":
        return dataclasses.replace(self, **kw)


def tiny_config(**overrides) -> EMDR2Config:
    """A tiny configuration for unit tests (same shapes as the JAX one)."""
    enc = TransformerConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        ffn_size=128, max_position_embeddings=128, num_tokentypes=2,
        hidden_dropout=0.0, attention_dropout=0.0, dtype=torch.float32,
    )
    t5c = dataclasses.replace(enc, vocab_size=640, num_tokentypes=0)
    cfg = EMDR2Config(
        retriever=RetrieverConfig(encoder=enc, embed_dim=64, seq_len=32,
                                  query_seq_len=16),
        reader=ReaderConfig(transformer=t5c, seq_len=48, decoder_seq_len=8),
        index=IndexConfig(embed_dim=64, topk=4, chunk_rows=256, group_size=8,
                          dtype=torch.float32),
    )
    return cfg.replace(**overrides) if overrides else cfg


def with_flash_attention(cfg: EMDR2Config) -> EMDR2Config:
    """``cfg`` with ``fid_flash_attention`` set in both towers and the reader
    (what the flagship recipe's --fid-flash-attention does)."""
    enc = dataclasses.replace(cfg.retriever.encoder, fid_flash_attention=True)
    t5c = dataclasses.replace(cfg.reader.transformer,
                              fid_flash_attention=True)
    return cfg.replace(
        retriever=dataclasses.replace(cfg.retriever, encoder=enc),
        reader=dataclasses.replace(cfg.reader, transformer=t5c))
