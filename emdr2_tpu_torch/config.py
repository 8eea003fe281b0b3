"""Configuration for the PyTorch port (mirrors ``emdr2_tpu/config.py``).

The same frozen dataclasses and field names as the JAX package, so a config
reads the same in both. Differences: ``dtype`` fields are ``torch.dtype``s,
and there is no ``mesh`` field: the port's parallelism is one process per
rank of a ``[dp, tp]`` grid (``parallel/``), laid out by ``MeshConfig``;
the tensor-parallel group reaches the modules as their ``tp`` argument. The TPU
query tiling is not ported.

Defaults reproduce the flagship NQ recipe: BERT-base retriever, T5-base
reader, top-50 retrieval, sequence lengths 512/256/64/32. The block's kind
(``TransformerConfig.block``) defaults to that recipe's Megatron block;
``t5_v11`` gives T5 v1.1's (RMSNorm, gated GELU, no biases, bucketed
relative-position bias, unscaled scores, an untied head, T5's init), which
the JAX package does not have.
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
    absolute position embeddings, GELU MLP, by default; ``block``
    switches to T5 v1.1's block (``t5_v11``)."""

    vocab_size: int = 30592          # 30522 padded to a multiple of 128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position_embeddings: int = 512
    num_tokentypes: int = 0          # BERT uses 2; T5 uses 0
    # training only (evaluation and serving run without dropout): hidden
    # dropout on the embeddings and every residual branch (counter-hash
    # masks, ops/hashing.py), attention dropout inside the flash kernels or
    # on the materialized probabilities
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layernorm_epsilon: float = 1e-5
    init_std: float = 0.02
    gelu_variant: str = "erf"        # erf | tanh
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params stay fp32
    # Per-layer activation checkpointing in training
    # (torch.utils.checkpoint): "nothing" saves no activation inside a layer
    # (the backward re-runs its forward); "dots_no_batch" saves the
    # projection and MLP products and recomputes the rest (attention).
    remat: bool = False
    remat_policy: str = "nothing"    # nothing | dots_no_batch
    # layer parameter sharing: None = no sharing; else num_layers calls over
    # this many layers, in the order of param_sharing_style
    num_unique_layers: Optional[int] = None
    param_sharing_style: str = "grouped"  # grouped | spaced
    # Encoder self-attention and the decoder's FiD cross-attention run the
    # hand-written flash kernels (ops/fid_attention.py) when set — the
    # flagship recipe's --fid-flash-attention. Off: plain materialized-score
    # attention.
    fid_flash_attention: bool = False
    flash_key_chunk: int = 512
    # the block's kind: "megatron" (LayerNorm with a bias, biased Dense, a
    # one-matrix GELU FFN, learned absolute positions, q scaled by
    # head_dim ** -0.5, the LM head tied to the word embeddings with a
    # trainable bias, N(0, init_std) with outputs init_std / sqrt(2 *
    # layers)) | "t5_v11" (HF ``T5Block`` with gated-gelu: RMSNorm, no
    # biases, gelu(x W_i0) * (x W_i1) with a dropout site before W_o, each
    # stack's bucketed relative-position table [relative_buckets, heads],
    # bidirectional in the encoder and causal in the decoder, unscaled
    # scores, an untied head with no bias, T5's fan-in scaled normals)
    block: str = "megatron"
    relative_buckets: int = 32
    relative_max_distance: int = 128

    def __post_init__(self):
        if self.block not in ("megatron", "t5_v11"):
            raise ValueError(f"block must be 'megatron' or 't5_v11', got "
                             f"{self.block!r}")

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def attention_scale(self) -> Optional[float]:
        """The scores' scale: None (head_dim ** -0.5) in the Megatron block,
        1.0 (unscaled) in T5 v1.1's."""
        return 1.0 if self.block == "t5_v11" else None


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


def t5_v11(**overrides) -> TransformerConfig:
    """T5 v1.1's block (HF ``T5Block`` with ``feed_forward_proj`` gated-gelu,
    as in ``google/t5-large-lm-adapt``): RMSNorm (eps 1e-6), bias-less
    projections, gated tanh-GELU FFN, bucketed relative-position bias (32
    buckets, max distance 128), unscaled scores, an untied bias-less LM
    head, T5's init; no absolute positions. Widths default to T5-large."""
    return dataclasses.replace(
        TransformerConfig(vocab_size=32128, hidden_size=1024, num_layers=24,
                          num_heads=16, ffn_size=2816, num_tokentypes=0,
                          layernorm_epsilon=1e-6, init_std=1.0,
                          gelu_variant="tanh", block="t5_v11"),
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
class MeshConfig:
    """The parallel layout (``parallel.mesh``): a ``[dp, tp]`` grid of
    ranks, one process and one card each (world rank ``dp_idx * tp +
    tp_idx``): ``dp`` replicas, each split over ``tp`` ranks (its heads,
    MLP width and vocabulary; ``parallel/tensor.py``); ``embed_devices``
    cards after the ``dp * tp`` trainers' that re-embed the evidence for
    them (0: each rank's embedder shares its card)."""

    dp: int = 1
    tp: int = 1
    embed_devices: int = 0


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW + global-norm clip + the AnnealingLR schedule; fp32 params,
    bf16 compute, no loss scaling."""

    lr: float = 2e-5
    min_lr: float = 0.0
    weight_decay: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    clip_grad: float = 1.0
    lr_decay_style: str = "linear"   # linear|cosine|exponential|constant
    warmup: float = 0.01             # fraction of total iters


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The train step's optimizer and the settings of the training loop
    (``training/engine.py``)."""

    optimizer: OptimizerConfig = _field(default_factory=OptimizerConfig)
    batch_size: int = 8              # global batch (questions per step)
    train_iters: Optional[int] = None
    epochs: int = 10
    seed: int = 1234
    log_interval: int = 20
    save_interval: int = 500
    eval_interval: int = 500
    exit_interval: Optional[int] = None
    index_reload_interval: int = 500  # evidence re-embed cadence (steps)
    # interval checkpoints stage device -> host and return; the disk write
    # rides a background thread (exit and final saves stay synchronous)
    async_save: bool = True


@dataclasses.dataclass(frozen=True)
class EMDR2Config:
    """Top-level joint model + training configuration."""

    retriever: RetrieverConfig = _field(default_factory=RetrieverConfig)
    reader: ReaderConfig = _field(default_factory=ReaderConfig)
    index: IndexConfig = _field(default_factory=IndexConfig)
    train: TrainConfig = _field(default_factory=TrainConfig)
    # EMDR2 objective flags
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
        train=TrainConfig(batch_size=2, epochs=1),
    )
    return cfg.replace(**overrides) if overrides else cfg


def with_transformers(cfg: EMDR2Config, towers: Optional[dict] = None,
                      reader: Optional[dict] = None) -> EMDR2Config:
    """``cfg`` with the towers' and the reader's ``TransformerConfig``
    fields replaced (``towers`` and ``reader`` map field -> value)."""
    enc = dataclasses.replace(cfg.retriever.encoder, **(towers or {}))
    t5c = dataclasses.replace(cfg.reader.transformer, **(reader or {}))
    return cfg.replace(
        retriever=dataclasses.replace(cfg.retriever, encoder=enc),
        reader=dataclasses.replace(cfg.reader, transformer=t5c))


def with_flash_attention(cfg: EMDR2Config) -> EMDR2Config:
    """``cfg`` with ``fid_flash_attention`` set in both towers and the reader
    (what the flagship recipe's --fid-flash-attention does)."""
    flash = {"fid_flash_attention": True}
    return with_transformers(cfg, flash, flash)
