"""Transformer building blocks (port of ``emdr2_tpu/models/layers.py``).

``nn.Module``s whose attribute names are the flax module names, so a
parameter's ``state_dict`` key is its flax path joined by dots
(``convert.params_from_jax``). Layouts:

- ``Dense`` keeps the flax kernel layout [in, out] and computes ``x @ W``
  (no transpose on conversion); ``FusedDense`` stores [D, n*H] so ``x @ W``
  is the flat [q | k | v] (or [k | v]) slab.
- ``LayerNorm`` names its parameters ``weight``/``bias`` (flax ``scale``/
  ``bias``) and normalizes in fp32 whatever the compute dtype.
- Matmuls run in ``cfg.dtype``; attention scores are fp32. Where the JAX
  package asks for an fp32 product of bf16 operands
  (``preferred_element_type``), the port multiplies fp32 copies: bf16 values
  are exact in fp32 and TF32, so the result does not depend on TF32
  settings.

Attention paths: encoder self-attention over a key-side pad bias (with
``cfg.fid_flash_attention``, the K1 flash kernel up to ``flash_key_chunk``
tokens and the general K4 kernel, in key chunks, beyond); the whole-prefix
decoder (training and teacher): materialized causal self-attention and FiD
cross-attention over the encoder states (the K2 flash kernel when
``cfg.fid_flash_attention``, keys padded to a ``key_chunk`` multiple at
-1e9 bias; otherwise materialized scores under the full [B, 1, Ld, Lk]
bias); and, for generation, incremental decoder self-attention over a
``DecodeCache`` with cross-attention over pre-headed (k, v) [B, nh, Lk, hd]
computed once per batch (``decoding.DecoderSession.cross_kvs``), or over
their int8 form (k8, kscale, v8, vscale) through the K5 decode kernel. In
beam search the K/V keep one row per example: the beams of an example fold
into extra query rows.

Training: every method takes ``drop``, the ``DropoutSeeds`` of its part of
the step (``None`` when evaluating). Hidden dropout (``packed_dropout``'s
rule, through ``ops.dropout_add``: on the card one kernel that also adds
the residual) runs on the embeddings and on each residual branch, attention
dropout inside the flash kernels or on the materialized probabilities
(``dropout_add`` again); each site's seed is
``drop.site(i)`` for a fixed ``i`` (the ``_SITE_*`` indices), each layer's
stream ``drop.fold(i)`` for the i-th layer call. ``TransformerStack``
checkpoints each layer call (``torch.utils.checkpoint``, non-reentrant,
under the ``remat_policy``) when ``cfg.remat``, and shares layers under
``num_unique_layers``: the recompute gets the same seeds, so the same
masks.

The block's kind (``TransformerConfig.block``) selects T5 v1.1's block
beside the Megatron one: ``RMSNorm`` for ``LayerNorm``, bias-less
``Dense``, the gated ``MLP`` (``wi_0``, ``wi_1``, HF's names, with a
hidden-dropout site on the gated product), unscaled scores, and the
stack's bucketed relative-position table (``relative_attention_bias``
[buckets, heads], held by ``TransformerStack`` and mapped once a forward
onto the offsets' vector that every layer call takes: ``flash_self_attention``'s
``rel_bias`` in the encoder, a materialized [1, nh, L, L] bias in the
decoder's causal self-attention), and a final dropout after each stack's
last norm. T5 v1.1 runs neither under tensor parallelism nor the general
kernel K4 (it needs ``flash_key_chunk`` >= the encoder's length): both
raise, naming what is missing.

Tensor parallelism (``tp``, a ``parallel.mesh.Group`` of more than one
rank; ``parallel/tensor.py``): ``Dense`` is column-parallel (``query``,
``wi``, the fused ``qkv`` / ``key_value`` by heads) or row-parallel
(``out``, ``wo``: the partial products summed over tp in the compute
dtype, then the whole bias); ``Attention`` runs on the rank's ``nh / tp``
heads, the kernels included; ``Embeddings`` looks up the rank's
``V / tp`` rows (other ids masked, then a sum over tp) and ``attend``
gives the rank's ``V / tp`` logits. Every parameter is initialized as the
whole one would be from the same generator, then cut, so a split model
holds the parts of the unsplit one.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from emdr2_tpu_torch.config import TransformerConfig
from emdr2_tpu_torch.ops.decode_attention import decode_cross_attention_int8
from emdr2_tpu_torch.ops.fid_attention import (fid_cross_attention,
                                               fid_self_attention,
                                               flash_cross_attention,
                                               flash_self_attention,
                                               rel_bias_full)
from emdr2_tpu_torch.ops.dropout_add import dropout_add
from emdr2_tpu_torch.ops.layer_norm import layer_norm
from emdr2_tpu_torch.ops.hashing import DropoutSeeds, fold
from emdr2_tpu_torch.parallel.mesh import Group
from emdr2_tpu_torch.parallel.tensor import (COLUMN, ROW, Split, copy_to_tp,
                                             is_split, reduce_from_tp)

# dropout sites of one layer (DropoutSeeds.site)
_SITE_SELF_ATTN, _SITE_SELF_RESID = 0, 1
_SITE_CROSS_ATTN, _SITE_CROSS_RESID = 2, 3
_SITE_MLP_RESID = 4
_SITE_MLP_INNER = 5              # the gated MLP's product (T5 v1.1)
_SITE_EMBED = 0
_SITE_STACK_FINAL = 0            # after a stack's last norm (T5 v1.1)


def gelu(x: torch.Tensor, variant: str) -> torch.Tensor:
    return F.gelu(x, approximate="none" if variant == "erf" else "tanh")


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32,
                                    device=device))


class LayerNorm(nn.Module):
    """LayerNorm in fp32 regardless of compute dtype (``ops.layer_norm``:
    one hand-written kernel each way on the card, the formula on the
    CPU)."""

    def __init__(self, hidden: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(hidden, device=device)
        self.bias = _param(hidden, device=device)

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.epsilon)


class RMSNorm(nn.Module):
    """T5's norm: ``weight * x * rsqrt(mean(x^2) + eps)`` in fp32 regardless
    of compute dtype, no mean subtracted, no bias (``F.rms_norm``: one
    fused pass each way on the card where PyTorch has one, not the
    formula's seven)."""

    def __init__(self, hidden: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(hidden, device=device)

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)

    def forward(self, x):
        return F.rms_norm(x.float(), (x.shape[-1],), self.weight,
                          self.epsilon).to(x.dtype)


def make_norm(cfg: TransformerConfig, device=None) -> nn.Module:
    """The block's norm: ``LayerNorm`` (Megatron) or ``RMSNorm`` (T5
    v1.1)."""
    cls = RMSNorm if cfg.block == "t5_v11" else LayerNorm
    return cls(cfg.hidden_size, cfg.layernorm_epsilon, device)


def relative_position_bucket(offsets: torch.Tensor, bidirectional: bool,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bucket of each key-query offset ``j - i`` (HF
    ``T5Attention._relative_position_bucket``): bidirectional, half the
    buckets a side (the later keys in the upper half); causal, only
    ``j <= i`` counts. Offsets below half a side's buckets have a bucket
    each, the rest share logarithmic ones up to ``max_distance``. Computed
    in fp32 on the host, so every device and the reference agree."""
    rel = offsets.detach().to("cpu", torch.int64)
    buckets = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets += (rel > 0).to(torch.int64) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(rel.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.int64)
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


def _normal_(p: nn.Parameter, std: float, generator, split, tp) -> None:
    """``p`` <- N(0, std): drawn whole and cut when ``p`` is a tp part, so
    every rank holds its part of what one process draws."""
    with torch.no_grad():
        if split is None or not is_split(tp):
            p.normal_(0.0, std, generator=generator)
            return
        whole = torch.empty(tuple(p.shape[:split.axis])
                            + (p.shape[split.axis] * tp.world_size,)
                            + tuple(p.shape[split.axis + 1:]),
                            dtype=p.dtype, device=p.device)
        whole.normal_(0.0, std, generator=generator)
        p.copy_(split.take(whole, tp.rank, tp.world_size))


class Dense(nn.Module):
    """``y = x @ kernel + bias`` in ``dtype``; kernel [in, out] (flax
    layout); no bias with ``use_bias`` off (T5). ``split`` over ``tp``:
    ``COLUMN`` (this rank's output columns, its part of the bias; the
    input's gradient summed over tp), ``ROW`` (this rank's input rows; the
    partial products summed over tp in ``dtype``, then the whole bias), a
    fused ``Split(1, n)`` (the n blocks each cut by heads), or None
    (whole)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 init_std: float = 0.02, device=None,
                 tp: Optional[Group] = None, split: Optional[Split] = None,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.tp = tp if tp is not None else Group.local()
        self.split = split
        n = self.tp.world_size if split is not None else 1
        row = split == ROW
        self.kernel = _param(in_features // n if row else in_features,
                             features if row else features // n,
                             device=device)
        if use_bias:
            self.bias = _param(features if row else features // n,
                               device=device)
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator=None):
        _normal_(self.kernel, self.init_std, generator, self.split, self.tp)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.split == ROW:
            y = reduce_from_tp(torch.matmul(x, self.kernel.to(self.dtype)),
                               self.tp)
        else:
            if self.split is not None:
                x = copy_to_tp(x, self.tp)
            y = torch.matmul(x, self.kernel.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class FusedDense(Dense):
    """``n_split`` fused projections in one matmul; kernel [D, n*H] is the
    flax [D, n, H] kernel reshaped, so the output is the flat slab
    [..., n*H] ([q | k | v] for n=3, [k | v] for n=2). Under ``tp`` each
    block is cut by heads: the rank's slab is [..., n*H/tp], the
    [q | k | v] of its ``nh / tp`` heads. ``part_stds`` (T5's init) draws
    each block N(0, its std) instead of all N(0, ``init_std``)."""

    def __init__(self, in_features: int, n_split: int, features: int,
                 dtype: torch.dtype, init_std: float = 0.02, device=None,
                 tp: Optional[Group] = None, use_bias: bool = True,
                 part_stds: Optional[tuple] = None):
        super().__init__(in_features, n_split * features, dtype, init_std,
                         device=device, tp=tp, split=Split(1, n_split),
                         use_bias=use_bias)
        self.n_split = n_split
        self.part_stds = part_stds

    def reset_parameters(self, generator=None):
        if self.part_stds is None:
            return super().reset_parameters(generator)
        _normal_(self.kernel, 1.0, generator, self.split, self.tp)
        with torch.no_grad():
            blocks = self.kernel.view(self.kernel.shape[0], self.n_split, -1)
            for i, std in enumerate(self.part_stds):
                blocks[:, i].mul_(std)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class _Lookup(torch.autograd.Function):
    """``F.embedding`` whose weight gradient repeats bit for bit.

    PyTorch's CUDA backward of an embedding lookup sums the gradients of a
    repeated id in no fixed order when the table is small beside the
    lookups (a 2-row tokentype table under 8,192 lookups, a 512-row table
    under 16,384); PyTorch's deterministic mode gives it a fixed order.
    The backward turns that mode on for this one call (warn-only, then
    back as it was): the call runs no cuBLAS, which is what the mode would
    otherwise need ``CUBLAS_WORKSPACE_CONFIG`` for. Another thread's ops
    queued in that window may also take a deterministic route, or warn."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        enabled = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            dw = torch.ops.aten.embedding_dense_backward(
                grad.contiguous(), ids, ctx.rows, -1, False)
        finally:
            torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
        return None, dw


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, weight)`` with a repeatable weight gradient
    (``_Lookup``)."""
    return _Lookup.apply(ids, weight)


class Embeddings(nn.Module):
    """Word + learned absolute position (+ tokentype) embeddings, summed in
    fp32 and then cast to the compute dtype (no position embeddings under
    relative positions); ``attend`` is the tied LM head. Every lookup takes ``embedding``, whose gradient repeats. Under
    ``tp`` the rank holds word rows ``[t * V/tp, (t+1) * V/tp)``: ids
    outside them look up zeros and the ranks' lookups are summed (each id
    has one owner, so the sum is exact), and ``attend`` gives the rank's
    ``V / tp`` logits."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 tp: Optional[Group] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp if tp is not None else Group.local()
        self.word_embeddings = _param(cfg.vocab_size // self.tp.world_size,
                                      cfg.hidden_size, device=device)
        if cfg.block == "megatron":
            self.position_embeddings = _param(cfg.max_position_embeddings,
                                              cfg.hidden_size, device=device)
        else:
            self.register_parameter("position_embeddings", None)
        if cfg.num_tokentypes > 0:
            self.tokentype_embeddings = _param(
                cfg.num_tokentypes, cfg.hidden_size, device=device)
        else:
            self.tokentype_embeddings = None

    def reset_parameters(self, generator=None):
        _normal_(self.word_embeddings, self.cfg.init_std, generator, ROW,
                 self.tp)
        for p in (self.position_embeddings, self.tokentype_embeddings):
            if p is not None:
                _normal_(p, self.cfg.init_std, generator, None, None)

    def lookup(self, ids):
        """The word embeddings of ``ids`` (fp32), the vocab-parallel lookup
        under tp."""
        if not is_split(self.tp):
            return embedding(ids, self.word_embeddings)
        rows = self.word_embeddings.shape[0]
        start = self.tp.rank * rows
        mine = (ids >= start) & (ids < start + rows)
        x = embedding(torch.where(mine, ids - start, torch.zeros_like(ids)),
                      self.word_embeddings)
        x = torch.where(mine[..., None], x, torch.zeros((), device=x.device))
        return reduce_from_tp(x, self.tp)

    def forward(self, ids, position_offset: int = 0, tokentype_ids=None,
                drop: Optional[DropoutSeeds] = None):
        x = self.lookup(ids)
        if self.position_embeddings is not None:
            pos = torch.arange(position_offset,
                               position_offset + ids.shape[-1],
                               device=ids.device)
            x = x + embedding(pos, self.position_embeddings)
        if self.tokentype_embeddings is not None:
            if tokentype_ids is None:
                tokentype_ids = torch.zeros_like(ids)
            x = x + embedding(tokentype_ids, self.tokentype_embeddings)
        return dropout_add(x.to(self.cfg.dtype), None,
                           self.cfg.hidden_dropout, _site(drop, _SITE_EMBED),
                           _rows(drop, x))

    def attend(self, hidden, weight: Optional[torch.Tensor] = None):
        """hidden [..., H] -> fp32 logits over the tied word embeddings, or
        over ``weight`` [V, H] (an untied head; this rank's ``V / tp`` rows
        under tp)."""
        w = (self.word_embeddings if weight is None else weight)
        w = w.to(hidden.dtype).float()
        return torch.matmul(copy_to_tp(hidden, self.tp).float(), w.T)


class DecodeCache:
    """Self-attention K/V of the tokens decoded so far, per decoder layer:
    [B, nh, max_len, hd] each, filled up to ``index``. (The JAX cache has
    ``max_position_embeddings`` slots masked by the index; attending over
    the filled slots only is identical, since exp(-1e9 - m) is 0 in fp32.)"""

    def __init__(self, num_layers: int, batch: int, num_heads: int,
                 max_len: int, head_dim: int, dtype, device):
        shape = (batch, num_heads, max_len, head_dim)
        self.keys: List[torch.Tensor] = [
            torch.zeros(shape, dtype=dtype, device=device)
            for _ in range(num_layers)]
        self.values: List[torch.Tensor] = [
            torch.zeros(shape, dtype=dtype, device=device)
            for _ in range(num_layers)]
        self.index = 0

    def take_rows(self, rows: torch.Tensor) -> None:
        """Gather the cache's rows along the batch axis, in place: the beam
        fan-out (each example's row repeated) and the per-step reorder by
        parent hypothesis."""
        self.keys = [k.index_select(0, rows) for k in self.keys]
        self.values = [v.index_select(0, rows) for v in self.values]


def _site(drop: Optional[DropoutSeeds], index: int) -> Optional[int]:
    return None if drop is None else drop.site(index)


def _rows(drop: Optional[DropoutSeeds], x: torch.Tensor) -> int:
    """The hidden dropout's first global row of ``x`` on this rank."""
    return 0 if drop is None else drop.row_offset(x.shape[0])


def _attend(q, k, v, bias, dtype, rate: float = 0.0,
            seed: Optional[int] = None, shard: int = 0, tp_shard: int = 0,
            scale: Optional[float] = None):
    """Materialized-score attention over heads: q [B, nh, Lq, hd], k/v
    [B, nh, Lk, hd], bias broadcastable to [B, nh, Lq, Lk] (or None) ->
    [B, nh, Lq, hd] in ``dtype``. q is scaled in ``dtype`` (by ``scale``,
    hd^-0.5 when None; not at all at 1.0), scores and the softmax are fp32,
    probs are cast to ``dtype`` (then dropped out when a ``seed`` is given,
    at global coordinates: rows offset by data-parallel rank ``shard``,
    heads by tensor-parallel rank ``tp_shard``) before the P.V product."""
    hd = q.shape[-1]
    if scale is None:
        q = q * (hd ** -0.5)
    elif scale != 1.0:
        q = q * scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    probs = dropout_add(torch.softmax(scores, dim=-1).to(dtype), None, rate,
                        seed, shard * q.shape[0], tp_shard * q.shape[1])
    return torch.matmul(probs, v.to(dtype))


class Attention(nn.Module):
    """Fused-QKV self-attention, or cross-attention with a query projection
    and a fused key/value projection (used once per batch by the decoder
    session to precompute the cross K/V)."""

    def __init__(self, cfg: TransformerConfig, cross_attention: bool = False,
                 device=None, tp: Optional[Group] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp if tp is not None else Group.local()
        h, dt = cfg.hidden_size, cfg.dtype
        t5 = cfg.block == "t5_v11"
        bias = not t5
        if t5:
            # T5: q N(0, (d * d_kv)^-1/2), k and v N(0, d^-1/2), the output
            # N(0, (nh * d_kv)^-1/2)
            q_std = (h * cfg.head_dim) ** -0.5
            kv_std = h ** -0.5
            out_std = (cfg.num_heads * cfg.head_dim) ** -0.5
        else:
            q_std = kv_std = cfg.init_std
            out_std = cfg.init_std / math.sqrt(2.0 * cfg.num_layers)
        if cross_attention:
            self.query = Dense(h, h, dt, q_std, device=device,
                               tp=tp, split=COLUMN, use_bias=bias)
            self.key_value = FusedDense(h, 2, h, dt, kv_std, device=device,
                                        tp=tp, use_bias=bias)
        else:
            self.qkv = FusedDense(h, 3, h, dt, cfg.init_std, device=device,
                                  tp=tp, use_bias=bias,
                                  part_stds=((q_std, kv_std, kv_std) if t5
                                             else None))
        self.out = Dense(h, h, dt, out_std, device=device, tp=tp, split=ROW,
                         use_bias=bias)

    @property
    def nh(self) -> int:
        """The heads this rank runs: ``num_heads / tp``."""
        return self.cfg.num_heads // self.tp.world_size

    @property
    def width(self) -> int:
        """This rank's part of the hidden width: ``nh * head_dim``."""
        return self.nh * self.cfg.head_dim

    def _heads(self, t):
        return t.view(*t.shape[:-1], self.nh,
                      self.cfg.head_dim).transpose(-3, -2)

    def _merge(self, o):      # [B, nh, L, hd] -> [B, L, nh * hd]
        return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], self.width)

    def _dropout(self, drop, site):
        """(rate, seed, kernel seed, dp rank, tp rank) of an
        attention-dropout site: the site's seed for materialized attention
        (``_attend`` offsets the rows and heads by the ranks), the
        rank-folded one for the kernels; rate 0 off training."""
        rate = self.cfg.attention_dropout
        if drop is None or rate == 0.0:
            return 0.0, None, None, 0, 0
        return (rate, drop.site(site), drop.kernel_seed(site), drop.shard,
                drop.tp_shard)

    def encode(self, x, kv_bias, drop: Optional[DropoutSeeds] = None,
               pos_bias: Optional[torch.Tensor] = None):
        """Padding-masked self-attention: x [B, L, H], kv_bias [B, L];
        ``pos_bias`` [nh, 2L-1] fp32, the relative-position bias by offset
        (``ops.fid_attention.rel_offsets``), with the stack's scale."""
        cfg = self.cfg
        nh = self.nh
        rate, seed, kseed, shard, tshard = self._dropout(drop,
                                                         _SITE_SELF_ATTN)
        qkv = self.qkv(x)                                   # [B, L, 3H/tp]
        L = x.shape[-2]
        if pos_bias is not None and cfg.fid_flash_attention \
                and L > cfg.flash_key_chunk:
            raise ValueError(
                f"the relative-position bias runs in K1 only: the general "
                f"kernel K4 has no bias, so flash_key_chunk "
                f"({cfg.flash_key_chunk}) must be at least the encoder's "
                f"length ({L})")
        if cfg.fid_flash_attention and L <= cfg.flash_key_chunk:
            o = flash_self_attention(qkv, kv_bias.float(), nh, kseed, rate,
                                     cfg.attention_scale, pos_bias)
        elif cfg.fid_flash_attention:
            # longer than one key chunk: the general kernel, on the slab
            # itself when the chunk divides the length (one gradient slab,
            # nothing to concatenate), else on [B, L, nh, hd] views of it
            # with the keys padded to a chunk multiple
            B, L = x.shape[0], x.shape[-2]
            key_chunk = cfg.flash_key_chunk
            kvb = kv_bias.float()
            rem = L % key_chunk
            if rem:
                q, k, v = (t.view(B, L, nh, cfg.head_dim)
                           for t in qkv.chunk(3, dim=-1))
                pad = key_chunk - rem
                k = F.pad(k, (0, 0, 0, 0, 0, pad))
                v = F.pad(v, (0, 0, 0, 0, 0, pad))
                kvb = F.pad(kvb, (0, pad), value=-1e9)
                o = fid_cross_attention(q, k, v, kvb, kseed, key_chunk,
                                        rate).reshape(B, L, self.width)
            else:
                o = fid_self_attention(qkv, kvb, nh, kseed, key_chunk, rate)
        else:
            q, k, v = (self._heads(t) for t in qkv.chunk(3, dim=-1))
            bias = kv_bias.float()[:, None, None, :]
            if pos_bias is not None:
                bias = bias + rel_bias_full(pos_bias, L, L)[None]
            o = self._merge(_attend(q, k, v, bias, cfg.dtype, rate, seed,
                                    shard, tshard, cfg.attention_scale))
        return self.out(o.to(cfg.dtype))

    def decode_full(self, x, self_bias, drop: Optional[DropoutSeeds] = None):
        """Whole-prefix decoder self-attention, materialized: x [B, L, H],
        self_bias [B, 1 or nh, L, L] (causal and padding, and the
        relative-position bias when there is one)."""
        cfg = self.cfg
        rate, seed, _, shard, tshard = self._dropout(drop, _SITE_SELF_ATTN)
        q, k, v = (self._heads(t) for t in self.qkv(x).chunk(3, dim=-1))
        return self.out(self._merge(_attend(q, k, v, self_bias, cfg.dtype,
                                            rate, seed, shard, tshard,
                                            cfg.attention_scale)))

    def cross_full(self, x, enc_out, kv_bias=None, cross_bias=None,
                   drop: Optional[DropoutSeeds] = None):
        """FiD cross-attention of x [B, Ld, H] over the encoder states
        enc_out [B, Lk, H]. With ``kv_bias`` [B, Lk] (the flash path) the K2
        kernel runs on the [k | v] slab, keys padded to a ``key_chunk``
        multiple at -1e9 bias; otherwise materialized scores under
        ``cross_bias`` [B, 1, Ld, Lk]."""
        cfg = self.cfg
        rate, seed, kseed, shard, tshard = self._dropout(drop,
                                                         _SITE_CROSS_ATTN)
        q = self.query(x)                                   # [B, Ld, H/tp]
        kv = self.key_value(enc_out)                        # [B, Lk, 2H/tp]
        if kv_bias is not None and cfg.fid_flash_attention:
            Lk = kv.shape[1]
            key_chunk = min(cfg.flash_key_chunk, Lk)
            kvb = kv_bias.float()
            rem = Lk % key_chunk
            if rem:
                pad = key_chunk - rem
                kv = F.pad(kv, (0, 0, 0, pad))
                kvb = F.pad(kvb, (0, pad), value=-1e9)
            o = flash_cross_attention(q, kv.contiguous(), kvb.contiguous(),
                                      self.nh, key_chunk, kseed, rate,
                                      cfg.attention_scale)
            return self.out(o.to(cfg.dtype))
        k, v = (self._heads(t) for t in kv.chunk(2, dim=-1))
        return self.out(self._merge(_attend(self._heads(q), k, v, cross_bias,
                                            cfg.dtype, rate, seed, shard,
                                            tshard, cfg.attention_scale)))

    def decode(self, x, cache: DecodeCache, layer: int):
        """Incremental self-attention of the new positions x [B, Lq, H] over
        the cached ones; writes this step's K/V at ``cache.index``."""
        cfg = self.cfg
        q, k, v = (self._heads(t) for t in self.qkv(x).chunk(3, dim=-1))
        i, n = cache.index, x.shape[-2]
        cache.keys[layer][:, :, i:i + n] = k
        cache.values[layer][:, :, i:i + n] = v
        o = _attend(q, cache.keys[layer][:, :, :i + n],
                    cache.values[layer][:, :, :i + n], None, cfg.dtype,
                    scale=cfg.attention_scale)
        return self.out(self._merge(o))

    def cross(self, x, kv, kv_bias):
        """Cross-attention of x [Bq, Lq, H] over precomputed encoder K/V of
        kvB examples with the key-side bias kv_bias [kvB, Lk]. ``kv`` is
        (k, v), pre-headed [kvB, nh, Lk, hd] (this rank's heads), or their
        int8 form (k8,
        kscale, v8, vscale) with the key rows padded
        (``ops.decode_attention``), which runs the K5 decode kernel.

        Bq = g * kvB: the g beams of an example (consecutive rows) become
        extra query rows against that example's K/V, so the slab is read
        once per step whatever the beam width, never repeated."""
        cfg = self.cfg
        nh, hd = self.nh, cfg.head_dim
        q = self.query(x)
        Bq, Lq = q.shape[0], q.shape[1]
        kvB = kv[0].shape[0]
        if Bq % kvB or kv_bias.shape[0] != kvB:
            raise ValueError(f"{Bq} query rows and a bias of "
                             f"{kv_bias.shape[0]} rows over K/V of {kvB} "
                             f"examples")
        qh = q.view(kvB, (Bq // kvB) * Lq, nh, hd)
        kvb = kv_bias.float()
        if len(kv) == 4:
            k8, ks, v8, vs = kv
            pad = k8.shape[2] - kvb.shape[-1]
            if pad:                            # the slab was chunk-padded
                kvb = F.pad(kvb, (0, pad), value=-1e9)
            o = decode_cross_attention_int8(qh, k8, ks, v8, vs, kvb)
        else:
            k, v = kv
            o = _attend(qh.transpose(1, 2), k, v, kvb[:, None, None, :],
                        cfg.dtype, scale=cfg.attention_scale).transpose(1, 2)
        return self.out(o.reshape(Bq, Lq, self.width))


class MLP(nn.Module):
    """h -> ffn -> gelu -> h (``wi`` column-parallel, ``wo`` row-parallel
    under tp); in T5 v1.1's block h ->
    dropout(gelu(h wi_0) * (h wi_1)) -> wo, the dropout at the layer's
    ``_SITE_MLP_INNER`` (no residual: one dropout-add call without one)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 tp: Optional[Group] = None):
        super().__init__()
        self.cfg = cfg
        h, f, dt = cfg.hidden_size, cfg.ffn_size, cfg.dtype
        self.gated = cfg.block == "t5_v11"
        bias = not self.gated
        if self.gated:
            in_std, out_std = h ** -0.5, f ** -0.5
        else:
            in_std = cfg.init_std
            out_std = cfg.init_std / math.sqrt(2.0 * cfg.num_layers)
        if self.gated:
            self.wi_0 = Dense(h, f, dt, in_std, device=device, tp=tp,
                              split=COLUMN, use_bias=bias)
            self.wi_1 = Dense(h, f, dt, in_std, device=device, tp=tp,
                              split=COLUMN, use_bias=bias)
        else:
            self.wi = Dense(h, f, dt, in_std, device=device, tp=tp,
                            split=COLUMN, use_bias=bias)
        self.wo = Dense(f, h, dt, out_std, device=device, tp=tp, split=ROW,
                        use_bias=bias)

    def forward(self, x, drop: Optional[DropoutSeeds] = None):
        if not self.gated:
            return self.wo(gelu(self.wi(x), self.cfg.gelu_variant))
        y = gelu(self.wi_0(x), self.cfg.gelu_variant) * self.wi_1(x)
        return self.wo(dropout_add(y, None, self.cfg.hidden_dropout,
                                   _site(drop, _SITE_MLP_INNER),
                                   _rows(drop, y)))


class TransformerLayer(nn.Module):
    """Pre-LN block: self-attention [+ cross-attention] + MLP, residual
    adds."""

    def __init__(self, cfg: TransformerConfig,
                 has_cross_attention: bool = False, device=None,
                 tp: Optional[Group] = None):
        super().__init__()
        self.hidden_dropout = cfg.hidden_dropout
        self.ln_self = make_norm(cfg, device)
        self.self_attention = Attention(cfg, device=device, tp=tp)
        if has_cross_attention:
            self.ln_cross = make_norm(cfg, device)
            self.cross_attention = Attention(cfg, cross_attention=True,
                                             device=device, tp=tp)
        self.ln_mlp = make_norm(cfg, device)
        self.mlp = MLP(cfg, device, tp)

    def _resid(self, y, r, drop, site):
        """``r + dropout(y)``, one kernel on the card."""
        return dropout_add(y, r, self.hidden_dropout, _site(drop, site),
                           _rows(drop, y))

    def encode(self, x, kv_bias, drop: Optional[DropoutSeeds] = None,
               pos_bias: Optional[torch.Tensor] = None):
        x = self._resid(self.self_attention.encode(self.ln_self(x), kv_bias,
                                                   drop, pos_bias),
                        x, drop, _SITE_SELF_RESID)
        return self._resid(self.mlp(self.ln_mlp(x), drop), x, drop,
                           _SITE_MLP_RESID)

    def decode_full(self, x, enc_out, self_bias, kv_bias, cross_bias,
                    drop: Optional[DropoutSeeds] = None):
        """Whole-prefix decoder layer (training, teacher)."""
        x = self._resid(self.self_attention.decode_full(self.ln_self(x),
                                                        self_bias, drop),
                        x, drop, _SITE_SELF_RESID)
        x = self._resid(self.cross_attention.cross_full(
            self.ln_cross(x), enc_out, kv_bias, cross_bias, drop),
            x, drop, _SITE_CROSS_RESID)
        return self._resid(self.mlp(self.ln_mlp(x), drop), x, drop,
                           _SITE_MLP_RESID)

    def decode(self, x, cache, layer, cross_kv, cross_bias):
        x = x + self.self_attention.decode(self.ln_self(x), cache, layer)
        x = x + self.cross_attention.cross(self.ln_cross(x), cross_kv,
                                           cross_bias)
        return x + self.mlp(self.ln_mlp(x))


_MM_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_no_batch(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_policy="dots_no_batch"``
    (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``): save the
    products with no batch dimension (``aten.mm`` / ``aten.addmm``: the
    projections and the MLP, which ``matmul`` folds to 2-D), recompute the
    rest. Attention products have batch dimensions and the flash kernels
    run inside autograd Functions, so attention is recomputed, and every
    ``torch.empty`` a kernel fills is made anew by the recompute. Under tp
    the row-parallel layers' all-reduce (``c10d`` ops) is recomputed like
    the rest, on every rank alike: the recompute issues the forward's
    collectives again, in the same order on every tp rank, as a layer
    checkpointed under ``"nothing"`` does. (Saving it is not an option:
    the collective works in place, and a cached result would leave the
    recomputed tensor unsummed.)"""
    return (CheckpointPolicy.MUST_SAVE if op in _MM_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_no_batch_context():
    return create_selective_checkpoint_contexts(_dots_no_batch)


class TransformerStack(nn.Module):
    """A stack of ``cfg.num_layers`` layer calls + final LayerNorm.

    Layer parameter sharing: with ``cfg.num_unique_layers`` = u < L only u
    layers are built (``layer_0`` ... ``layer_{u-1}``, the flax names); call
    i runs layer ``i % u`` (``param_sharing_style="grouped"``) or
    ``i // (L / u)`` ("spaced"), with the dropout seeds of call i, so every
    call draws its own masks. KV-cached decoding refuses a shared stack, as
    the JAX package does.

    With ``cfg.remat`` each call is checkpointed while gradients are on
    (``torch.utils.checkpoint``, non-reentrant): ``remat_policy="nothing"``
    saves no activation inside it (the backward re-runs its forward),
    ``"dots_no_batch"`` saves the 2-D products (:func:`_dots_no_batch`).

    T5 v1.1's block (``cfg.block == "t5_v11"``): the stack holds
    the bucket table ``relative_attention_bias`` [buckets, heads] (HF keeps
    it in layer 0 and shares it), maps it once a forward onto the offsets'
    vector [nh, 2L-1] (bidirectional buckets in the encoder, causal in the
    decoder) and hands that to every layer call. A T5 stack also drops out
    its output after the final norm (``_SITE_STACK_FINAL`` of its seeds)."""

    def __init__(self, cfg: TransformerConfig,
                 has_cross_attention: bool = False, device=None,
                 tp: Optional[Group] = None):
        super().__init__()
        n_unique = cfg.num_unique_layers or cfg.num_layers
        if cfg.num_layers % n_unique:
            raise ValueError(f"{cfg.num_layers} layers cannot share "
                             f"{n_unique} unique layers")
        if cfg.param_sharing_style not in ("grouped", "spaced"):
            raise ValueError(f"param_sharing_style must be 'grouped' or "
                             f"'spaced', got {cfg.param_sharing_style!r}")
        if cfg.remat_policy not in ("nothing", "dots_no_batch"):
            raise ValueError(f"remat_policy must be 'nothing' or "
                             f"'dots_no_batch', got {cfg.remat_policy!r}")
        self.cfg = cfg
        self.num_unique = n_unique
        for u in range(n_unique):
            self.add_module(f"layer_{u}",
                            TransformerLayer(cfg, has_cross_attention, device,
                                             tp))
        self.ln_final = make_norm(cfg, device)
        self.has_cross_attention = has_cross_attention
        if cfg.block == "t5_v11":
            self.relative_attention_bias = _param(
                cfg.relative_buckets, cfg.num_heads, device=device)
        else:
            self.relative_attention_bias = None

    def reset_parameters(self, generator=None):
        if self.relative_attention_bias is not None:
            # T5: N(0, d^-1/2)
            _normal_(self.relative_attention_bias,
                     self.cfg.hidden_size ** -0.5, generator, None, None)

    def position_bias(self, Lq: int, Lk: int) -> Optional[torch.Tensor]:
        """[nh, Lq + Lk - 1] fp32: the bucket table's entry of each offset
        ``j - i`` from ``-(Lq - 1)`` to ``Lk - 1`` (a gather whose gradient
        repeats), or None in the Megatron block."""
        table = self.relative_attention_bias
        if table is None:
            return None
        offsets = torch.arange(-(Lq - 1), Lk)
        buckets = relative_position_bucket(
            offsets, not self.has_cross_attention, self.cfg.relative_buckets,
            self.cfg.relative_max_distance).to(table.device)
        return embedding(buckets, table).t().contiguous()

    def _finish(self, x, drop: Optional[DropoutSeeds]):
        x = self.ln_final(x)
        if self.cfg.block == "megatron":
            return x
        return dropout_add(x, None, self.cfg.hidden_dropout,
                           _site(drop, _SITE_STACK_FINAL), _rows(drop, x))

    def layer(self, u: int) -> TransformerLayer:
        """The unique layer ``u`` (``layer_{u}``)."""
        return getattr(self, f"layer_{u}")

    def unique_index(self, i: int) -> int:
        """The unique layer that call ``i`` runs."""
        u, L = self.num_unique, self.cfg.num_layers
        if self.cfg.param_sharing_style == "grouped":
            return i % u
        return i // (L // u)

    def check_decode(self) -> None:
        """Refuse KV-cached decoding over shared layers (their caches would
        collide)."""
        if self.num_unique != self.cfg.num_layers:
            raise ValueError("KV-cached decoding is incompatible with layer "
                             "parameter sharing")

    def _run(self, fn, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            # the masks come from the seeds in ``args``, not from torch's
            # generators: the recompute needs no RNG state restored
            kw = {}
            if self.cfg.remat_policy == "dots_no_batch":
                kw["context_fn"] = _dots_no_batch_context
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False, **kw)
        return fn(*args)

    def encode(self, x, kv_bias, drop: Optional[DropoutSeeds] = None):
        L = x.shape[-2]
        pos = self.position_bias(L, L)
        for i in range(self.cfg.num_layers):
            layer = self.layer(self.unique_index(i))
            if pos is None:
                x = self._run(layer.encode, x, kv_bias, fold(drop, i))
            else:
                x = self._run(layer.encode, x, kv_bias, fold(drop, i), pos)
        return self._finish(x, drop)

    def decode_full(self, x, enc_out, self_bias, kv_bias, cross_bias,
                    drop: Optional[DropoutSeeds] = None):
        L = x.shape[-2]
        pos = self.position_bias(L, L)
        if pos is not None:
            self_bias = self_bias + rel_bias_full(pos, L, L)[None]
        for i in range(self.cfg.num_layers):
            x = self._run(self.layer(self.unique_index(i)).decode_full, x,
                          enc_out, self_bias, kv_bias, cross_bias,
                          fold(drop, i))
        return self._finish(x, drop)

    def decode(self, x, cache: DecodeCache, cross_kvs, cross_bias):
        self.check_decode()
        for i in range(self.cfg.num_layers):
            x = self.layer(i).decode(x, cache, i, cross_kvs[i], cross_bias)
        cache.index += x.shape[-2]
        return self.ln_final(x)


def init_weights(module: nn.Module, generator: Optional[torch.Generator]
                 = None) -> None:
    """Initialize every parameter like the JAX package: kernels and
    embeddings N(0, init_std), output projections N(0, init_std /
    sqrt(2 * num_layers)), biases 0, LayerNorm 1/0."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
