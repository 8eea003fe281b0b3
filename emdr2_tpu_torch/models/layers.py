"""Transformer building blocks (port of ``emdr2_tpu/models/layers.py``).

Eval-only ``nn.Module``s (no dropout, no remat) whose attribute names are
the flax module names, so a parameter's ``state_dict`` key is its flax path
joined by dots (``convert.params_from_jax``). Layouts:

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

Attention has three paths: encoder self-attention over a key-side pad bias
(the flash kernel when ``cfg.fid_flash_attention``), incremental decoder
self-attention over a ``DecodeCache``, and decoder cross-attention over
pre-headed (k, v) [B, nh, Lk, hd] computed once per batch
(``decoding.DecoderSession.cross_kvs``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from emdr2_tpu_torch.config import TransformerConfig
from emdr2_tpu_torch.ops.fid_attention import flash_self_attention


def gelu(x: torch.Tensor, variant: str) -> torch.Tensor:
    return F.gelu(x, approximate="none" if variant == "erf" else "tanh")


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32,
                                    device=device))


class LayerNorm(nn.Module):
    """LayerNorm in fp32 regardless of compute dtype."""

    def __init__(self, hidden: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = _param(hidden, device=device)
        self.bias = _param(hidden, device=device)

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        orig = x.dtype
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.weight + self.bias).to(orig)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` in ``dtype``; kernel [in, out] (flax
    layout)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 init_std: float = 0.02, device=None):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.kernel = _param(in_features, features, device=device)
        self.bias = _param(features, device=device)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.kernel.normal_(0.0, self.init_std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)


class FusedDense(Dense):
    """``n_split`` fused projections in one matmul; kernel [D, n*H] is the
    flax [D, n, H] kernel reshaped, so the output is the flat slab
    [..., n*H] ([q | k | v] for n=3, [k | v] for n=2)."""

    def __init__(self, in_features: int, n_split: int, features: int,
                 dtype: torch.dtype, init_std: float = 0.02, device=None):
        super().__init__(in_features, n_split * features, dtype, init_std,
                         device=device)


class Embeddings(nn.Module):
    """Word + learned absolute position (+ tokentype) embeddings, summed in
    fp32 and then cast to the compute dtype; ``attend`` is the tied LM
    head."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = _param(cfg.vocab_size, cfg.hidden_size,
                                      device=device)
        self.position_embeddings = _param(cfg.max_position_embeddings,
                                          cfg.hidden_size, device=device)
        if cfg.num_tokentypes > 0:
            self.tokentype_embeddings = _param(
                cfg.num_tokentypes, cfg.hidden_size, device=device)
        else:
            self.tokentype_embeddings = None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for p in (self.word_embeddings, self.position_embeddings,
                      self.tokentype_embeddings):
                if p is not None:
                    p.normal_(0.0, self.cfg.init_std, generator=generator)

    def forward(self, ids, position_offset: int = 0, tokentype_ids=None):
        x = F.embedding(ids, self.word_embeddings)
        pos = torch.arange(position_offset, position_offset + ids.shape[-1],
                           device=ids.device)
        x = x + F.embedding(pos, self.position_embeddings)
        if self.tokentype_embeddings is not None:
            if tokentype_ids is None:
                tokentype_ids = torch.zeros_like(ids)
            x = x + F.embedding(tokentype_ids, self.tokentype_embeddings)
        return x.to(self.cfg.dtype)

    def attend(self, hidden):
        """hidden [..., H] -> fp32 logits over the tied word embeddings."""
        w = self.word_embeddings.to(hidden.dtype).float()
        return torch.matmul(hidden.float(), w.T)


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


def _attend(q, k, v, bias, dtype):
    """Materialized-score attention over heads: q [B, nh, Lq, hd], k/v
    [B, nh, Lk, hd], bias broadcastable to [B, nh, Lq, Lk] (or None) ->
    [B, nh, Lq, hd] in ``dtype``. q is scaled in ``dtype``, scores and the
    softmax are fp32, probs are cast to ``dtype`` before the P.V product."""
    hd = q.shape[-1]
    q = q * (hd ** -0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v.to(dtype))


class Attention(nn.Module):
    """Fused-QKV self-attention, or cross-attention with a query projection
    and a fused key/value projection (used once per batch by the decoder
    session to precompute the cross K/V)."""

    def __init__(self, cfg: TransformerConfig, cross_attention: bool = False,
                 device=None):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden_size, cfg.dtype
        out_std = cfg.init_std / math.sqrt(2.0 * cfg.num_layers)
        if cross_attention:
            self.query = Dense(h, h, dt, cfg.init_std, device=device)
            self.key_value = FusedDense(h, 2, h, dt, cfg.init_std,
                                        device=device)
        else:
            self.qkv = FusedDense(h, 3, h, dt, cfg.init_std, device=device)
        self.out = Dense(h, h, dt, out_std, device=device)

    def _heads(self, t):
        cfg = self.cfg
        return t.view(*t.shape[:-1], cfg.num_heads,
                      cfg.head_dim).transpose(-3, -2)

    def _merge(self, o):      # [B, nh, L, hd] -> [B, L, H]
        return o.transpose(1, 2).reshape(o.shape[0], o.shape[2],
                                         self.cfg.hidden_size)

    def encode(self, x, kv_bias):
        """Padding-masked self-attention: x [B, L, H], kv_bias [B, L]."""
        cfg = self.cfg
        qkv = self.qkv(x)                                   # [B, L, 3H]
        if cfg.fid_flash_attention:
            if x.shape[-2] > cfg.flash_key_chunk:
                raise NotImplementedError(
                    "self-attention longer than flash_key_chunk runs the "
                    "general flash kernel, which is not ported yet")
            o = flash_self_attention(qkv, kv_bias.float(), cfg.num_heads)
        else:
            q, k, v = (self._heads(t) for t in qkv.chunk(3, dim=-1))
            o = self._merge(_attend(q, k, v, kv_bias.float()[:, None, None, :],
                                    cfg.dtype))
        return self.out(o.to(cfg.dtype))

    def decode(self, x, cache: DecodeCache, layer: int):
        """Incremental self-attention of the new positions x [B, Lq, H] over
        the cached ones; writes this step's K/V at ``cache.index``."""
        cfg = self.cfg
        q, k, v = (self._heads(t) for t in self.qkv(x).chunk(3, dim=-1))
        i, n = cache.index, x.shape[-2]
        cache.keys[layer][:, :, i:i + n] = k
        cache.values[layer][:, :, i:i + n] = v
        o = _attend(q, cache.keys[layer][:, :, :i + n],
                    cache.values[layer][:, :, :i + n], None, cfg.dtype)
        return self.out(self._merge(o))

    def cross(self, x, kv, kv_bias):
        """Cross-attention of x [B, Lq, H] over pre-headed ``kv = (k, v)``
        [B, nh, Lk, hd] with key-side bias kv_bias [B, Lk]."""
        cfg = self.cfg
        q = self._heads(self.query(x))
        k, v = kv
        o = _attend(q, k, v, kv_bias.float()[:, None, None, :], cfg.dtype)
        return self.out(self._merge(o))


class MLP(nn.Module):
    """h -> ffn -> gelu -> h."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        out_std = cfg.init_std / math.sqrt(2.0 * cfg.num_layers)
        self.wi = Dense(cfg.hidden_size, cfg.ffn_size, cfg.dtype,
                        cfg.init_std, device=device)
        self.wo = Dense(cfg.ffn_size, cfg.hidden_size, cfg.dtype, out_std,
                        device=device)

    def forward(self, x):
        return self.wo(gelu(self.wi(x), self.cfg.gelu_variant))


class TransformerLayer(nn.Module):
    """Pre-LN block: self-attention [+ cross-attention] + MLP, residual
    adds."""

    def __init__(self, cfg: TransformerConfig,
                 has_cross_attention: bool = False, device=None):
        super().__init__()
        eps = cfg.layernorm_epsilon
        self.ln_self = LayerNorm(cfg.hidden_size, eps, device)
        self.self_attention = Attention(cfg, device=device)
        if has_cross_attention:
            self.ln_cross = LayerNorm(cfg.hidden_size, eps, device)
            self.cross_attention = Attention(cfg, cross_attention=True,
                                             device=device)
        self.ln_mlp = LayerNorm(cfg.hidden_size, eps, device)
        self.mlp = MLP(cfg, device)

    def encode(self, x, kv_bias):
        x = x + self.self_attention.encode(self.ln_self(x), kv_bias)
        return x + self.mlp(self.ln_mlp(x))

    def decode(self, x, cache, layer, cross_kv, cross_bias):
        x = x + self.self_attention.decode(self.ln_self(x), cache, layer)
        x = x + self.cross_attention.cross(self.ln_cross(x), cross_kv,
                                           cross_bias)
        return x + self.mlp(self.ln_mlp(x))


class TransformerStack(nn.Module):
    """A stack of layers (``layer_0`` ...) + final LayerNorm."""

    def __init__(self, cfg: TransformerConfig,
                 has_cross_attention: bool = False, device=None):
        super().__init__()
        if cfg.num_unique_layers not in (None, cfg.num_layers):
            raise NotImplementedError("layer parameter sharing is not "
                                      "ported yet")
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}",
                            TransformerLayer(cfg, has_cross_attention, device))
        self.ln_final = LayerNorm(cfg.hidden_size, cfg.layernorm_epsilon,
                                  device)

    def layer(self, i: int) -> TransformerLayer:
        return getattr(self, f"layer_{i}")

    def encode(self, x, kv_bias):
        for i in range(self.cfg.num_layers):
            x = self.layer(i).encode(x, kv_bias)
        return self.ln_final(x)

    def decode(self, x, cache: DecodeCache, cross_kvs, cross_bias):
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
