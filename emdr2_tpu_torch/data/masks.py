"""Attention mask utilities (port of ``emdr2_tpu/data/masks.py``).

A token id is "real" iff ``id >= 1`` (id 0 = pad), and masks mark *allowed*
attention with True. Biases are additive: 0 where allowed, -1e9 (finite, not
-inf) where masked, so fully-masked rows stay NaN-free.
"""

from __future__ import annotations

import torch


def padding_mask(ids: torch.Tensor) -> torch.Tensor:
    """[..., L] token ids -> [..., L] bool, True where the token is real."""
    return ids >= 1


def attention_mask(source_ids: torch.Tensor,
                   target_ids: torch.Tensor) -> torch.Tensor:
    """[B, S], [B, T] -> [B, S, T] bool; True = position may attend."""
    return (padding_mask(source_ids)[..., :, None]
            & padding_mask(target_ids)[..., None, :])


def causal_mask(length: int, device=None) -> torch.Tensor:
    """[L, L] lower-triangular bool mask."""
    idx = torch.arange(length, device=device)
    return idx[None, :] <= idx[:, None]


def self_attention_mask(ids: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """[B, L] ids -> [B, L, L] allowed-attention mask, optionally causal."""
    mask = attention_mask(ids, ids)
    if causal:
        mask = mask & causal_mask(ids.shape[-1], ids.device)[None, :, :]
    return mask


def padding_bias(ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] token ids -> [B, L] additive bias masking pad *keys* — the
    key-side-only bias the flash self-attention kernel consumes."""
    return mask_to_bias(padding_mask(ids), dtype)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Bool allowed-mask -> additive attention bias (0 or -1e9)."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    neg = torch.full((), -1e9, dtype=dtype, device=mask.device)
    return torch.where(mask, zero, neg)
