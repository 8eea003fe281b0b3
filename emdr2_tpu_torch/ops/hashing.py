"""Counter-hash dropout masks (port of ``emdr2_tpu/ops/hashing.py``).

Both dropout forms of the JAX package draw their keep bits from the same
murmur3-style construction: mix per-axis element coordinates with odd
32-bit primes, then avalanche with :func:`murmur_fin`.

- ``keep_mask`` is the attention-dropout mask of the flash kernels
  (``emdr2_tpu/ops/fid_attention.py:_keep_mask``); the CUDA kernels compute
  the same bits in ``csrc/hashing.cuh``, and the plain versions use this.
- ``packed_dropout`` is the hidden-dropout module
  (``emdr2_tpu/models/layers.py:PackedDropout``), elementwise over a tensor:
  the plain path of ``ops.dropout_add``, whose kernel computes the same
  bits on the card (``csrc/dropout_add.cu``).

The arithmetic is uint32 with wrap-around. PyTorch has no ``>>`` or
unsigned compare on uint32 tensors on every device, so the tensors hold the
bits in int32 (multiplication wraps the same), shifts are arithmetic shifts
masked to logical ones, and unsigned comparisons flip the sign bit first.
int32 keeps the hidden-dropout mask at 4 bytes per element: on the CPU
route a [400, 512, 768] activation would take one 0.63 GB hash tensor and
one temporary of that size while its mask is made. The model's sites on
the card take the kernel, which makes no hash tensor and saves no mask.

A ``[dp, tp]`` grid of ranks (one process a rank) keeps the JAX package's
three rules on its mesh. The attention kernels hash *local* (batch * head)
indices, so the rank at (dp index d, tp index t) adds d * 0x9E3779B1 +
t * 0x85EBCA77 (uint32 wrap) to their seed (``shard_seed``, the JAX
``_shard_seed`` over ``(dp, tp)``). ``PackedDropout`` hashes *global*
element coordinates (its iota is global under GSPMD): on the replicated
[B, L, D] activations rank d's rows are offset by d * (its rows), the same
mask on every tp rank (``packed_dropout(..., row_offset=)``); on the
materialized attention probabilities [B, nh/tp, Lq, Lk] the heads are
offset by t * nh/tp as well (``head_offset=``). ``DropoutSeeds.shard`` and
``DropoutSeeds.tp_shard`` carry the two indices.

Seeds: the JAX package draws one seed per site from flax rngs, which the
port cannot reproduce. Here a site's seed is a pure function of the step's
seed and fixed site indices (:class:`DropoutSeeds`), never a draw from a
generator, so an activation-checkpoint recompute regenerates the forward's
masks exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

# odd 32-bit mixing primes (golden-ratio + murmur/xxhash constants)
MIX_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
              0x165667B1, 0xFF51AFD7, 0xC4CEB9FF, 0x2545F491)

_M32 = 0xFFFFFFFF
_SIGN = -2 ** 31


def _i32(c: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    c &= _M32
    return c - 2 ** 32 if c >= 2 ** 31 else c


def murmur_fin_int(h: int) -> int:
    """murmur3 finalizer on a Python int holding a uint32."""
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def murmur_fin_(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer, in place, on an int32 tensor holding uint32 bits;
    returns ``h``."""
    for shift, mult in ((16, 0x85EBCA6B), (13, 0xC2B2AE35), (16, None)):
        t = h >> shift                      # arithmetic: mask to logical
        t &= (1 << (32 - shift)) - 1
        h ^= t
        del t
        if mult is not None:
            h.mul_(_i32(mult))
    return h


def murmur_fin(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer of int32-held uint32 bits (out of place)."""
    return murmur_fin_(h.to(torch.int32, copy=True))


def _uint_ge_(h: torch.Tensor, threshold: int) -> torch.Tensor:
    """``h >= threshold`` as uint32, consuming ``h``."""
    h ^= _SIGN
    return h >= _i32(threshold ^ 0x80000000)


def attention_threshold(rate: float) -> int:
    """The keep threshold of the attention mask: ``int`` truncates, as
    ``_keep_mask`` does."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def keep_mask(seed: int, bh: torch.Tensor, rate: float, rows: int,
              cols: int, j: int = 0, device=None) -> torch.Tensor:
    """Attention-dropout keep mask [*bh.shape, rows, cols] (bool) of
    ``_keep_mask``: element (r, col) of (batch*head ``bh``, key chunk ``j``)
    is kept iff murmur_fin((r*P0) ^ (col*P1) ^ (seed + bh*P3 + j*P4)) >=
    threshold. ``bh`` is an integer tensor of batch*head indices."""
    dev = bh.device if device is None else device
    r = torch.arange(rows, device=dev, dtype=torch.int32) * _i32(MIX_PRIMES[0])
    c = torch.arange(cols, device=dev, dtype=torch.int32) * _i32(MIX_PRIMES[1])
    base = (bh.to(device=dev, dtype=torch.int32) * _i32(0x27D4EB2F)
            + _i32((seed + j * 0x165667B1) & _M32))
    x = (r[:, None] ^ c[None, :]) ^ base[..., None, None]
    return _uint_ge_(murmur_fin_(x), attention_threshold(rate))


def shard_seed(seed: int, rank: int, tp_rank: int = 0) -> int:
    """The attention kernels' seed on data-parallel rank ``rank`` and
    tensor-parallel rank ``tp_rank``: ``seed + rank * 0x9E3779B1 + tp_rank
    * 0x85EBCA77`` (uint32), the JAX ``_shard_seed`` over ``(dp, tp)``."""
    return (seed + rank * MIX_PRIMES[0] + tp_rank * MIX_PRIMES[1]) & _M32


def packed_dropout(x: torch.Tensor, rate: float, seed: Optional[int],
                   row_offset: int = 0, head_offset: int = 0) -> torch.Tensor:
    """Inverted dropout of ``PackedDropout``: the keep bit of element
    (i0, i1, ...) is murmur_fin(seed ^ i0*P0 ^ i1*P1 ^ ...) >= t with
    t = round(rate * 2^32) (rounded, unlike the attention mask's
    truncation), and kept elements are scaled by 2^32 / (2^32 - t) rounded
    to ``x.dtype``. ``row_offset`` is added to i0 (a data-parallel rank's
    first global row), ``head_offset`` to i1 (a tensor-parallel rank's
    first global head). ``seed=None`` (evaluation) or rate 0 returns
    ``x``."""
    if seed is None or rate == 0.0:
        return x
    t = round(rate * 4294967296.0)
    if t <= 0 or t >= 2 ** 32 or x.dim() == 0:
        raise ValueError(f"dropout rate {rate} is outside (0, 1), or x is "
                         f"a scalar")
    h = None
    for axis, n in enumerate(x.shape):
        shape = [1] * x.dim()
        shape[axis] = n
        idx = torch.arange(n, device=x.device, dtype=torch.int32)
        offset = (row_offset if axis == 0
                  else head_offset if axis == 1 else 0)
        if offset:
            idx += _i32(offset)
        idx = (idx * _i32(MIX_PRIMES[axis % len(MIX_PRIMES)])).view(shape)
        if h is None:
            idx ^= _i32(seed)
            h = idx
        else:
            h = h ^ idx
    keep = _uint_ge_(murmur_fin_(h), t)
    scale = torch.tensor(4294967296.0 / (4294967296 - t), dtype=x.dtype,
                         device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def fold_seed(seed: int, index: int) -> int:
    """A child uint32 seed: a pure function of ``seed`` and ``index``."""
    return murmur_fin_int(seed * MIX_PRIMES[0]
                          + (index + 1) * MIX_PRIMES[1])


class DropoutSeeds:
    """The dropout seeds of one training step. ``fold(i)`` names a
    sub-stream (a model part, a layer), ``site(i)`` the uint32 seed of one
    dropout site inside it; both are pure functions of the step seed and
    the indices, so a recompute under activation checkpointing sees the
    same seeds as the forward. ``shard`` is the data-parallel rank and
    ``tp_shard`` the tensor-parallel one (0 in one process): the same site
    seeds on every rank, folded by both for the attention kernels
    (``kernel_seed``), offset by the rank's rows for the hidden dropout
    (``row_offset``), and by its rows and heads for the materialized
    attention dropout (``layers._attend``)."""

    __slots__ = ("seed", "shard", "tp_shard")

    def __init__(self, seed: int, shard: int = 0, tp_shard: int = 0):
        self.seed = seed & _M32
        self.shard = shard
        self.tp_shard = tp_shard

    def fold(self, index: int) -> "DropoutSeeds":
        return DropoutSeeds(fold_seed(self.seed, index), self.shard,
                            self.tp_shard)

    def site(self, index: int) -> int:
        return fold_seed(self.seed, 1_000_003 + index)

    def kernel_seed(self, index: int) -> int:
        """Site ``index``'s seed for an attention kernel on this rank."""
        return shard_seed(self.site(index), self.shard, self.tp_shard)

    def row_offset(self, rows: int) -> int:
        """The first global row of this rank's ``rows`` rows."""
        return self.shard * rows

    def __repr__(self) -> str:
        return (f"DropoutSeeds({self.seed:#010x}, shard={self.shard}, "
                f"tp_shard={self.tp_shard})")


def fold(drop: Optional[DropoutSeeds], index: int) -> Optional[DropoutSeeds]:
    """``drop.fold(index)``, or ``None`` when evaluating."""
    return None if drop is None else drop.fold(index)
