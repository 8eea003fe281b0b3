"""Plain PyTorch reference of the EMDR2 model, in float32.

What it computes is the published architecture the benchmark's
configurations state (EMDR2, arXiv:2106.05346; DPR, arXiv:2004.04906):

- a BERT tower: word + learned position + token-type embeddings, pre-LN
  blocks (self-attention over non-pad keys, GELU MLP), a final LayerNorm;
  the retrieval embedding is the [CLS] state;
- a T5 Fusion-in-Decoder reader in the same pre-LN form with learned
  absolute positions: the encoder reads each (question, passage) row alone,
  the decoder attends causally to itself and to the encoder states of all
  K passages of its question, and the LM head is tied to the word
  embeddings with a trainable bias.

Dropout draws its keep bits from a counter hash (murmur3's finalizer over
mixed element coordinates), so the reference can make the same masks as
the program from the step's seed: ``hidden_dropout`` on embeddings,
residual branches and the decoder's materialized self-attention
probabilities, ``attention_keep`` inside the flash attention of the
encoders and of the decoder's cross-attention. The arithmetic is written
here again, in int64 with explicit masks, and holds no code of the
program.

Parameters are a flat dict ``name -> tensor`` under the names
``param_specs`` gives. Every product goes through a ``Numerics``: float32
(the reference) or float8 e4m3 with one scale per tensor (the control).
Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

M32 = 0xFFFFFFFF
PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
          0x165667B1, 0xFF51AFD7, 0xC4CEB9FF, 0x2545F491)
NEG = -1e9


# ------------------------------------------------------------------ numerics

class Numerics:
    """How products are computed: ``"fp32"`` (TF32 off), or ``"fp8"``: both
    operands rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude to 448), then multiplied in float32."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        # rounded in the forward, straight through in the backward
        return x + (q - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._round(a), self._round(b))


def strict_float32() -> None:
    """Products in full float32 on the card: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# --------------------------------------------------------------- counter hash

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): int64 multiplication
    wraps modulo 2**64, which keeps the low 32 bits of the product."""
    return (x * c) & M32


def murmur(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2**32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur_int(h: int) -> int:
    h &= M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def fold_seed(seed: int, index: int) -> int:
    return murmur_int(seed * PRIMES[0] + (index + 1) * PRIMES[1])


class Seeds:
    """The dropout seeds of one part of a step: ``fold(i)`` names a sub-part
    (a tower, a layer), ``site(i)`` the 32-bit seed of one dropout site."""

    def __init__(self, seed: int):
        self.seed = seed & M32

    def fold(self, index: int) -> "Seeds":
        return Seeds(fold_seed(self.seed, index))

    def site(self, index: int) -> int:
        return fold_seed(self.seed, 1_000_003 + index)


def step_seeds(run_seed: int, step: int) -> Seeds:
    """The seeds of training step ``step`` (0-based) of a run."""
    return Seeds(fold_seed(run_seed & M32, step))


def _fold(s: Optional[Seeds], i: int) -> Optional[Seeds]:
    return None if s is None else s.fold(i)


def _site(s: Optional[Seeds], i: int) -> Optional[int]:
    return None if s is None else s.site(i)


def hidden_dropout(x: torch.Tensor, rate: float, seed: Optional[int],
                   row0: int = 0) -> torch.Tensor:
    """Inverted dropout whose keep bit of element (i0, i1, ...) is
    murmur(seed ^ i0*P0 ^ i1*P1 ^ ...) >= round(rate * 2**32); i0 counts
    from ``row0`` (the block's first row in the whole batch)."""
    if seed is None or rate == 0.0:
        return x
    t = round(rate * 4294967296.0)
    h = None
    for axis, n in enumerate(x.shape):
        idx = torch.arange(n, device=x.device, dtype=torch.int64)
        if axis == 0:
            idx = idx + row0
        shape = [1] * x.dim()
        shape[axis] = n
        idx = _mul32(idx, PRIMES[axis % len(PRIMES)]).view(shape)
        h = idx ^ seed if h is None else h ^ idx
    keep = murmur(h) >= t
    scale = 4294967296.0 / (4294967296 - t)
    return torch.where(keep, x * scale, torch.zeros((), device=x.device))


def attention_keep(seed: int, rate: float, b0: int, B: int, nh: int,
                   Lq: int, Lk: int, chunk: int,
                   device) -> torch.Tensor:
    """[B, nh, Lq, Lk] keep mask of the flash attention kernels: query r,
    key ``j * chunk + col`` of (batch row b0 + b, head h) is kept iff
    murmur((r*P0) ^ (col*P1) ^ (seed + j*P4 + ((b0+b)*nh + h)*P3)) >=
    int(rate * 2**32)."""
    thr = min(int(rate * 4294967296.0), M32)
    r = _mul32(torch.arange(Lq, device=device, dtype=torch.int64), PRIMES[0])
    key = torch.arange(Lk, device=device, dtype=torch.int64)
    col = _mul32(key % chunk, PRIMES[1])
    jterm = (seed + _mul32(key // chunk, PRIMES[4])) & M32
    bh = ((b0 + torch.arange(B, device=device, dtype=torch.int64))[:, None]
          * nh + torch.arange(nh, device=device, dtype=torch.int64))
    base = (_mul32(bh, PRIMES[3])[..., None] + jterm) & M32     # [B, nh, Lk]
    x = r[:, None] ^ col[None, :]                                # [Lq, Lk]
    return murmur(x[None, None] ^ base[:, :, None, :]) >= thr


# ------------------------------------------------------------------- layers

def layer_norm(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def gelu(x, variant: str):
    if variant == "erf":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def key_bias(ids: torch.Tensor) -> torch.Tensor:
    """[B, L] ids -> [B, L] additive bias: 0 for real tokens, -1e9 for pad
    (id 0)."""
    return torch.where(ids >= 1, 0.0, NEG).float()


def _heads(t, n, nh):
    """[B, L, n*H] -> n tensors [B, nh, L, hd]."""
    B, L, _ = t.shape
    parts = t.view(B, L, n, nh, -1).permute(2, 0, 3, 1, 4)
    return [parts[i] for i in range(n)]


def _merge(o):
    B, nh, L, hd = o.shape
    return o.permute(0, 2, 1, 3).reshape(B, L, nh * hd)


def _attend(q, k, v, bias, num: Numerics, keep=None, rate=0.0,
            prob_drop=None):
    """softmax(q k^T / sqrt(hd) + bias) v, heads first; ``keep`` drops the
    probabilities (scaled by 1 / (1 - rate)), ``prob_drop`` applies
    another dropout to them."""
    s = num.mm(q, k.transpose(-1, -2)) * (q.shape[-1] ** -0.5) + bias
    p = torch.softmax(s, dim=-1)
    del s
    if keep is not None:
        p = torch.where(keep, p / (1.0 - rate),
                        torch.zeros((), device=p.device))
    if prob_drop is not None:
        p = prob_drop(p)
    return num.mm(p, v)


def _dense(p, name, x, num):
    return num.mm(x, p[name + ".kernel"]) + p[name + ".bias"]


def _ln(p, name, x, eps):
    return layer_norm(x, p[name + ".weight"], p[name + ".bias"], eps)


def embeddings(p, pre, ids, cfg, seeds: Optional[Seeds], row0: int,
               types=None, position0: int = 0):
    L = ids.shape[-1]
    x = p[pre + "word_embeddings"][ids]
    x = x + p[pre + "position_embeddings"][position0:position0 + L]
    if cfg["num_tokentypes"] > 0:
        t = torch.zeros_like(ids) if types is None else types
        x = x + p[pre + "tokentype_embeddings"][t]
    return hidden_dropout(x, cfg["hidden_dropout"], _site(seeds, 0), row0)


def encoder_layer(p, pre, x, bias, cfg, seeds, row0, num):
    """Pre-LN block: flash self-attention over non-pad keys + GELU MLP."""
    eps, nh = cfg["layernorm_epsilon"], cfg["num_heads"]
    B, L, _ = x.shape
    h = _ln(p, pre + "ln_self", x, eps)
    q, k, v = _heads(_dense(p, pre + "self_attention.qkv", h, num), 3, nh)
    keep, rate = None, cfg["attention_dropout"]
    if seeds is not None and rate:
        keep = attention_keep(seeds.site(0), rate, row0, B, nh, L, L,
                              min(cfg["flash_key_chunk"], L), x.device)
    o = _attend(q, k, v, bias[:, None, None, :], num, keep, rate)
    a = _dense(p, pre + "self_attention.out", _merge(o), num)
    x = x + hidden_dropout(a, cfg["hidden_dropout"], _site(seeds, 1), row0)
    h = _ln(p, pre + "ln_mlp", x, eps)
    f = _dense(p, pre + "mlp.wo",
               gelu(_dense(p, pre + "mlp.wi", h, num), cfg["gelu"]), num)
    return x + hidden_dropout(f, cfg["hidden_dropout"], _site(seeds, 4), row0)


def encoder_stack(p, pre, x, bias, cfg, seeds, row0, num):
    for i in range(cfg["num_layers"]):
        x = encoder_layer(p, f"{pre}layer_{i}.", x, bias, cfg,
                          _fold(seeds, i), row0, num)
    return _ln(p, pre + "ln_final", x, cfg["layernorm_epsilon"])


def decoder_layer(p, pre, x, self_bias, enc, enc_bias, cfg, seeds, row0,
                  num):
    """Pre-LN block: causal self-attention (materialized, its probabilities
    dropped by ``hidden_dropout``'s hash), cross-attention over all encoder
    states (the flash kernel's keep mask), GELU MLP."""
    eps, nh = cfg["layernorm_epsilon"], cfg["num_heads"]
    hdrop, adrop = cfg["hidden_dropout"], cfg["attention_dropout"]
    B, Ld, _ = x.shape
    Lk = enc.shape[1]
    h = _ln(p, pre + "ln_self", x, eps)
    q, k, v = _heads(_dense(p, pre + "self_attention.qkv", h, num), 3, nh)
    prob_drop = None
    if seeds is not None and adrop:
        site = seeds.site(0)
        prob_drop = lambda t: hidden_dropout(t, adrop, site, row0)  # noqa
    o = _attend(q, k, v, self_bias, num, prob_drop=prob_drop)
    a = _dense(p, pre + "self_attention.out", _merge(o), num)
    x = x + hidden_dropout(a, hdrop, _site(seeds, 1), row0)
    h = _ln(p, pre + "ln_cross", x, eps)
    (q,) = _heads(_dense(p, pre + "cross_attention.query", h, num), 1, nh)
    k, v = _heads(_dense(p, pre + "cross_attention.key_value", enc, num), 2,
                  nh)
    keep = None
    if seeds is not None and adrop:
        keep = attention_keep(seeds.site(2), adrop, row0, B, nh, Ld, Lk,
                              min(cfg["flash_key_chunk"], Lk), x.device)
    o = _attend(q, k, v, enc_bias[:, None, None, :], num, keep, adrop)
    del q, k, v, keep
    a = _dense(p, pre + "cross_attention.out", _merge(o), num)
    x = x + hidden_dropout(a, hdrop, _site(seeds, 3), row0)
    h = _ln(p, pre + "ln_mlp", x, eps)
    f = _dense(p, pre + "mlp.wo",
               gelu(_dense(p, pre + "mlp.wi", h, num), cfg["gelu"]), num)
    return x + hidden_dropout(f, hdrop, _site(seeds, 4), row0)


# ---------------------------------------------------------------- the towers

def bert_cls(p, pre, ids, cfg, seeds: Optional[Seeds], num: Numerics,
             types=None, row0: int = 0) -> torch.Tensor:
    """BERT tower ``pre`` (e.g. ``retriever.context_model.``) -> [B, H]
    [CLS] states."""
    x = embeddings(p, pre + "embeddings.", ids, cfg, _fold(seeds, 0), row0,
                   types)
    x = encoder_stack(p, pre + "encoder.", x, key_bias(ids), cfg,
                      _fold(seeds, 1), row0, num)
    return x[:, 0]


def t5_encode(p, ids, cfg, seeds, num, row0=0):
    """Reader encoder: [R, Lr] ids -> [R, Lr, H], each row alone."""
    x = embeddings(p, "reader.shared_embeddings.", ids, cfg, _fold(seeds, 0),
                   row0)
    return encoder_stack(p, "reader.encoder.", x, key_bias(ids), cfg,
                         _fold(seeds, 1), row0, num)


def t5_decode(p, dec_ids, enc, enc_ids, cfg, seeds, num, row0=0):
    """Reader decoder over all encoder states -> [B, Ld, V] logits.
    ``enc`` [B, Lk, H], ``enc_ids`` [B, Lk] (pad keys are masked)."""
    x = embeddings(p, "reader.shared_embeddings.", dec_ids, cfg,
                   _fold(seeds, 2), row0)
    real = dec_ids >= 1
    Ld = dec_ids.shape[-1]
    causal = torch.ones(Ld, Ld, dtype=torch.bool,
                        device=dec_ids.device).tril()
    allowed = real[:, :, None] & real[:, None, :] & causal
    self_bias = torch.where(allowed, 0.0, NEG)[:, None]
    enc_bias = key_bias(enc_ids)
    dseeds = _fold(seeds, 3)
    for i in range(cfg["num_layers"]):
        x = decoder_layer(p, f"reader.decoder.layer_{i}.", x, self_bias, enc,
                          enc_bias, cfg, _fold(dseeds, i), row0, num)
    x = _ln(p, "reader.decoder.ln_final", x, cfg["layernorm_epsilon"])
    return (num.mm(x, p["reader.shared_embeddings.word_embeddings"].T)
            + p["reader.lm_bias"])


# ------------------------------------------------------------- parameters

def _stack_specs(pre, cfg, cross: bool) -> List[Tuple[str, tuple, str]]:
    H, F = cfg["hidden_size"], cfg["ffn_size"]
    out = []
    for i in range(cfg["num_layers"]):
        lp = f"{pre}layer_{i}."
        out += [(lp + "ln_self.weight", (H,), "one"),
                (lp + "ln_self.bias", (H,), "zero"),
                (lp + "self_attention.qkv.kernel", (H, 3 * H), "normal"),
                (lp + "self_attention.qkv.bias", (3 * H,), "zero"),
                (lp + "self_attention.out.kernel", (H, H), "out"),
                (lp + "self_attention.out.bias", (H,), "zero")]
        if cross:
            out += [(lp + "ln_cross.weight", (H,), "one"),
                    (lp + "ln_cross.bias", (H,), "zero"),
                    (lp + "cross_attention.query.kernel", (H, H), "normal"),
                    (lp + "cross_attention.query.bias", (H,), "zero"),
                    (lp + "cross_attention.key_value.kernel", (H, 2 * H),
                     "normal"),
                    (lp + "cross_attention.key_value.bias", (2 * H,), "zero"),
                    (lp + "cross_attention.out.kernel", (H, H), "out"),
                    (lp + "cross_attention.out.bias", (H,), "zero")]
        out += [(lp + "ln_mlp.weight", (H,), "one"),
                (lp + "ln_mlp.bias", (H,), "zero"),
                (lp + "mlp.wi.kernel", (H, F), "normal"),
                (lp + "mlp.wi.bias", (F,), "zero"),
                (lp + "mlp.wo.kernel", (F, H), "out"),
                (lp + "mlp.wo.bias", (H,), "zero")]
    return out + [(pre + "ln_final.weight", (H,), "one"),
                  (pre + "ln_final.bias", (H,), "zero")]


def _embed_specs(pre, cfg):
    H = cfg["hidden_size"]
    out = [(pre + "word_embeddings", (cfg["vocab_size"], H), "normal"),
           (pre + "position_embeddings",
            (cfg["max_position_embeddings"], H), "normal")]
    if cfg["num_tokentypes"] > 0:
        out.append((pre + "tokentype_embeddings",
                    (cfg["num_tokentypes"], H), "normal"))
    return out


def bert_specs(pre, cfg):
    return (_embed_specs(pre + "embeddings.", cfg)
            + _stack_specs(pre + "encoder.", cfg, cross=False))


def param_specs(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter of a configuration's model:
    ``model["retriever"]`` alone (a dual encoder) or with
    ``model["reader"]`` (EMDR2). Init: ``normal`` N(0, init_std), ``out``
    N(0, init_std / sqrt(2 * layers)), ``zero``, ``one``."""
    r = model["retriever"]
    specs = bert_specs("query_model.", r) + bert_specs("context_model.", r)
    if "reader" not in model:
        return specs
    t = model["reader"]
    return ([("retriever." + n, s, i) for n, s, i in specs]
            + [("reader.lm_bias", (t["vocab_size"],), "zero")]
            + _embed_specs("reader.shared_embeddings.", t)
            + _stack_specs("reader.encoder.", t, cross=False)
            + _stack_specs("reader.decoder.", t, cross=True))


def make_params(model: dict, seed: int, device,
                prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed``, made on ``device`` in one normal
    draw: a ``torch.Generator`` on that device fills one flat buffer,
    which is cut into the leaves and scaled by each leaf's std. Only the
    leaves whose names start with ``prefix``."""
    specs = [s for s in param_specs(model) if s[0].startswith(prefix)]
    stds = {"retriever": model["retriever"]["init_std"],
            "reader": model.get("reader", model["retriever"])["init_std"]}
    layers = {"retriever": model["retriever"]["num_layers"],
              "reader": model.get("reader", model["retriever"])["num_layers"]}
    drawn = [(n, s, i) for n, s, i in specs if i in ("normal", "out")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    params, at = {}, 0
    for name, shape, init in specs:
        part = "reader" if name.startswith("reader.") else "retriever"
        if init in ("normal", "out"):
            n = math.prod(shape)
            std = stds[part]
            if init == "out":
                std = std / math.sqrt(2.0 * layers[part])
            params[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif init == "zero":
            params[name] = torch.zeros(shape, device=device)
        else:
            params[name] = torch.ones(shape, device=device)
    return params
