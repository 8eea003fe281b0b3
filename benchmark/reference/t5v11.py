"""Plain PyTorch reference of the EMDR2 step with a T5 v1.1 reader, in
float32 (TF32 off), for the ``atlas-large-nq`` configuration.

The reader is Atlas's (Izacard et al., arXiv:2208.03299): a T5 v1.1
LM-adapted encoder-decoder (``google/t5-large-lm-adapt``), written here from
HF's ``T5Block`` equations:

- ``RMSNorm(x) = w * x * rsqrt(mean(x^2) + eps)`` in float32, no mean, no
  bias;
- self-attention ``softmax(q k^T + B[h, bucket(j - i)] + mask) v``, no
  ``1/sqrt(d)`` scale and no biases; ``B`` is one learned [buckets, heads]
  table a stack, bidirectional buckets in the encoder (half a side, exact
  below a quarter of them, logarithmic up to ``max_distance``), causal in
  the decoder (exact below half); cross-attention likewise, with no
  position bias;
- the FFN ``dropout(gelu_tanh(n W_i0) * (n W_i1)) W_o``;
- shared word embeddings with no positions and no scaling, a final RMSNorm
  and dropout a stack, an untied LM head with no bias and no rescale.

The retriever (the BERT towers), the EMDR2 loss, the teacher and AdamW are
``model.py``'s and ``train.py``'s. Parameters are named as the program
names them (fused ``qkv`` and ``key_value`` kernels, [in, out] layouts).

Departures from HF's T5, all to follow the program's step:

- dropout masks are the counter hash of ``model.py`` (``hidden_dropout``
  on the embeddings, each residual branch, the gated product, the stacks'
  outputs and the decoder's self-attention probabilities,
  ``attention_keep`` inside the encoder's and the cross-attention's flash
  kernels), from the step's seeds, where HF draws from torch's generator;
- the key-side pad mask is -1e9 on pad keys (id 0) where HF's is the dtype's
  minimum;
- the buckets are computed on the host in float32 from integer offsets, as
  the program computes them;
- the init is T5's (``make_params``): q N(0, (d d_kv)^-1/2), k, v and
  the FFN's inputs N(0, d^-1/2), the attention's output N(0, (nh
  d_kv)^-1/2), the FFN's output N(0, d_ff^-1/2), the table N(0, d^-1/2),
  embeddings and head N(0, 1); the towers' is ``model.py``'s; everything
  is drawn from one normal buffer of the seed, in the order of
  ``param_specs``.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference.model import (NEG, Numerics, Seeds, _fold, _heads,
                                       _merge, _site, attention_keep,
                                       bert_cls, bert_specs, hidden_dropout,
                                       key_bias)
from benchmark.reference.train import StepInputs, _blocks


# --------------------------------------------------------------- the block

def relative_bucket(offsets: torch.Tensor, bidirectional: bool,
                    num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's bucket of each offset ``j - i`` (memory minus query position)."""
    rel = offsets.to("cpu", torch.int64)
    out = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        out += (rel > 0).long() * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.minimum(rel, torch.zeros_like(rel))
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (torch.log(rel.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.minimum(large, torch.full_like(large, num_buckets - 1))
    return out + torch.where(is_small, rel, large)


def position_bias(p, pre, Lq, Lk, cfg, bidirectional, device):
    """[1, nh, Lq, Lk] float32: the stack's table at each pair's bucket."""
    i = torch.arange(Lq)[:, None]
    j = torch.arange(Lk)[None, :]
    b = relative_bucket(j - i, bidirectional,
                        cfg["relative_attention_num_buckets"],
                        cfg["relative_attention_max_distance"]).to(device)
    return p[pre + "relative_attention_bias"][b].permute(2, 0, 1)[None]


def rms_norm(p, name, x, eps):
    w = p[name + ".weight"]
    return w * x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def _mm(p, name, x, num):
    return num.mm(x, p[name + ".kernel"])


def _attend(q, k, v, bias, num, keep=None, rate=0.0, prob_drop=None):
    """softmax(q k^T + bias) v, heads first, no scale."""
    s = num.mm(q, k.transpose(-1, -2)) + bias
    prob = torch.softmax(s, dim=-1)
    del s
    if keep is not None:
        prob = torch.where(keep, prob / (1.0 - rate),
                           torch.zeros((), device=prob.device))
    if prob_drop is not None:
        prob = prob_drop(prob)
    return num.mm(prob, v)


def _ffn(p, pre, h, cfg, seeds, row0, num):
    g = gelu_tanh(_mm(p, pre + "mlp.wi_0", h, num)) * _mm(p, pre + "mlp.wi_1",
                                                          h, num)
    g = hidden_dropout(g, cfg["dropout_rate"], _site(seeds, 5), row0)
    return _mm(p, pre + "mlp.wo", g, num)


def encoder_layer(p, pre, x, bias, cfg, seeds, row0, num):
    eps, nh, rate = (cfg["layer_norm_epsilon"], cfg["num_heads"],
                     cfg["dropout_rate"])
    B, L, _ = x.shape
    h = rms_norm(p, pre + "ln_self", x, eps)
    q, k, v = _heads(_mm(p, pre + "self_attention.qkv", h, num), 3, nh)
    keep = None
    if seeds is not None and rate:
        keep = attention_keep(seeds.site(0), rate, row0, B, nh, L, L,
                              min(cfg["flash_key_chunk"], L), x.device)
    o = _attend(q, k, v, bias, num, keep, rate)
    a = _mm(p, pre + "self_attention.out", _merge(o), num)
    x = x + hidden_dropout(a, rate, _site(seeds, 1), row0)
    h = rms_norm(p, pre + "ln_mlp", x, eps)
    return x + hidden_dropout(_ffn(p, pre, h, cfg, seeds, row0, num), rate,
                              _site(seeds, 4), row0)


def decoder_layer(p, pre, x, self_bias, enc, enc_bias, cfg, seeds, row0,
                  num):
    eps, nh, rate = (cfg["layer_norm_epsilon"], cfg["num_heads"],
                     cfg["dropout_rate"])
    B, Ld, _ = x.shape
    Lk = enc.shape[1]
    h = rms_norm(p, pre + "ln_self", x, eps)
    q, k, v = _heads(_mm(p, pre + "self_attention.qkv", h, num), 3, nh)
    prob_drop = None
    if seeds is not None and rate:
        site = seeds.site(0)
        prob_drop = lambda t: hidden_dropout(t, rate, site, row0)  # noqa
    o = _attend(q, k, v, self_bias, num, prob_drop=prob_drop)
    a = _mm(p, pre + "self_attention.out", _merge(o), num)
    x = x + hidden_dropout(a, rate, _site(seeds, 1), row0)
    h = rms_norm(p, pre + "ln_cross", x, eps)
    (q,) = _heads(_mm(p, pre + "cross_attention.query", h, num), 1, nh)
    k, v = _heads(_mm(p, pre + "cross_attention.key_value", enc, num), 2, nh)
    keep = None
    if seeds is not None and rate:
        keep = attention_keep(seeds.site(2), rate, row0, B, nh, Ld, Lk,
                              min(cfg["flash_key_chunk"], Lk), x.device)
    o = _attend(q, k, v, enc_bias[:, None, None, :], num, keep, rate)
    del q, k, v, keep
    a = _mm(p, pre + "cross_attention.out", _merge(o), num)
    x = x + hidden_dropout(a, rate, _site(seeds, 3), row0)
    h = rms_norm(p, pre + "ln_mlp", x, eps)
    return x + hidden_dropout(_ffn(p, pre, h, cfg, seeds, row0, num), rate,
                              _site(seeds, 4), row0)


def _finish(p, pre, x, cfg, seeds, row0):
    x = rms_norm(p, pre + "ln_final", x, cfg["layer_norm_epsilon"])
    return hidden_dropout(x, cfg["dropout_rate"], _site(seeds, 0), row0)


def _embed(p, ids, cfg, seeds, row0):
    x = p["reader.shared_embeddings.word_embeddings"][ids]
    return hidden_dropout(x, cfg["dropout_rate"], _site(seeds, 0), row0)


def t5_encode(p, ids, cfg, seeds, num, row0=0):
    """Reader encoder: [R, Lr] ids -> [R, Lr, H], each row alone."""
    pre = "reader.encoder."
    L = ids.shape[-1]
    x = _embed(p, ids, cfg, _fold(seeds, 0), row0)
    bias = (key_bias(ids)[:, None, None, :]
            + position_bias(p, pre, L, L, cfg, True, ids.device))
    sseeds = _fold(seeds, 1)
    for i in range(cfg["num_layers"]):
        x = encoder_layer(p, f"{pre}layer_{i}.", x, bias, cfg,
                          _fold(sseeds, i), row0, num)
    return _finish(p, pre, x, cfg, sseeds, row0)


def t5_decode(p, dec_ids, enc, enc_ids, cfg, seeds, num, row0=0):
    """Reader decoder over all encoder states -> [B, Ld, V] logits."""
    pre = "reader.decoder."
    x = _embed(p, dec_ids, cfg, _fold(seeds, 2), row0)
    real = dec_ids >= 1
    Ld = dec_ids.shape[-1]
    causal = torch.ones(Ld, Ld, dtype=torch.bool,
                        device=dec_ids.device).tril()
    allowed = real[:, :, None] & real[:, None, :] & causal
    self_bias = (torch.where(allowed, 0.0, NEG)[:, None]
                 + position_bias(p, pre, Ld, Ld, cfg, False, dec_ids.device))
    enc_bias = key_bias(enc_ids)
    dseeds = _fold(seeds, 3)
    for i in range(cfg["num_decoder_layers"]):
        x = decoder_layer(p, f"{pre}layer_{i}.", x, self_bias, enc,
                          enc_bias, cfg, _fold(dseeds, i), row0, num)
    x = _finish(p, pre, x, cfg, dseeds, row0)
    return num.mm(x, p["reader.lm_head"].T)


# ---------------------------------------------------------------- the step

def step_loss(p, x: StepInputs, model: dict, seeds: Optional[Seeds],
              num: Numerics, eos_id: int, block_rows: int = 8,
              rows: Optional[int] = None):
    """``train.step_loss`` with the T5 v1.1 reader: forward and backward of
    the EMDR2 loss in blocks of rows; gradients land in ``p[name].grad``.
    Returns the loss as a float. ``rows`` keeps the first ``rows``
    questions (a planted fault)."""
    rc, tc = model["retriever"], model["reader"]
    if rows is not None:
        x = StepInputs(*(t[:rows] for t in x))
    B, K, Lc = x.context_ids.shape
    Lr = x.reader_ids.shape[-1]
    d_topk, d_enc, d_dec, d_teach = (seeds.fold(i) if seeds is not None
                                     else None for i in range(4))
    q_seeds = d_topk.fold(0) if d_topk is not None else None
    c_seeds = d_topk.fold(1) if d_topk is not None else None

    q = bert_cls(p, "retriever.query_model.", x.query_ids, rc, q_seeds, num)
    ctx_ids = x.context_ids.reshape(B * K, Lc)
    ctx_types = x.context_types.reshape(B * K, Lc)
    with torch.no_grad():
        c = torch.cat([bert_cls(p, "retriever.context_model.",
                                ctx_ids[s:e], rc, c_seeds, num,
                                ctx_types[s:e], row0=s)
                       for s, e in _blocks(B * K, 4 * block_rows)])
    c.requires_grad_(True)
    scores = torch.einsum("bd,bkd->bk", q, c.view(B, K, -1))
    if model["retriever_score_scaling"]:
        scores = scores / math.sqrt(rc["hidden_size"])
    topk_lp = torch.log_softmax(scores, dim=-1)

    rd_ids = x.reader_ids.reshape(B * K, Lr)
    with torch.no_grad():
        enc = torch.cat([t5_encode(p, rd_ids[s:e], tc, d_enc, num, row0=s)
                         for s, e in _blocks(B * K, block_rows)])
    enc.requires_grad_(True)
    logits = t5_decode(p, x.dec_ids, enc.view(B, K * Lr, -1),
                       x.reader_ids.reshape(B, K * Lr), tc, d_dec, num)

    t_ids = x.teacher_ids.reshape(B * K, Lr)
    dec_rep = x.dec_ids.repeat_interleave(K, dim=0)
    lab_rep = x.labels.repeat_interleave(K, dim=0)
    t_enc_seeds = d_teach.fold(0) if d_teach is not None else None
    t_dec_seeds = d_teach.fold(1) if d_teach is not None else None
    gold = []
    with torch.no_grad():
        for s, e in _blocks(B * K, block_rows):
            te = t5_encode(p, t_ids[s:e], tc, t_enc_seeds, num, row0=s)
            lg = t5_decode(p, dec_rep[s:e], te, t_ids[s:e], tc, t_dec_seeds,
                           num, row0=s)
            gold.append(torch.log_softmax(lg, dim=-1).gather(
                -1, lab_rep[s:e, :, None].long())[..., 0])
            del te, lg
    gold = torch.cat(gold).view(B, K, -1)

    mask = x.loss_mask
    safe = torch.where(mask > 0, x.labels, torch.zeros_like(x.labels))
    n_tok = mask.sum()
    lp = torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None].long())
    lm_loss = -(lp[..., 0] * mask).sum() / n_tok
    marginal = torch.logsumexp(topk_lp[:, :, None] + gold, dim=1)
    ret_loss = -(marginal * mask).sum() / n_tok
    loss = lm_loss + ret_loss
    loss.backward()
    value = float(loss.detach())

    for s, e in _blocks(B * K, 4 * block_rows):
        out = bert_cls(p, "retriever.context_model.", ctx_ids[s:e], rc,
                       c_seeds, num, ctx_types[s:e], row0=s)
        out.backward(c.grad[s:e])
    for s, e in _blocks(B * K, block_rows):
        out = t5_encode(p, rd_ids[s:e], tc, d_enc, num, row0=s)
        out.backward(enc.grad[s:e])
    return value


# ------------------------------------------------------------- parameters

def _reader_stack_specs(pre, t, cross):
    H, F, nh, dkv = (t["d_model"], t["d_ff"], t["num_heads"], t["d_kv"])
    q_std, kv_std, o_std = (H * dkv) ** -0.5, H ** -0.5, (nh * dkv) ** -0.5
    n = t["num_decoder_layers"] if cross else t["num_layers"]
    out = [(pre + "relative_attention_bias",
            (t["relative_attention_num_buckets"], nh), H ** -0.5)]
    for i in range(n):
        lp = f"{pre}layer_{i}."
        out += [(lp + "ln_self.weight", (H,), None),
                (lp + "self_attention.qkv.kernel", (H, 3 * H),
                 (q_std, kv_std, kv_std)),
                (lp + "self_attention.out.kernel", (H, H), o_std)]
        if cross:
            out += [(lp + "ln_cross.weight", (H,), None),
                    (lp + "cross_attention.query.kernel", (H, H), q_std),
                    (lp + "cross_attention.key_value.kernel", (H, 2 * H),
                     (kv_std, kv_std)),
                    (lp + "cross_attention.out.kernel", (H, H), o_std)]
        out += [(lp + "ln_mlp.weight", (H,), None),
                (lp + "mlp.wi_0.kernel", (H, F), H ** -0.5),
                (lp + "mlp.wi_1.kernel", (H, F), H ** -0.5),
                (lp + "mlp.wo.kernel", (F, H), F ** -0.5)]
    return out + [(pre + "ln_final.weight", (H,), None)]


def param_specs(model: dict) -> List[Tuple[str, tuple, object]]:
    """(name, shape, std) of every parameter: the towers' with
    ``model.py``'s init names (``normal``, ``out``, ``zero``, ``one``), the
    reader's with T5's std (a float, a tuple of stds for the column blocks
    of a fused kernel, or None for a norm's weight of ones)."""
    r, t = model["retriever"], model["reader"]
    specs = [("retriever." + n, s, i) for n, s, i in
             bert_specs("query_model.", r) + bert_specs("context_model.", r)]
    V, H = t["vocab_size"], t["d_model"]
    return (specs + [("reader.lm_head", (V, H), 1.0),
                     ("reader.shared_embeddings.word_embeddings", (V, H),
                      1.0)]
            + _reader_stack_specs("reader.encoder.", t, cross=False)
            + _reader_stack_specs("reader.decoder.", t, cross=True))


def make_params(model: dict, seed: int, device,
                prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every parameter from ``seed``, made on ``device`` in one normal draw
    (as ``model.make_params`` draws it), cut in the order of
    ``param_specs`` and scaled by each leaf's std."""
    specs = [s for s in param_specs(model) if s[0].startswith(prefix)]
    r = model["retriever"]
    tower_std = {"normal": r["init_std"],
                 "out": r["init_std"] / math.sqrt(2.0 * r["num_layers"])}
    drawn = [(n, s) for n, s, i in specs
             if i in tower_std or isinstance(i, (float, tuple))]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    params, at = {}, 0
    for name, shape, init in specs:
        if init in ("zero", "one", None):
            fill = torch.zeros if init == "zero" else torch.ones
            params[name] = fill(shape, device=device)
            continue
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if isinstance(init, tuple):
            blocks = t.view(shape[0], len(init), -1)
            for i, std in enumerate(init):
                blocks[:, i].mul_(std)
        else:
            t.mul_(tower_std.get(init, init))
        params[name] = t
    return params

