"""Plain PyTorch reference of one EMDR2 training step, in float32.

The step (EMDR2, arXiv:2106.05346, section 3): the question's [CLS] state
against each retrieved passage's gives log-probabilities over the K
passages; the FiD reader reads all K and gives the answer's token
log-probabilities; a teacher, the same reader run on one passage at a
time without gradient, gives each passage's gold log-probabilities. The
loss is the reader's token cross-entropy plus the marginal
``-sum_t logsumexp_k(log p(k|q) + log p_teacher(y_t|q, k))`` over the
answer's tokens, both over the count of answer tokens. Then the global
gradient norm is clipped to ``clip_grad`` and AdamW updates every
parameter with the linearly warmed-up and decayed learning rate (weight
decay skips biases and LayerNorms).

The passes over B*K rows run in blocks so that the step fits beside
nothing else on one card: the encoders first run without gradient, the
loss's gradient with respect to their outputs comes back, and each block
is run again with gradient and given its part of it. The mathematics is
that of the whole batch; the dropout hash takes each block's first row.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from benchmark.reference.model import (Numerics, Seeds, bert_cls,
                                       t5_decode, t5_encode)


class StepInputs(NamedTuple):
    """One step's inputs, on the card: B questions, K passages."""

    query_ids: torch.Tensor          # [B, Lq]
    context_ids: torch.Tensor        # [B, K, Lc]
    context_types: torch.Tensor      # [B, K, Lc]
    reader_ids: torch.Tensor         # [B, K, Lr]
    teacher_ids: torch.Tensor        # [B, K, Lr]
    dec_ids: torch.Tensor            # [B, Ld]
    labels: torch.Tensor             # [B, Ld]
    loss_mask: torch.Tensor          # [B, Ld] float


def _blocks(n: int, size: int):
    for s in range(0, n, size):
        yield s, min(n, s + size)


def step_loss(p, x: StepInputs, model: dict, seeds: Optional[Seeds],
              num: Numerics, eos_id: int, block_rows: int = 16,
              rows: Optional[int] = None):
    """Forward and backward of the EMDR2 loss; gradients land in
    ``p[name].grad``. Returns the loss as a float.
    ``rows`` (a fault only the benchmark's own test plants) keeps the
    first ``rows`` questions and averages over them."""
    rc, tc = model["retriever"], model["reader"]
    if rows is not None:
        x = StepInputs(*(t[:rows] for t in x))
    B, K, Lc = x.context_ids.shape
    Lr = x.reader_ids.shape[-1]
    d_topk, d_enc, d_dec, d_teach = (seeds.fold(i) if seeds is not None
                                     else None for i in range(4))
    q_seeds = d_topk.fold(0) if d_topk is not None else None
    c_seeds = d_topk.fold(1) if d_topk is not None else None

    # retriever: question and passage [CLS] states -> log p(k | q)
    q = bert_cls(p, "retriever.query_model.", x.query_ids, rc, q_seeds, num)
    ctx_ids = x.context_ids.reshape(B * K, Lc)
    ctx_types = x.context_types.reshape(B * K, Lc)
    with torch.no_grad():
        c = torch.cat([bert_cls(p, "retriever.context_model.",
                                ctx_ids[s:e], rc, c_seeds, num,
                                ctx_types[s:e], row0=s)
                       for s, e in _blocks(B * K, 2 * block_rows)])
    c.requires_grad_(True)
    scores = torch.einsum("bd,bkd->bk", q, c.view(B, K, -1))
    if model["retriever_score_scaling"]:
        scores = scores / math.sqrt(rc["hidden_size"])
    topk_lp = torch.log_softmax(scores, dim=-1)

    # reader: FiD encoder over B*K rows, decoder over all of a question's
    rd_ids = x.reader_ids.reshape(B * K, Lr)
    with torch.no_grad():
        enc = torch.cat([t5_encode(p, rd_ids[s:e], tc, d_enc, num, row0=s)
                         for s, e in _blocks(B * K, block_rows)])
    enc.requires_grad_(True)
    logits = t5_decode(p, x.dec_ids, enc.view(B, K * Lr, -1),
                       x.reader_ids.reshape(B, K * Lr), tc, d_dec, num)

    # teacher: the reader on one passage at a time, no gradient
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
    gold = torch.cat(gold).view(B, K, -1)

    # the loss
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

    # the blocks again, with gradient, each given its part of d(loss)
    for s, e in _blocks(B * K, 2 * block_rows):
        out = bert_cls(p, "retriever.context_model.", ctx_ids[s:e], rc,
                       c_seeds, num, ctx_types[s:e], row0=s)
        out.backward(c.grad[s:e])
    for s, e in _blocks(B * K, block_rows):
        out = t5_encode(p, rd_ids[s:e], tc, d_enc, num, row0=s)
        out.backward(enc.grad[s:e])
    return value


def no_decay(name: str) -> bool:
    """Biases, the LM bias and every LayerNorm take no weight decay."""
    parts = name.split(".")
    return parts[-1] in ("bias", "lm_bias") or any(
        q.startswith("ln_") for q in parts)


def learning_rate(opt: dict, step: int) -> float:
    """The recipe's AnnealingLR at update ``step`` (0-based): linear warmup
    over ``warmup * train_iters`` updates, then linear decay; the first
    update's rate is 0 under warmup."""
    total = opt["train_iters"]
    warm = int(opt["warmup"] * total)
    lr0 = opt["lr"]
    capped = min(step, total - warm)
    if warm > 0 and step <= warm:
        return lr0 * capped / warm
    # the recipe's decay measures progress over all the updates
    return max(lr0 * (total - (capped - warm)) / total, opt["min_lr"])


class AdamW:
    """Global-norm clip, then AdamW (decoupled weight decay), per leaf."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.params, self.opt = params, opt
        self.m = {n: torch.zeros_like(t) for n, t in params.items()}
        self.v = {n: torch.zeros_like(t) for n, t in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self):
        """-> (global norm before the clip, {name: clipped gradient})."""
        o = self.opt
        grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for n, t in self.params.items()}
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads.values()))
        if norm >= o["clip_grad"]:
            grads = {n: g / norm * o["clip_grad"] for n, g in grads.items()}
        lr = learning_rate(o, self.count)
        self.count += 1
        t = self.count
        b1, b2, eps = o["adam_beta1"], o["adam_beta2"], o["adam_eps"]
        for n, w in self.params.items():
            g = grads[n]
            if not no_decay(n):
                w.mul_(1.0 - lr * o["weight_decay"])
            self.m[n].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[n].mul_(b2).add_(g * g, alpha=1.0 - b2)
            mhat = self.m[n] / (1.0 - b1 ** t)
            vhat = self.v[n] / (1.0 - b2 ** t)
            w.sub_(lr * mhat / (vhat.sqrt() + eps))
            w.grad = None
        return norm, grads
