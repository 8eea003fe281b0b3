"""Loss functions (port of ``emdr2_tpu/training/losses.py``): the reader
cross-entropy, the EMDR2 marginalized retriever loss, its KL-divergence
variant, their sum, and the DPR in-batch contrastive loss.

Under data parallelism (``dp``, a ``parallel.mesh.DataParallel`` of more
than a bare process) every loss here is the global batch's loss, as the
JAX package computes it over its ``dp`` mesh: each rank returns its
*share*, its rows' numerator over the whole batch's normalizer (a token
count or row count, summed over the ranks), so that the global loss is the
sum of the shares. ``scale_for_mean`` turns a share into the objective
whose gradient, averaged over the ranks (``training/step.py``), is the
global loss's gradient. The DPR loss all-gathers the contexts
(``dpr_in_batch_loss``). Every collective here runs over ``dp``, the
data-parallel group: the tp ranks of one replica hold the same rows, so
gathering or summing over them too would count each row ``tp`` times.

Under tensor parallelism (``tp``) the reader's logits are split over the
vocabulary, and ``reader_cross_entropy`` takes them through
``vocab_parallel_cross_entropy`` (the JAX function of that name, the
reference's ``mpu/cross_entropy.py``): no rank holds the whole [B, L, V].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from emdr2_tpu_torch.parallel.mesh import DataParallel, Group
from emdr2_tpu_torch.parallel.tensor import is_split


def _global_sum(x: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    """``x`` summed over the ranks of ``dp`` (a normalizer: no gradient)."""
    if dp is None or not dp.distributed:
        return x
    return dp.all_reduce_sum(x.detach())


def scale_for_mean(share: torch.Tensor, dp: Optional[DataParallel]
                   ) -> torch.Tensor:
    """The objective whose gradient, averaged over the ranks, is the
    gradient of the sum of the ranks' ``share``s: ``W * share``."""
    if dp is None or not dp.distributed:
        return share
    return share * dp.world_size


class EMDR2LossAux(NamedTuple):
    lm_loss: torch.Tensor
    retriever_loss: torch.Tensor
    retriever_utility: torch.Tensor
    null_block_lm_loss: torch.Tensor


class _VocabParallelCE(torch.autograd.Function):
    """-log p(label) [B, L] fp32 of logits [B, L, V/tp] split over the
    vocabulary by ``tp`` (rank t holds columns t*V/tp ...): the max over
    tp (a constant for the gradient), one sum over tp of the sums of
    exps and the masked gold picks. Backward: softmax minus one-hot on the
    local columns, times the upstream gradient."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        lg = logits.float()
        cols = lg.shape[-1]
        start = tp.rank * cols
        m = tp.all_reduce_max_(lg.amax(dim=-1))
        e = torch.exp(lg - m[..., None])
        mine = (labels >= start) & (labels < start + cols)
        idx = (labels - start).clamp(0, cols - 1).long()
        picked = lg.gather(-1, idx[..., None])[..., 0]
        both = tp.all_reduce_sum_(torch.stack(
            [e.sum(dim=-1), torch.where(mine, picked,
                                        torch.zeros_like(picked))]))
        ctx.save_for_backward(e.div_(both[0][..., None]), idx, mine)
        ctx.dtype = logits.dtype
        return torch.log(both[0]) + m - both[1]

    @staticmethod
    def backward(ctx, grad):
        softmax, idx, mine = ctx.saved_tensors
        g = softmax.clone()
        g.scatter_add_(-1, idx[..., None],
                       -mine[..., None].to(g.dtype))
        g.mul_(grad[..., None])
        return g.to(ctx.dtype), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 tp: Group) -> torch.Tensor:
    """Per-token -log p [B, L] fp32 of ``logits`` [B, L, V/tp] split over
    the vocabulary by ``tp`` (``_VocabParallelCE``; the JAX
    ``vocab_parallel_cross_entropy``)."""
    return _VocabParallelCE.apply(logits, labels, tp)


def reader_cross_entropy(lm_logits: torch.Tensor, labels: torch.Tensor,
                         loss_mask: torch.Tensor,
                         dp: Optional[DataParallel] = None,
                         tp: Optional[Group] = None) -> torch.Tensor:
    """Token CE averaged over unmasked positions (of the global batch under
    ``dp``: this rank's share). lm_logits [B, L, V] fp32, labels [B, L],
    loss_mask [B, L] float. Under ``tp`` lm_logits is this rank's
    [B, L, V/tp] and the CE is vocab-parallel."""
    if is_split(tp):
        nll = vocab_parallel_cross_entropy(lm_logits, labels, tp)
        return (nll * loss_mask).sum() / _global_sum(loss_mask.sum(), dp)
    log_probs = torch.log_softmax(lm_logits.float(), dim=-1)
    gold = log_probs.gather(-1, labels[..., None].long())[..., 0]
    return -(gold * loss_mask).sum() / _global_sum(loss_mask.sum(), dp)


def emdr2_retriever_loss(gold_log_probs: torch.Tensor,
                         topk_log_probs: torch.Tensor, labels: torch.Tensor,
                         loss_mask: torch.Tensor, eos_id: int,
                         dp: Optional[DataParallel] = None) -> EMDR2LossAux:
    """The EMDR2 marginalized objective:
    ``-sum_t mask_t * logsumexp_k(topk_log_probs_k + gold_{k,t}) / sum mask``
    (gradient through ``topk_log_probs`` only), with the retriever utility
    (marginal minus the last document's log-prob over non-EOS, non-sentinel
    tokens) and the null-block LM loss; under ``dp`` this rank's shares."""
    gold_log_probs = gold_log_probs.float()
    topk_log_probs = topk_log_probs.float()
    joint = topk_log_probs[:, :, None] + gold_log_probs        # [B, K, L]
    marginal = torch.logsumexp(joint, dim=1)                   # [B, L]
    denom = _global_sum(loss_mask.sum(), dp)
    loss = -(marginal * loss_mask).sum() / denom
    utility = marginal - gold_log_probs[:, -1, :]
    util_mask = loss_mask * (labels < eos_id)
    utility = (utility * util_mask).sum() / torch.clamp(
        _global_sum(util_mask.sum(), dp), min=1.0)
    null_block = -(gold_log_probs[:, -1, :] * loss_mask).sum() / denom
    zero = torch.zeros((), device=loss.device)
    return EMDR2LossAux(zero, loss, utility, null_block)


def kl_div_retriever_loss(gold_log_probs: torch.Tensor,
                          topk_log_probs: torch.Tensor,
                          loss_mask: torch.Tensor,
                          dp: Optional[DataParallel] = None) -> torch.Tensor:
    """KL(teacher || retriever), batchmean over rows with supervision (of
    the global batch under ``dp``: this rank's share); the teacher's
    document distribution is the softmax over K of the length-normalized
    gold log-probs."""
    gold_log_probs = gold_log_probs.float()
    topk_log_probs = topk_log_probs.float()
    row_tokens = loss_mask.sum(dim=1)
    denom = torch.clamp(row_tokens, min=1.0)
    teacher_scores = ((gold_log_probs * loss_mask[:, None, :]).sum(dim=2)
                      / denom[:, None])
    teacher_probs = torch.softmax(teacher_scores, dim=1)
    teacher_log_probs = torch.log_softmax(teacher_scores, dim=1)
    kl = (teacher_probs * (teacher_log_probs - topk_log_probs)).sum(dim=1)
    kl = torch.where(row_tokens > 0, kl, torch.zeros_like(kl))
    return kl.sum() / torch.clamp(_global_sum((row_tokens > 0).sum(), dp),
                                  min=1)


def emdr2_total_loss(lm_logits, topk_log_probs, gold_log_probs, labels,
                     loss_mask, eos_id: int, update_retriever: bool = True,
                     use_kl_div: bool = False,
                     dp: Optional[DataParallel] = None,
                     tp: Optional[Group] = None):
    """-> (reader CE + retriever loss, ``EMDR2LossAux``), under ``dp`` this
    rank's shares of each; under ``tp`` lm_logits is this rank's part of
    the vocabulary. Masked labels are replaced with 0, as in the
    reference."""
    safe_labels = torch.where(loss_mask > 0, labels, torch.zeros_like(labels))
    lm_loss = reader_cross_entropy(lm_logits, safe_labels, loss_mask, dp,
                                   tp)
    zero = torch.zeros((), device=lm_loss.device)
    if not update_retriever:
        return lm_loss, EMDR2LossAux(lm_loss, zero, zero, zero)
    if use_kl_div:
        ret_loss = kl_div_retriever_loss(gold_log_probs, topk_log_probs,
                                         loss_mask, dp)
        aux = EMDR2LossAux(lm_loss, ret_loss, zero, zero)
    else:
        aux = emdr2_retriever_loss(gold_log_probs, topk_log_probs,
                                   safe_labels, loss_mask, eos_id, dp)
        aux = aux._replace(lm_loss=lm_loss)
        ret_loss = aux.retriever_loss
    return lm_loss + ret_loss, aux


class _GatherRows(torch.autograd.Function):
    """All-gather of every rank's rows [c, d] -> [W * c, d] whose backward
    sums the gathered rows' gradient over the ranks and keeps this rank's
    block: the gradient of the global loss, as ``jax.lax.all_gather``'s
    autodiff (a reduce-scatter) gives it, from an all-reduce and a slice."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        ctx.rows = x.shape[0]
        return dp.all_gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        dp = ctx.dp
        total = dp.all_reduce_sum_(grad.contiguous().clone())
        return total[dp.rank * ctx.rows:(dp.rank + 1) * ctx.rows], None


def dpr_in_batch_loss(query_embeds: torch.Tensor,
                      context_embeds: torch.Tensor, hidden_size: int,
                      score_scaling: bool = False,
                      labels: Optional[torch.Tensor] = None,
                      dp: Optional[DataParallel] = None):
    """DPR contrastive NLL with in-batch negatives.

    query_embeds [b, d]; context_embeds [c, d] with c >= b (positives first,
    then hard negatives). Scores are fp32 ``q . c``, divided by
    sqrt(hidden_size) under ``score_scaling``; the loss is the mean
    log-softmax NLL of ``labels`` (default ``arange(b)``). Returns (loss,
    correct), ``correct`` the count of rows whose argmax is the label, as
    a 0-d fp32 tensor.

    Under ``dp`` (the JAX ``axis_name`` form) the contexts of every rank
    are all-gathered into [W * c, d], so each query scores the global
    batch's contexts; ``labels`` (default ``arange(b)``) index this rank's
    block, rank r's column j being global column r * c + j. The loss
    returned is this rank's mean NLL, ``correct`` its count: the global
    loss is their mean over the ranks (equal b), and averaging the ranks'
    gradients gives its gradient, because the gather's backward sums each
    rank's context gradient over all ranks' queries. The step reduces
    both metrics over the group."""
    b = query_embeds.shape[0]
    c = context_embeds.shape[0]
    if labels is None:
        labels = torch.arange(b, device=query_embeds.device)
    labels = labels.to(query_embeds.device).long()
    contexts = context_embeds.float()
    if dp is not None and dp.distributed:
        contexts = _GatherRows.apply(contexts, dp)
        labels = labels + dp.rank * c
    scores = torch.matmul(query_embeds.float(), contexts.T)
    if score_scaling:
        scores = scores / math.sqrt(hidden_size)
    log_probs = torch.log_softmax(scores, dim=1)
    nll = -log_probs.gather(1, labels[:, None])[:, 0]
    correct = (log_probs.argmax(dim=1) == labels).sum().float()
    return nll.mean(), correct
