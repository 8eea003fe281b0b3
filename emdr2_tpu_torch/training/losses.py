"""Loss functions (port of ``emdr2_tpu/training/losses.py``): the reader
cross-entropy, the EMDR2 marginalized retriever loss, its KL-divergence
variant, their sum, and the DPR in-batch contrastive loss.

The vocab-parallel cross-entropy (tensor parallelism) and the all-gather
form of the DPR loss wait for multi-GPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class EMDR2LossAux(NamedTuple):
    lm_loss: torch.Tensor
    retriever_loss: torch.Tensor
    retriever_utility: torch.Tensor
    null_block_lm_loss: torch.Tensor


def reader_cross_entropy(lm_logits: torch.Tensor, labels: torch.Tensor,
                         loss_mask: torch.Tensor) -> torch.Tensor:
    """Token CE averaged over unmasked positions. lm_logits [B, L, V] fp32,
    labels [B, L], loss_mask [B, L] float."""
    log_probs = torch.log_softmax(lm_logits.float(), dim=-1)
    gold = log_probs.gather(-1, labels[..., None].long())[..., 0]
    return -(gold * loss_mask).sum() / loss_mask.sum()


def emdr2_retriever_loss(gold_log_probs: torch.Tensor,
                         topk_log_probs: torch.Tensor, labels: torch.Tensor,
                         loss_mask: torch.Tensor, eos_id: int) -> EMDR2LossAux:
    """The EMDR2 marginalized objective:
    ``-sum_t mask_t * logsumexp_k(topk_log_probs_k + gold_{k,t}) / sum mask``
    (gradient through ``topk_log_probs`` only), with the retriever utility
    (marginal minus the last document's log-prob over non-EOS, non-sentinel
    tokens) and the null-block LM loss."""
    gold_log_probs = gold_log_probs.float()
    topk_log_probs = topk_log_probs.float()
    joint = topk_log_probs[:, :, None] + gold_log_probs        # [B, K, L]
    marginal = torch.logsumexp(joint, dim=1)                   # [B, L]
    denom = loss_mask.sum()
    loss = -(marginal * loss_mask).sum() / denom
    utility = marginal - gold_log_probs[:, -1, :]
    util_mask = loss_mask * (labels < eos_id)
    utility = (utility * util_mask).sum() / torch.clamp(util_mask.sum(),
                                                        min=1.0)
    null_block = -(gold_log_probs[:, -1, :] * loss_mask).sum() / denom
    zero = torch.zeros((), device=loss.device)
    return EMDR2LossAux(zero, loss, utility, null_block)


def kl_div_retriever_loss(gold_log_probs: torch.Tensor,
                          topk_log_probs: torch.Tensor,
                          loss_mask: torch.Tensor) -> torch.Tensor:
    """KL(teacher || retriever), batchmean over rows with supervision; the
    teacher's document distribution is the softmax over K of the
    length-normalized gold log-probs."""
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
    return kl.sum() / torch.clamp((row_tokens > 0).sum(), min=1)


def emdr2_total_loss(lm_logits, topk_log_probs, gold_log_probs, labels,
                     loss_mask, eos_id: int, update_retriever: bool = True,
                     use_kl_div: bool = False):
    """-> (reader CE + retriever loss, ``EMDR2LossAux``). Masked labels are
    replaced with 0, as in the reference."""
    safe_labels = torch.where(loss_mask > 0, labels, torch.zeros_like(labels))
    lm_loss = reader_cross_entropy(lm_logits, safe_labels, loss_mask)
    zero = torch.zeros((), device=lm_loss.device)
    if not update_retriever:
        return lm_loss, EMDR2LossAux(lm_loss, zero, zero, zero)
    if use_kl_div:
        ret_loss = kl_div_retriever_loss(gold_log_probs, topk_log_probs,
                                         loss_mask)
        aux = EMDR2LossAux(lm_loss, ret_loss, zero, zero)
    else:
        aux = emdr2_retriever_loss(gold_log_probs, topk_log_probs,
                                   safe_labels, loss_mask, eos_id)
        aux = aux._replace(lm_loss=lm_loss)
        ret_loss = aux.retriever_loss
    return lm_loss + ret_loss, aux


def dpr_in_batch_loss(query_embeds: torch.Tensor,
                      context_embeds: torch.Tensor, hidden_size: int,
                      score_scaling: bool = False,
                      labels: Optional[torch.Tensor] = None,
                      axis_name: Optional[str] = None):
    """DPR contrastive NLL with in-batch negatives, in one process.

    query_embeds [b, d]; context_embeds [c, d] with c >= b (positives first,
    then hard negatives). Scores are fp32 ``q . c``, divided by
    sqrt(hidden_size) under ``score_scaling``; the loss is the mean
    log-softmax NLL of ``labels`` (default ``arange(b)``). Returns (loss,
    correct), ``correct`` the count of rows whose argmax is the label, as
    a 0-d fp32 tensor. ``axis_name`` (the JAX form that all-gathers the
    contexts over data-parallel shards) is not ported: multi-GPU comes
    later."""
    if axis_name is not None:
        raise NotImplementedError("the all-gather form of dpr_in_batch_loss "
                                  "waits for the multi-GPU port")
    b = query_embeds.shape[0]
    if labels is None:
        labels = torch.arange(b, device=query_embeds.device)
    labels = labels.to(query_embeds.device).long()
    scores = torch.matmul(query_embeds.float(), context_embeds.float().T)
    if score_scaling:
        scores = scores / math.sqrt(hidden_size)
    log_probs = torch.log_softmax(scores, dim=1)
    nll = -log_probs.gather(1, labels[:, None])[:, 0]
    correct = (log_probs.argmax(dim=1) == labels).sum().float()
    return nll.mean(), correct
