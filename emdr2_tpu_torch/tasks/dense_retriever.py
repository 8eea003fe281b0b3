"""DPR-style dense retriever training, ``--task RETRIEVER`` (port of
``emdr2_tpu/tasks/dense_retriever.py``), on one device or over a
data-parallel group.

Supervised contrastive training of the dual encoder with in-batch negatives
plus hard negatives, and the 30+30-negative average-rank / top-k
validation. The dataset part (``read_dpr_json``, ``DPRExample``,
``DPRBatch``, ``DPRDataset``) is numpy only, a copy of the JAX module's, so
the same seed gives the same batches.

Checkpoints: the task's model is a ``DPRModel`` that holds the dual encoder
as ``retriever``, so every parameter key starts with ``retriever.``, and
``training.checkpointing.load_retriever_params`` reads a DPR checkpoint
exactly as it reads an EMDR2 one (the JAX ``DPRState`` nests the params
under ``retriever`` for the same reason): a DPR run hands its retriever to
OPENQA with ``--pretrained-dpr-load``.
"""

from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from emdr2_tpu_torch.config import OptimizerConfig, RetrieverConfig
from emdr2_tpu_torch.data.postprocess import context_bert_format
from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer
from emdr2_tpu_torch.models.bert import DualEncoder
from emdr2_tpu_torch.models.layers import init_weights
from emdr2_tpu_torch.training import step as step_lib
from emdr2_tpu_torch.parallel.mesh import (DataParallel, Group,
                                           check_tp_divides)
from emdr2_tpu_torch.parallel.tensor import shard_for
from emdr2_tpu_torch.training.losses import dpr_in_batch_loss
from emdr2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from emdr2_tpu_torch.utils.timing import StageTimer, stage


# ---------------------------------------------------------------------------
# dataset (a copy of the JAX module's)
# ---------------------------------------------------------------------------

class DPRExample(NamedTuple):
    question: str
    answers: List[str]
    positives: List[dict]       # [{"text":..., "title":...}, ...]
    hard_negatives: List[dict]
    negatives: List[dict]


def read_dpr_json(path: str) -> List[DPRExample]:
    """DPR-format JSON: question / answers / positive_ctxs /
    hard_negative_ctxs / negative_ctxs. Entries without positives are
    dropped."""
    with open(path) as f:
        data = json.load(f)
    out = []
    for row in data:
        if not row.get("positive_ctxs"):
            continue
        out.append(DPRExample(
            question=row["question"],
            answers=list(row.get("answers", [])),
            positives=row["positive_ctxs"],
            hard_negatives=row.get("hard_negative_ctxs", []),
            negatives=row.get("negative_ctxs", []),
        ))
    return out


class DPRBatch(NamedTuple):
    query_ids: np.ndarray    # [B, Lq]
    query_types: np.ndarray
    ctx_ids: np.ndarray      # [B*(1+H), Lc]  positives first, then hard negs
    ctx_types: np.ndarray
    labels: np.ndarray       # [B] positive index per query


class DPRDataset:
    """Train sample = 1 positive + ``hard_negs`` hard negatives (padded with
    easy negatives when short).

    With ``evaluate=True``, each sample instead carries the av-rank
    validation layout: ``val_av_rank_other_neg`` easy + ``val_av_rank_hard_neg``
    hard negatives, deterministically the first of each list. Short lists
    are padded by repeating the last available negative."""

    def __init__(self, path: str, tokenizer: BertWordPieceTokenizer,
                 query_seq_len: int, ctx_seq_len: int, hard_negs: int = 1,
                 seed: int = 1234, evaluate: bool = False,
                 val_av_rank_other_neg: int = 30,
                 val_av_rank_hard_neg: int = 30):
        self.examples = read_dpr_json(path)
        self.tok = tokenizer
        self.query_seq_len = query_seq_len
        self.ctx_seq_len = ctx_seq_len
        self.hard_negs = hard_negs
        self.evaluate = evaluate
        self.val_other_neg = val_av_rank_other_neg
        self.val_hard_neg = val_av_rank_hard_neg
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.examples)

    def _encode_query(self, question: str):
        ids = [self.tok.cls_id] + self.tok.tokenize(question)
        ids = ids[: self.query_seq_len - 1] + [self.tok.sep_id]
        ids += [self.tok.pad_id] * (self.query_seq_len - len(ids))
        return ids

    def _encode_ctx(self, ctx: dict):
        tokens = (self.tok.tokenize(ctx.get("title", ""))
                  + [self.tok.sep_id] + self.tok.tokenize(ctx["text"]))
        ids, types = context_bert_format(
            tokens, self.ctx_seq_len, self.tok.cls_id, self.tok.sep_id,
            self.tok.pad_id)
        return ids, types

    def _pick_negatives(self, ex: DPRExample) -> List[dict]:
        negs = list(ex.hard_negatives)
        self.rng.shuffle(negs)
        negs = negs[: self.hard_negs]
        easy = list(ex.negatives)
        while len(negs) < self.hard_negs and easy:
            negs.append(easy.pop(self.rng.randint(len(easy))))
        while len(negs) < self.hard_negs:  # degenerate: repeat the positive
            negs.append(ex.positives[0])
        return negs

    def _pick_eval_negatives(self, ex: DPRExample) -> List[dict]:
        """First ``val_other_neg`` easy + ``val_hard_neg`` hard negatives,
        repeat-padded to a fixed count."""
        negs = (list(ex.negatives[: self.val_other_neg])
                + list(ex.hard_negatives[: self.val_hard_neg]))
        want = self.val_other_neg + self.val_hard_neg
        if not negs:
            negs = [ex.positives[0]]  # degenerate row; rank still well-defined
        while len(negs) < want:
            negs.append(negs[-1])
        return negs

    def batch(self, indices: Sequence[int]) -> DPRBatch:
        B = len(indices)
        H = (self.val_other_neg + self.val_hard_neg if self.evaluate
             else self.hard_negs)
        q_ids = np.zeros((B, self.query_seq_len), np.int32)
        ctx_ids = np.zeros((B * (1 + H), self.ctx_seq_len), np.int32)
        ctx_types = np.zeros_like(ctx_ids)
        # rows [0, B) = positives, rows [B, B*(1+H)) = negatives
        for r, i in enumerate(indices):
            ex = self.examples[i]
            q_ids[r] = self._encode_query(ex.question)
            pos = ex.positives[0]
            ctx_ids[r], ctx_types[r] = self._encode_ctx(pos)
            negs = (self._pick_eval_negatives(ex) if self.evaluate
                    else self._pick_negatives(ex))
            for h, neg in enumerate(negs):
                row = B + r * H + h
                ctx_ids[row], ctx_types[row] = self._encode_ctx(neg)
        return DPRBatch(q_ids, np.zeros_like(q_ids), ctx_ids, ctx_types,
                        labels=np.arange(B, dtype=np.int32))

    def epoch_batches(self, batch_size: int, seed: int, shuffle: bool = True,
                      drop_last: bool = True, rank: int = 0,
                      world_size: int = 1):
        """``drop_last=False`` yields the ragged tail batch too (validation
        scores every example); training drops it. ``batch_size`` is the
        global batch; with ``world_size > 1`` each rank gets the batch of
        its contiguous slice of every global batch (its own positives
        first, then its hard negatives), ``ceil(len / world_size)`` rows.
        A ragged tail that does not divide over the ranks is padded with
        copies of its last row, labelled -1 (``validate`` drops them); a
        training batch that does not divide is refused."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        end = (len(order) - len(order) % batch_size if drop_last
               else len(order))
        for s in range(0, end, batch_size):
            rows = order[s: s + batch_size]
            per = -(-len(rows) // world_size)
            if drop_last and per * world_size != len(rows):
                raise ValueError(f"a batch of {len(rows)} does not divide "
                                 f"over {world_size} ranks")
            mine = rows[rank * per:(rank + 1) * per]
            n_real = len(mine)
            batch = self.batch(np.concatenate(
                [mine, np.full(per - n_real, rows[-1])]))
            if n_real < per:
                batch = batch._replace(labels=np.where(
                    np.arange(per) < n_real, batch.labels, -1))
            yield batch


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

class DPRModel(nn.Module):
    """The dual encoder under the name ``retriever`` (the checkpoint key
    prefix an EMDR2 model gives it too), split over ``tp``."""

    def __init__(self, cfg: RetrieverConfig, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 tp: Optional[Group] = None):
        super().__init__()
        if tp is not None:
            check_tp_divides(tp.world_size, cfg)
        self.config = cfg
        self.retriever = DualEncoder(cfg, resolve_device(device), tp)
        init_weights(self, generator)

    def forward(self, *args, **kwargs):
        return self.retriever(*args, **kwargs)


class DPRTask:
    """Contrastive training of the dual encoder on one device (the card
    unless ``device`` says otherwise).

    ``init_state(seed, state_dict=None)`` makes the ``TrainState``;
    ``train_step(batch)`` runs one step with dropout and returns 0-d tensors
    ``loss``, ``correct_prediction_count`` and ``grad_norm``;
    ``validate(batches)`` the average rank and top-k accuracies;
    ``get_state`` / ``set_state`` hand the state to the checkpointer."""

    def __init__(self, cfg: RetrieverConfig, opt_cfg: OptimizerConfig,
                 total_train_iters: int, score_scaling: bool = True,
                 device=DEFAULT_DEVICE, timer: Optional[StageTimer] = None,
                 dp: Optional[DataParallel] = None):
        self.cfg = cfg
        self.dp = dp
        self.opt_cfg = opt_cfg
        self.total_train_iters = total_train_iters
        self.score_scaling = score_scaling
        self.device = resolve_device(device)
        self.timer = timer
        self.state: Optional[step_lib.TrainState] = None

    @property
    def model(self) -> DPRModel:
        return self.state.model

    def init_state(self, seed: int,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> step_lib.TrainState:
        """Parameters from ``seed`` (or ``state_dict``: the whole
        parameters, keys ``retriever.*``, cut here for this tp rank), a
        fresh optimizer, step 0; dropout masks derive from ``seed`` and the
        step."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        tp = self.dp.tp if self.dp is not None else None
        model = DPRModel(self.cfg, self.device, gen, tp)
        if state_dict is not None:
            model.load_state_dict(shard_for(state_dict, tp), strict=True)
        optimizer = step_lib.make_optimizer(model, self.opt_cfg,
                                            self.total_train_iters, self.dp)
        self.state = step_lib.TrainState(step=0, seed=seed, model=model,
                                         optimizer=optimizer)
        return self.state

    def get_state(self) -> step_lib.TrainState:
        return self.state

    def set_state(self, state: step_lib.TrainState) -> None:
        self.state = state

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long).to(
            self.device)

    def train_step(self, batch: DPRBatch) -> Dict[str, torch.Tensor]:
        """Forward of both towers with dropout -> ``dpr_in_batch_loss`` ->
        backward -> (mean over ``dp``) -> clip -> AdamW, in place. Metrics
        are 0-d tensors on the device (no host sync), those of the global
        batch under ``dp``: the mean loss and the count of correct rows.
        ``batch`` is this rank's (``DPRDataset.epoch_batches(rank=,
        world_size=)``)."""
        state = self.state
        dp = self.dp
        if self.timer is not None:
            self.timer.step = state.step
        with stage(self.timer, "forward_backward"):
            state.optimizer.zero_grad()
            q, c = state.model(self._ids(batch.query_ids),
                               self._ids(batch.ctx_ids),
                               context_types=self._ids(batch.ctx_types),
                               drop=state.dropout_seeds(
                                   dp.rank if dp is not None else 0,
                                   dp.tp.rank if dp is not None else 0))
            loss, correct = dpr_in_batch_loss(
                q, c, hidden_size=self.cfg.encoder.hidden_size,
                score_scaling=self.score_scaling,
                labels=self._ids(batch.labels), dp=dp)
            loss.backward()
        with stage(self.timer, "optimizer"):
            grad_norm = state.optimizer.step()
        state.step += 1
        loss, correct = loss.detach(), correct.detach()
        if dp is not None and dp.distributed:
            both = dp.all_reduce_sum_(torch.stack([loss, correct]))
            loss, correct = both[0] / dp.world_size, both[1]
        return {"loss": loss, "correct_prediction_count": correct,
                "grad_norm": grad_norm}

    @torch.no_grad()
    def validate(self, batches,
                 report_topk: Sequence[int] = (1, 5, 20, 100)
                 ) -> Dict[str, float]:
        """Scores each query against all context rows of its batch (B
        positives + B * 60 negatives in the 30+30 layout); returns the
        average rank of the positive and the top-k accuracies. Under
        ``dp`` each rank passes its batches, scores its queries against
        the contexts of every rank (all-gathered into the global batch's
        layout, without the padding rows of a ragged tail: label -1) and
        the counts are summed over the ranks."""
        dp = self.dp
        distributed = dp is not None and dp.distributed
        total = 0
        rank_sum = 0.0
        topk_hits = {k: 0 for k in report_topk}
        for batch in batches:
            q, c = self.state.model(
                self._ids(batch.query_ids), self._ids(batch.ctx_ids),
                context_types=self._ids(batch.ctx_types))
            labels = np.asarray(batch.labels)
            n = int((labels >= 0).sum())
            if distributed:
                # the global batch's layout: every rank's positives, then
                # every rank's negatives (ties rank as in one process)
                b = len(labels)
                counts = dp.all_gather(torch.tensor([n])).flatten()
                g = dp.all_gather(c)                    # [W, c_local, d]
                keep = (torch.arange(b)[None] < counts[:, None]).to(
                    g.device)                           # [W, b]
                d = g.shape[-1]
                c = torch.cat([
                    g[:, :b][keep],
                    g[:, b:].reshape(g.shape[0], b, -1, d)[keep]
                    .reshape(-1, d)])
                labels = int(counts[:dp.rank].sum()) + np.arange(n)
            scores = torch.matmul(q[:n], c.T).cpu().numpy()
            if self.score_scaling:
                scores = scores / np.sqrt(self.cfg.encoder.hidden_size)
            order = np.argsort(-scores, axis=1)
            ranks = np.argmax(order == labels[:n, None], axis=1)
            rank_sum += ranks.sum()
            for k in report_topk:
                topk_hits[k] += int((ranks < k).sum())
            total += n
        if distributed:
            counts = dp.all_reduce_sum_(torch.tensor(
                [float(total), float(rank_sum)]
                + [float(topk_hits[k]) for k in report_topk],
                dtype=torch.float64))
            total, rank_sum = int(counts[0]), float(counts[1])
            topk_hits = {k: int(counts[2 + i])
                         for i, k in enumerate(report_topk)}
        out = {"average_rank": rank_sum / max(total, 1),
               "top1_accuracy": topk_hits.get(1, 0) / max(total, 1)}
        for k in report_topk:
            out[f"top{k}_acc"] = topk_hits[k] / max(total, 1)
        return out
