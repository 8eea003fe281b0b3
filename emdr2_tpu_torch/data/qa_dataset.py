"""QA datasets: e2e OpenQA train/eval CSVs and retrieval-eval CSVs.

Parity targets:
- ``OpenQADataset`` (``tasks/openqa/e2eqa/train_data_utils.py:
  105-173``): TSV rows ``question\\t"['ans1', ...]"``; uids negative so they
  never collide with (positive) evidence doc ids; a random answer is sampled
  per epoch; query BERT ids double as T5 query ids (shared wordpiece vocab).
- decoder layout (:60-81): dec_in = [BOS] answer..., dec_out = answer... [EOS],
  loss over real tokens only.
- ``QADataset`` (``tasks/openqa/dense_retriever/evaluation/data.py``):
  question + answers for recall eval.
"""

from __future__ import annotations

import ast
import csv
import sys
from typing import Dict, List, NamedTuple, Sequence

import numpy as np

from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer


class QAExample(NamedTuple):
    uid: int
    question: str
    answers: List[str]


def read_qa_csv(path: str) -> List[QAExample]:
    """question\\tanswers-as-python-list (train_data_utils.py:155-173).
    Uses ast.literal_eval instead of the reference's bare eval()."""
    csv.field_size_limit(sys.maxsize)
    out: List[QAExample] = []
    with open(path) as f:
        reader = csv.reader(f, delimiter="\t")
        for i, row in enumerate(reader):
            answers = ast.literal_eval(row[1])
            out.append(QAExample(uid=-(i + 1), question=row[0],
                                 answers=list(answers)))
    return out


def encode_question(question: str, tok: BertWordPieceTokenizer,
                    max_len: int) -> tuple:
    """[CLS] question(capped) [SEP] pad...; returns (ids, true_len)."""
    ids = [tok.cls_id] + tok.tokenize(question)
    if len(ids) > max_len - 1:
        ids = ids[: max_len - 1]
    ids.append(tok.sep_id)
    n = len(ids)
    ids = ids + [tok.pad_id] * (max_len - n)
    return ids, n


def encode_answer(answer: str, tok: BertWordPieceTokenizer,
                  dec_len: int) -> tuple:
    """(dec_in [BOS] ans..., dec_out ans... [EOS], loss_mask)
    (train_data_utils.py:60-81)."""
    ans = tok.tokenize(answer)
    dec_in = [tok.bos_id] + ans
    dec_out = list(ans)
    if len(dec_in) > dec_len:
        dec_in = dec_in[:dec_len]
        dec_out = dec_out[: dec_len - 1]
    dec_out.append(tok.eos_id)
    n = len(dec_in)
    pad = [tok.pad_id] * (dec_len - n)
    return dec_in + pad, dec_out + pad, [1.0] * n + [0.0] * (dec_len - n)


class QABatch(NamedTuple):
    query_uid: np.ndarray        # [B] int64 (negative)
    query_bert_ids: np.ndarray   # [B, Lq] int32
    query_t5_ids: np.ndarray     # [B, Lq] int32 (same ids; shared vocab)
    query_t5_len: np.ndarray     # [B] int32
    dec_ids: np.ndarray          # [B, Ld] int32
    labels: np.ndarray           # [B, Ld] int32
    loss_mask: np.ndarray        # [B, Ld] float32
    references: List[List[str]]  # ground-truth answer strings


class OpenQADataset:
    """e2e QA dataset with per-access random answer sampling."""

    def __init__(self, paths: Sequence[str], tokenizer: BertWordPieceTokenizer,
                 max_seq_length: int, decoder_seq_length: int,
                 seed: int = 1234):
        self.examples: List[QAExample] = []
        offset = 0
        for p in paths:
            for ex in read_qa_csv(p):
                self.examples.append(
                    QAExample(ex.uid - offset, ex.question, ex.answers))
            offset = len(self.examples)
        self.tok = tokenizer
        self.max_seq_length = max_seq_length
        self.decoder_seq_length = decoder_seq_length
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.examples)

    def sample(self, idx: int, sample_answer: bool = True) -> Dict:
        ex = self.examples[idx]
        answer = (ex.answers[self.rng.randint(len(ex.answers))]
                  if sample_answer and len(ex.answers) > 1 else ex.answers[0])
        q_ids, q_len = encode_question(ex.question, self.tok, self.max_seq_length)
        dec_in, dec_out, loss_mask = encode_answer(
            answer, self.tok, self.decoder_seq_length)
        return dict(uid=ex.uid, query_ids=q_ids, query_len=q_len,
                    dec_ids=dec_in, labels=dec_out, loss_mask=loss_mask,
                    references=ex.answers)

    def batch(self, indices: Sequence[int], sample_answer: bool = True
              ) -> QABatch:
        rows = [self.sample(i, sample_answer) for i in indices]
        return QABatch(
            query_uid=np.asarray([r["uid"] for r in rows], np.int64),
            query_bert_ids=np.asarray([r["query_ids"] for r in rows], np.int32),
            query_t5_ids=np.asarray([r["query_ids"] for r in rows], np.int32),
            query_t5_len=np.asarray([r["query_len"] for r in rows], np.int32),
            dec_ids=np.asarray([r["dec_ids"] for r in rows], np.int32),
            labels=np.asarray([r["labels"] for r in rows], np.int32),
            loss_mask=np.asarray([r["loss_mask"] for r in rows], np.float32),
            references=[r["references"] for r in rows],
        )

    def epoch_batches(self, batch_size: int, seed: int, drop_last: bool = True,
                      shuffle: bool = True, rank: int = 0,
                      world_size: int = 1):
        """Yield QABatches for one epoch (epoch-seeded shuffle — parity with
        samplers.py RandomSampler semantics).

        ``batch_size`` is the GLOBAL batch size; with ``world_size > 1`` each
        process yields only its contiguous slice of every global batch
        (``DistributedBatchSampler``, reference samplers.py:78-148) — the
        multi-host per-process data feed."""
        from emdr2_tpu_torch.data.samplers import (DistributedBatchSampler,
                                             RandomSampler)
        sampler = (RandomSampler(len(self), seed=seed) if shuffle
                   else range(len(self)))
        dbs = DistributedBatchSampler(sampler, batch_size,
                                      drop_last=drop_last, rank=rank,
                                      world_size=world_size)
        for indices in dbs:
            yield self.batch(indices)
