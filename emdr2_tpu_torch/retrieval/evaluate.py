"""Retrieval evaluator: recall@k of the dense retriever over the whole index
(port of ``emdr2_tpu/retrieval/evaluate.py``).

Questions are embedded by the query tower in static batches (the tail
padded), all of them are searched in one call of the index (one candidate
scan over the resident rows: the tensor-core kernel at large query
batches), and ``calculate_matches`` scores the retrieved passages'
texts against the answers.

The questions are cut in equal contiguous slices over the ranks of the
index's data-parallel group (``index.dp``; one slice on one rank), the
last padded with copies of the last question; each rank embeds and
searches its slice, the results are all-gathered, rank 0 does the host
matching and every rank gets its recall dict.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from emdr2_tpu_torch.data.qa_dataset import QAExample, encode_question
from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
from emdr2_tpu_torch.retrieval.qa_validation import calculate_matches


def embed_query(module: torch.nn.Module, ids: torch.Tensor) -> torch.Tensor:
    """The default ``embed_method``: the query tower's CLS state in fp32,
    for an ``EMDR2Model``, a ``DPRModel`` (both hold it under
    ``retriever``) or a ``DualEncoder``."""
    return getattr(module, "retriever", module).embed_query(ids)


class OpenRetrievalEvaluator:
    def __init__(self, model: torch.nn.Module, index: ShardedEvidenceIndex,
                 tokenizer, query_seq_len: int, batch_size: int = 64,
                 embed_method: Optional[Callable] = None):
        """``embed_method(model, ids) -> [n, d]`` maps query ids to
        embeddings (default :func:`embed_query`; ``DualEncoder.embed_query``
        with a ``DualEncoder``). The questions are embedded where the
        model's parameters are."""
        self.model = model
        self.embed_method = embed_method or embed_query
        self.index = index
        self.tok = tokenizer
        self.query_seq_len = query_seq_len
        self.batch_size = max(1, batch_size)
        self.device = next(model.parameters()).device

    @torch.inference_mode()
    def encode_queries(self, questions: Sequence[str]) -> torch.Tensor:
        """[n, d] fp32 query embeddings on the model's device, in batches of
        ``batch_size`` rows (the tail batch padded with id-0 rows)."""
        n = len(questions)
        rows = [encode_question(q, self.tok, self.query_seq_len)[0]
                for q in questions]
        ids = np.asarray(rows, np.int64)
        out = []
        bs = self.batch_size
        for s in range(0, n, bs):
            chunk = ids[s: s + bs]
            if len(chunk) < bs:
                chunk = np.pad(chunk, ((0, bs - len(chunk)), (0, 0)))
            out.append(self.embed_method(
                self.model, torch.as_tensor(chunk).to(self.device)).float())
        return torch.cat(out)[:n]

    @torch.inference_mode()
    def retrieve(self, questions: Sequence[str], k: int):
        """-> (passage_ids [n, k] numpy, scores [n, k] numpy): one search
        of the index over all n questions, each rank of ``index.dp``
        embedding and searching its slice (all of them on one rank; the tp
        ranks of a replica the same slice)."""
        dp = self.index.dp
        n = len(questions)
        per = -(-n // dp.world_size)
        padded = list(questions) + [questions[-1]] * (per * dp.world_size - n)
        q = self.encode_queries(padded[dp.rank * per:(dp.rank + 1) * per])
        scores, rows = self.index.search(q, k=k)
        rows = dp.all_gather_rows(rows)[:n]
        scores = dp.all_gather_rows(scores.float())[:n]
        return (self.index.lookup_passage_ids(rows.cpu().numpy()),
                scores.cpu().numpy())

    def evaluate_recall(self, examples: Sequence[QAExample], k: int,
                        doc_text_fn: Callable[[int], str],
                        match_type: str = "string",
                        report_at: Optional[Sequence[int]] = None,
                        dump_path: Optional[str] = None) -> dict:
        """recall@k over QA examples: {"recall@j": fraction} for each j of
        ``report_at`` (capped at k); with ``dump_path``, the per-question
        top-k passage ids and hits as JSON. Over a sharded index every
        rank calls it; world rank 0 matches and writes the dump."""
        questions = [e.question for e in examples]
        answers = [e.answers for e in examples]
        pids, scores = self.retrieve(questions, k)
        ranks = self.index.blocks
        result = (self._recall(questions, answers, pids, scores, k,
                               doc_text_fn, match_type, report_at, dump_path)
                  if ranks.rank == 0 else None)
        return ranks.broadcast_object(result)

    def _recall(self, questions, answers, pids, scores, k, doc_text_fn,
                match_type, report_at, dump_path) -> dict:
        closest = [(pids[i].tolist(), scores[i].tolist())
                   for i in range(len(questions))]
        stats = calculate_matches(doc_text_fn, answers, closest,
                                  match_type=match_type)
        n = len(questions)
        report_at = report_at or [1, 5, min(20, k), k]
        result = {f"recall@{j}": stats.top_k_hits[j - 1] / n
                  for j in sorted(set(min(j, k) for j in report_at))}
        if dump_path is not None:
            with open(dump_path, "w") as f:
                json.dump([
                    {"question": q, "answers": list(a),
                     "passages": p, "hits": h}
                    for q, a, (p, _), h in zip(questions, answers, closest,
                                               stats.questions_doc_hits)
                ], f)
        return result
