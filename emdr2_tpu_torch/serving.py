"""Serving: an end-to-end question-answering pipeline (port of
``emdr2_tpu/serving.py:QAPipeline``).

    pipeline = QAPipeline(cfg, model, tokenizer, corpus, index)
    answers = pipeline.ask(["who wrote hamlet?", ...])

Each batch: embed the questions with the BERT query tower, search the
resident index (the candidate-scan kernel), build the reader token layouts
on the host (C++), FiD-encode the retrieved passages (the flash
self-attention kernel), project the cross-attention K/V once, and decode
greedily over a KV cache. Loading a trained checkpoint (``QAPipeline.load``)
and beam search come in later work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from emdr2_tpu_torch.config import EMDR2Config
from emdr2_tpu_torch.data.evidence import EvidenceCorpus
from emdr2_tpu_torch.data.postprocess import postprocess_retrieved
from emdr2_tpu_torch.data.qa_dataset import encode_question
from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer
from emdr2_tpu_torch.models.decoding import (DecoderSession, bf16_eval_params,
                                             greedy_decode)
from emdr2_tpu_torch.models.emdr2 import EMDR2Batch, EMDR2Model
from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
from emdr2_tpu_torch.utils.timing import StageTimer, stage


class QAPipeline:
    """Batched open-domain QA: every call retrieves fresh top-K evidence and
    generates an answer with the reader. ``model`` runs where its
    parameters live; ``timer`` (optional) records ms per stage. No
    optimizer state when serving: the dense kernels move to bf16 storage
    (``bf16_eval_params``, unchanged outputs)."""

    def __init__(self, cfg: EMDR2Config, model: EMDR2Model,
                 tokenizer: BertWordPieceTokenizer,
                 corpus: EvidenceCorpus, index: ShardedEvidenceIndex,
                 batch_size: int = 8, timer: Optional[StageTimer] = None):
        self.cfg = cfg
        self.model = bf16_eval_params(model).eval()
        self.device = next(model.parameters()).device
        self.tok = tokenizer
        self.corpus = corpus
        self.index = index
        self.batch_size = batch_size
        self.timer = timer
        self.session = DecoderSession(self.model, cfg.reader.decoder_seq_len,
                                      timer=timer)

    def _ids(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long).to(self.device)

    @torch.inference_mode()
    def _build_batch(self, questions: Sequence[str]) -> EMDR2Batch:
        cfg = self.cfg
        B = len(questions)
        rows, lens = [], []
        for q in questions:
            ids, n = encode_question(q, self.tok, cfg.retriever.query_seq_len)
            rows.append(ids)
            lens.append(n)
        q_ids = np.asarray(rows, np.int32)

        k = cfg.index.topk + (0 if cfg.index.allow_trivial_doc else 1)
        with stage(self.timer, "embed"):
            q_emb = self.model.embed_query(self._ids(q_ids))
        with stage(self.timer, "search"):
            _, rows_dev = self.index.search(q_emb, k=k)
            pids = self.index.lookup_passage_ids(rows_dev.cpu().numpy())
        with stage(self.timer, "postprocess"):
            post = postprocess_retrieved(
                query_uids=[-(i + 1) for i in range(B)],
                query_t5_ids=q_ids, query_t5_lens=lens,
                topk_passage_ids=pids, corpus=self.corpus,
                topk=cfg.index.topk,
                retriever_seq_len=cfg.retriever.seq_len,
                reader_seq_len=cfg.reader.seq_len,
                cls_id=self.tok.cls_id, sep_id=self.tok.sep_id,
                pad_id=self.tok.pad_id)
            Ld = cfg.reader.decoder_seq_len
            zeros = np.zeros((B, Ld), np.int32)
            batch = EMDR2Batch(
                query_bert_ids=self._ids(q_ids),
                context_bert_ids=self._ids(post.context_bert_ids),
                context_bert_types=self._ids(post.context_bert_types),
                reader_ids=self._ids(post.reader_ids),
                reader_one_ctx_ids=self._ids(post.reader_one_ctx_ids),
                dec_ids=self._ids(zeros),
                labels=self._ids(zeros),
                loss_mask=torch.zeros((B, Ld), dtype=torch.float32,
                                      device=self.device))
        return batch

    def ask(self, questions: Sequence[str]) -> List[str]:
        """Answer questions; pads the tail batch so shapes stay fixed."""
        answers: List[str] = []
        B = self.batch_size
        for s in range(0, len(questions), B):
            chunk = list(questions[s: s + B])
            real = len(chunk)
            while len(chunk) < B:
                chunk.append(chunk[-1])
            batch = self._build_batch(chunk)
            hyps = greedy_decode(self.session, batch, self.tok.bos_id,
                                 self.tok.eos_id)
            for hyp in hyps[:real]:
                answers.append(self.tok.detokenize(hyp).strip())
        return answers

    @torch.inference_mode()
    def retrieve_passages(self, questions: Sequence[str], k: int = 5
                          ) -> List[List[Tuple[int, str]]]:
        """Top-k (passage_id, text) per question — retrieval-only serving."""
        rows = [encode_question(q, self.tok,
                                self.cfg.retriever.query_seq_len)[0]
                for q in questions]
        q_emb = self.model.embed_query(self._ids(np.asarray(rows, np.int32)))
        _, idx = self.index.search(q_emb, k=k)
        pids = self.index.lookup_passage_ids(idx.cpu().numpy())
        return [[(int(p),
                  self.tok.detokenize(self.corpus.doc_tokens(int(p))).strip())
                 for p in row] for row in pids]
