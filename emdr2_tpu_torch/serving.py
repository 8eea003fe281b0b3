"""Serving: an end-to-end question-answering pipeline (port of
``emdr2_tpu/serving.py:QAPipeline``).

    pipeline = QAPipeline.load(checkpoint_dir, vocab_file, evidence_prefix,
                               embedding_path)   # or QAPipeline(cfg, model,
                                                 # tokenizer, corpus, index)
    answers = pipeline.ask(["who wrote hamlet?", ...])

Each batch: embed the questions with the BERT query tower, search the
resident index (the candidate-scan kernel), build the reader token layouts
on the host (C++), FiD-encode the retrieved passages (the flash
self-attention kernel), project the cross-attention K/V once, and decode
over a KV cache: greedily, or with ``beam_size > 1`` by length-normalized
beam search; ``kv_quant="int8"`` stores the cross K/V as int8 rows read by
the decode-attention kernel. ``QAPipeline.load`` builds the whole pipeline
from the files a training run and the index tools write.
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
from emdr2_tpu_torch.models.decoding import (DecoderSession,
                                             beam_search_decode,
                                             bf16_eval_params, greedy_decode)
from emdr2_tpu_torch.models.emdr2 import EMDR2Batch, EMDR2Model
from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
from emdr2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from emdr2_tpu_torch.utils.timing import StageTimer, stage


class QAPipeline:
    """Batched open-domain QA: every call retrieves fresh top-K evidence and
    generates an answer with the reader. ``model`` runs where its
    parameters live; ``timer`` (optional) records ms per stage. Serving
    holds no optimizer state, so with ``bf16_params`` the dense kernels move
    to bf16 storage in place (``bf16_eval_params``, unchanged outputs)."""

    def __init__(self, cfg: EMDR2Config, model: EMDR2Model,
                 tokenizer: BertWordPieceTokenizer,
                 corpus: EvidenceCorpus, index: ShardedEvidenceIndex,
                 batch_size: int = 8, beam_size: int = 1,
                 max_decode_len: Optional[int] = None,
                 kv_quant: Optional[str] = None, bf16_params: bool = True,
                 timer: Optional[StageTimer] = None):
        self.cfg = cfg
        self.model = (bf16_eval_params(model) if bf16_params
                      else model).eval()
        self.device = next(model.parameters()).device
        self.tok = tokenizer
        self.corpus = corpus
        self.index = index
        self.batch_size = batch_size
        self.beam_size = beam_size
        self.max_decode_len = max_decode_len or cfg.reader.decoder_seq_len
        self.timer = timer
        self.session = DecoderSession(self.model, self.max_decode_len,
                                      kv_quant=kv_quant, timer=timer)

    # ---------------------------------------------------------------- loading

    @classmethod
    def load(cls, checkpoint_dir: str, vocab_file: str,
             evidence_prefix: str, embedding_path: str,
             cfg: Optional[EMDR2Config] = None, device=DEFAULT_DEVICE,
             **kw) -> "QAPipeline":
        """The tokenizers of ``vocab_file`` (model vocabs padded to them),
        the corpus at ``evidence_prefix``, the index of the
        ``EmbeddingStore`` (or reference ``.pkl``) at ``embedding_path``,
        and the parameters of the latest checkpoint of a training run in
        ``checkpoint_dir``, on ``device`` (the card unless the caller names
        another). ``cfg`` defaults to ``EMDR2Config()``; ``kw`` go to the
        constructor."""
        from emdr2_tpu_torch.data.tokenizer import build_tokenizers
        from emdr2_tpu_torch.tasks.openqa_main import (load_store,
                                                       padded_vocab_cfg)
        from emdr2_tpu_torch.training import checkpointing as ck

        device = resolve_device(device)
        bert_tok, t5_tok = build_tokenizers(vocab_file)
        cfg = padded_vocab_cfg(cfg or EMDR2Config(), bert_tok, t5_tok)
        corpus = EvidenceCorpus.load(evidence_prefix + "_text",
                                     evidence_prefix + "_title")
        store = load_store(embedding_path)
        index = ShardedEvidenceIndex(cfg.index,
                                     np.asarray(store.embeddings, np.float32),
                                     passage_ids=np.asarray(store.ids),
                                     device=device)
        model = EMDR2Model(cfg, device=device)
        ck.load_model_params(checkpoint_dir, model)
        return cls(cfg, model, t5_tok, corpus, index, **kw)

    def _ids(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long).to(self.device)

    def _build_batch(self, questions: Sequence[str]) -> EMDR2Batch:
        return self._build(questions)[0]

    @torch.inference_mode()
    def _build(self, questions: Sequence[str]
               ) -> Tuple[EMDR2Batch, np.ndarray]:
        """(the device batch, the retrieved passage ids [B, k])."""
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
        return batch, pids

    def ask(self, questions: Sequence[str],
            return_passages: bool = False) -> List:
        """Answer questions; pads the tail batch so shapes stay fixed. With
        ``return_passages`` each answer comes as ``(answer, passage ids)``,
        the ids the search returned for its question (the JAX method takes
        the flag and ignores it)."""
        answers: List = []
        B = self.batch_size
        for s in range(0, len(questions), B):
            chunk = list(questions[s: s + B])
            real = len(chunk)
            while len(chunk) < B:
                chunk.append(chunk[-1])
            batch, pids = self._build(chunk)
            if self.beam_size == 1:
                hyps = greedy_decode(self.session, batch, self.tok.bos_id,
                                     self.tok.eos_id)
            else:
                hyps = beam_search_decode(self.session, batch,
                                          self.tok.bos_id, self.tok.eos_id,
                                          beam_size=self.beam_size)
            for hyp, row in zip(hyps[:real], pids[:real]):
                text = self.tok.detokenize(hyp).strip()
                answers.append((text, row.tolist()) if return_passages
                               else text)
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
