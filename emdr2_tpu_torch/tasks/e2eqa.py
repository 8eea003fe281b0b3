"""End-to-end OpenQA training task on one device (port of
``emdr2_tpu/tasks/e2eqa.py:E2EQATask``).

One training step is three stages:

  stage A  query embeddings (no dropout) -> MIPS top-k over the resident
           index (the candidate-scan kernel) -> passage ids on the host
  stage B  host postprocess (C++) into the three token layouts
  stage C  the differentiable step (training/step.py): fresh query and
           context embeddings -> topk_log_probs -> FiD reader -> teacher ->
           joint loss -> backward -> clip -> AdamW

There is no mesh: the port runs on one device. Evaluation (``evaluate_em``,
``validation_loss``), prefetching and checkpoints come in later work.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from emdr2_tpu_torch.config import EMDR2Config
from emdr2_tpu_torch.data.evidence import EvidenceCorpus
from emdr2_tpu_torch.data.postprocess import postprocess_retrieved
from emdr2_tpu_torch.data.qa_dataset import QABatch
from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer
from emdr2_tpu_torch.models.emdr2 import EMDR2Batch, EMDR2Model
from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
from emdr2_tpu_torch.training import step as step_lib
from emdr2_tpu_torch.utils.timing import StageTimer, stage


class E2EQATask:
    """Owns the model, the optimizer and the host glue of EMDR2 training.
    ``timer`` (optional) records ms per stage: ``retrieve``,
    ``postprocess``, ``forward_backward``, ``optimizer``."""

    def __init__(self, cfg: EMDR2Config, t5_tokenizer: BertWordPieceTokenizer,
                 corpus: EvidenceCorpus, index: ShardedEvidenceIndex,
                 total_train_iters: int = 1000, device="cpu",
                 timer: Optional[StageTimer] = None):
        self.cfg = cfg
        self.tok = t5_tokenizer
        self.corpus = corpus
        self.index = index
        self.total_train_iters = total_train_iters
        self.device = torch.device(device)
        self.timer = timer
        self.state: Optional[step_lib.TrainState] = None
        self._step_fn = step_lib.make_train_step(
            cfg, eos_id=t5_tokenizer.eos_id, timer=timer)

    # ------------------------------------------------------------------ setup

    def init_state(self, seed: int,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> step_lib.TrainState:
        """Parameters from ``seed`` (or ``state_dict``, e.g. converted JAX
        weights), a fresh optimizer, step 0; dropout masks derive from
        ``seed`` and the step."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        model = EMDR2Model(self.cfg, device=self.device, generator=gen)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        optimizer = step_lib.make_optimizer(model, self.cfg.train.optimizer,
                                            self.total_train_iters)
        self.state = step_lib.TrainState(step=0, seed=seed, model=model,
                                         optimizer=optimizer)
        return self.state

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long).to(
            self.device)

    # --------------------------------------------------------------- stage A

    @torch.no_grad()
    def retrieve(self, query_bert_ids: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Fresh query embeddings -> MIPS top-k -> (passage ids, scores) on
        the host. Fetches K+1 when trivial docs must be dropped."""
        cfg = self.cfg
        k = cfg.index.topk + (0 if cfg.index.allow_trivial_doc else 1)
        q = self.state.model.embed_query(self._ids(query_bert_ids))
        scores, rows = self.index.search(q, k=k)
        return (self.index.lookup_passage_ids(rows.cpu().numpy()),
                scores.cpu().numpy())

    # --------------------------------------------------------------- stage B

    def build_device_batch(self, batch: QABatch,
                           retrieved: Optional[Tuple] = None) -> EMDR2Batch:
        """Retrieve (unless ``retrieved`` passage ids and scores are given),
        postprocess on the host, and move the batch to the device."""
        cfg = self.cfg
        with stage(self.timer, "retrieve"):
            passage_ids, _ = (retrieved if retrieved is not None
                              else self.retrieve(batch.query_bert_ids))
        with stage(self.timer, "postprocess"):
            post = postprocess_retrieved(
                query_uids=batch.query_uid,
                query_t5_ids=batch.query_t5_ids,
                query_t5_lens=batch.query_t5_len,
                topk_passage_ids=passage_ids,
                corpus=self.corpus,
                topk=cfg.index.topk,
                retriever_seq_len=cfg.retriever.seq_len,
                reader_seq_len=cfg.reader.seq_len,
                cls_id=self.tok.cls_id, sep_id=self.tok.sep_id,
                pad_id=self.tok.pad_id)
            return EMDR2Batch(
                query_bert_ids=self._ids(batch.query_bert_ids),
                context_bert_ids=self._ids(post.context_bert_ids),
                context_bert_types=self._ids(post.context_bert_types),
                reader_ids=self._ids(post.reader_ids),
                reader_one_ctx_ids=self._ids(post.reader_one_ctx_ids),
                dec_ids=self._ids(batch.dec_ids),
                labels=self._ids(batch.labels),
                loss_mask=torch.as_tensor(batch.loss_mask,
                                          dtype=torch.float32).to(
                                              self.device))

    # --------------------------------------------------------------- stage C

    def train_step(self, batch: QABatch) -> Dict[str, torch.Tensor]:
        return self.train_step_prebuilt(self.build_device_batch(batch))

    def train_step_prebuilt(self, device_batch: EMDR2Batch
                            ) -> Dict[str, torch.Tensor]:
        """One differentiable step on an already-retrieved batch; metrics
        are 0-d tensors on the device."""
        self.state, metrics = self._step_fn(self.state, device_batch)
        return metrics
