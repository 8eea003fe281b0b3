"""End-to-end OpenQA training task on one device (port of
``emdr2_tpu/tasks/e2eqa.py:E2EQATask``).

One training step is three stages:

  stage A  query embeddings (no dropout) -> MIPS top-k over the resident
           index (the candidate-scan kernel) -> passage ids on the host
  stage B  host postprocess (C++) into the three token layouts
  stage C  the differentiable step (training/step.py): fresh query and
           context embeddings -> topk_log_probs -> FiD reader -> teacher ->
           joint loss -> backward -> clip -> AdamW

Evaluation: ``validation_loss`` runs the same forward with no dropout and
no gradient over a dataset; ``evaluate_em`` generates an answer per example
(greedy, sampling or beam search over ``models/decoding.py``, optionally
with the int8 cross K/V) and scores exact match against the references.

Data parallelism (``dp``, a ``parallel.mesh.DataParallel``): each rank
holds its block of the index (``ShardedEvidenceIndex(..., dp=dp)``), and
``train_step`` takes this rank's slice of the global batch
(``cfg.train.batch_size`` questions, cut by ``DistributedBatchSampler``);
stage A searches the whole index for the slice's queries, the step
reduces over the ranks, and the metrics are the global batch's.
``validation_loss`` and ``evaluate_em`` walk the same global batches on
every rank, each feeding its contiguous slice (``_slice_qa_batch``), and
merge the results: the losses through their global normalizers, the
per-row scores through an all-gather and a per-uid dedupe.
``training/engine.py`` loops over ``train_step``. With its prefetcher in
one process a worker thread runs stages A and B of the next batches on a
stream of its own, and embeds the queries with a snapshot of the query
tower (``enable_prefetch_snapshots``), because the optimizer updates the
live tower in place. Under data parallelism the search's collectives
stay on the main thread: it queues stage A of a later batch
(``search_async``) right after a step, with the live tower in stream
order, and a worker waits for the result and runs stage B
(``build_device_batch(retrieved=...)``).

Tensor parallelism (``dp.tp``, the rank's tp group): the model splits over
it (``EMDR2Model(tp=...)``), the tp ranks of a replica feed the same slice
and search the index whose blocks lie on every rank (``dp.world``), and
evaluation decodes the same tokens on each of them (the step's logits are
gathered over tp).
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from emdr2_tpu_torch.config import EMDR2Config
from emdr2_tpu_torch.data.evidence import EvidenceCorpus
from emdr2_tpu_torch.data.postprocess import postprocess_retrieved
from emdr2_tpu_torch.data.qa_dataset import QABatch
from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer
from emdr2_tpu_torch.models.decoding import (DecoderSession,
                                             beam_search_decode,
                                             greedy_decode)
from emdr2_tpu_torch.models.emdr2 import EMDR2Batch, EMDR2Model
from emdr2_tpu_torch.parallel.mesh import DataParallel
from emdr2_tpu_torch.parallel.tensor import shard_for
from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
from emdr2_tpu_torch.training import step as step_lib
from emdr2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from emdr2_tpu_torch.utils.metrics import (exact_match_score,
                                           metric_max_over_ground_truths)
from emdr2_tpu_torch.utils.timing import StageTimer, stage


class PendingSearch:
    """A search queued by ``E2EQATask.search_async``: its row ids and
    scores on their way to the host, and the event after their copy."""

    def __init__(self, index, rows: torch.Tensor, scores: torch.Tensor,
                 done: Optional[torch.cuda.Event]):
        self.index, self.rows, self.scores, self.done = (index, rows, scores,
                                                         done)

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """(passage ids, scores) on the host, once the copy has landed."""
        if self.done is not None:
            self.done.synchronize()
        return (self.index.lookup_passage_ids(self.rows.numpy()),
                self.scores.numpy())


class E2EQATask:
    """Owns the model, the optimizer and the host glue of EMDR2 training.
    ``timer`` (optional, a ``utils.timing.StageTimer``) records a train
    step's stages, each on the card's events where the task runs on one
    and on the host clock elsewhere, stamped with the step they belong to:

      retrieve, postprocess           (``build_device_batch``)
      forward_backward                (``training/step.py``)
        retriever_forward, reader_forward, teacher_forward
                                      (``EMDR2Model.forward``)
        loss, backward
      optimizer

    and in evaluation ``eval_forward`` and the decoder session's
    ``encode``, ``cross_kv`` and ``decode``."""

    def __init__(self, cfg: EMDR2Config, t5_tokenizer: BertWordPieceTokenizer,
                 corpus: EvidenceCorpus, index: ShardedEvidenceIndex,
                 total_train_iters: int = 1000, device=DEFAULT_DEVICE,
                 timer: Optional[StageTimer] = None,
                 dp: Optional[DataParallel] = None):
        self.cfg = cfg
        self.tok = t5_tokenizer
        self.corpus = corpus
        self.index = index
        self.total_train_iters = total_train_iters
        self.device = resolve_device(device)
        self.timer = timer
        self.dp = dp
        if dp is not None and dp.world.world_size > 1:
            if getattr(index, "dp", None) is None:
                raise ValueError("under data parallelism the index must be "
                                 "sharded over the same group "
                                 "(ShardedEvidenceIndex(..., dp=dp))")
            if cfg.train.batch_size % dp.world_size:
                raise ValueError(f"global batch {cfg.train.batch_size} does "
                                 f"not divide over {dp.world_size} ranks")
        self.state: Optional[step_lib.TrainState] = None
        self._step_fn = step_lib.make_train_step(
            cfg, eos_id=t5_tokenizer.eos_id, timer=timer, dp=dp)
        self._eval_fn = step_lib.make_eval_forward(
            cfg, eos_id=t5_tokenizer.eos_id, dp=dp)
        # decoder sessions by (max_decode_len, kv_quant)
        self._sessions: Dict[Tuple[int, Optional[str]], DecoderSession] = {}
        # the prefetch worker's copy of the query tower, the lock that
        # orders its readers and its writer on the host, and the events
        # that order them on the device (CUDA only)
        self._retrieval_snapshot: Optional[torch.nn.Module] = None
        self._snapshot_lock = threading.Lock()
        self._snapshot_written: Optional[torch.cuda.Event] = None
        self._snapshot_reads: Dict[int, torch.cuda.Event] = {}  # by stream

    @property
    def global_batch_size(self) -> int:
        """Questions per train step over all ranks: the configured batch."""
        return self.cfg.train.batch_size

    @property
    def world_size(self) -> int:
        return self.dp.world_size if self.dp is not None else 1

    @property
    def rank(self) -> int:
        return self.dp.rank if self.dp is not None else 0

    def _rank_slice(self, batch: QABatch, batch_size: int) -> QABatch:
        """This rank's contiguous rows of a global batch of
        ``batch_size``."""
        if self.world_size == 1:
            return batch
        per = batch_size // self.world_size
        return _slice_qa_batch(batch, self.rank * per, (self.rank + 1) * per)

    def _check_divides(self, batch_size: int) -> None:
        if batch_size % self.world_size:
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over "
                f"{self.world_size} ranks: a truncated slice would drop the "
                f"remainder rows of every batch")

    # ------------------------------------------------------------------ setup

    def init_state(self, seed: int,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> step_lib.TrainState:
        """Parameters from ``seed`` (or ``state_dict``, e.g. converted JAX
        weights: the whole parameters, cut here for this tp rank), a fresh
        optimizer, step 0; dropout masks derive from ``seed`` and the
        step."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        tp = self.dp.tp if self.dp is not None else None
        model = EMDR2Model(self.cfg, device=self.device, generator=gen,
                           tp=tp)
        if state_dict is not None:
            model.load_state_dict(shard_for(state_dict, tp), strict=True)
        optimizer = step_lib.make_optimizer(model, self.cfg.train.optimizer,
                                            self.total_train_iters, self.dp,
                                            self.timer)
        self.state = step_lib.TrainState(step=0, seed=seed, model=model,
                                         optimizer=optimizer)
        self._retrieval_snapshot = None    # a copy of another model's tower
        return self.state

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long).to(
            self.device)

    # ---- the prefetch worker's query-tower snapshot -------------------------
    # The optimizer writes the parameters in place, so a worker thread that
    # embedded stage-A queries with the live tower could read half of one
    # step and half of the next. With snapshots on, ``retrieve`` embeds with
    # a copy of the query tower that ``train_step_prebuilt`` refreshes after
    # every update. On a CUDA device the copy runs on the training stream
    # after the optimizer; an event makes the next embed (on the worker's
    # stream) wait for it, and another makes the next copy wait for the
    # embeds already enqueued: no device-wide synchronize. Selection is as
    # stale as the prefetch depth (training/prefetch.py); the scores in the
    # step always come from the live parameters.

    def enable_prefetch_snapshots(self) -> None:
        if self.state is None:
            raise RuntimeError("init_state before enabling prefetch")
        if self._retrieval_snapshot is None:
            with torch.no_grad():
                snap = copy.deepcopy(self.state.model.retriever.query_model)
            self._retrieval_snapshot = snap.requires_grad_(False).eval()
        self.refresh_retrieval_snapshot()

    @torch.no_grad()
    def refresh_retrieval_snapshot(self) -> None:
        """Copy the live query tower into the snapshot (device to device)."""
        live = self.state.model.retriever.query_model
        with self._snapshot_lock:
            cuda = self.device.type == "cuda"
            if cuda:
                stream = torch.cuda.current_stream(self.device)
                for read in self._snapshot_reads.values():
                    stream.wait_event(read)
                self._snapshot_reads.clear()
            torch._foreach_copy_(list(self._retrieval_snapshot.parameters()),
                                 list(live.parameters()))
            if cuda:
                self._snapshot_written = torch.cuda.Event()
                self._snapshot_written.record(stream)

    def _embed_query(self, ids: torch.Tensor) -> torch.Tensor:
        if self._retrieval_snapshot is None:
            return self.state.model.embed_query(ids)
        with self._snapshot_lock:
            cuda = self.device.type == "cuda"
            if cuda:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(self._snapshot_written)
            q = self._retrieval_snapshot.embed(ids).float()
            if cuda:
                read = torch.cuda.Event()
                read.record(stream)
                self._snapshot_reads[stream.cuda_stream] = read
        return q

    # --------------------------------------------------------------- stage A

    @torch.no_grad()
    def search_async(self, query_bert_ids: np.ndarray) -> "PendingSearch":
        """The device part of stage A, queued on the calling thread's
        current stream: fresh query embeddings (from the snapshot when one
        is set) -> the MIPS top-k (under data parallelism
        ``sharded_mips_topk`` and its collectives) -> the rows and scores
        copied toward the host. ``PendingSearch.result()`` waits for them,
        and issues nothing on the device. Fetches K+1 when trivial docs
        must be dropped."""
        cfg = self.cfg
        k = cfg.index.topk + (0 if cfg.index.allow_trivial_doc else 1)
        q = self._embed_query(self._ids(query_bert_ids))
        scores, rows = self.index.search(q, k=k)
        done = None
        if rows.is_cuda:
            rows = rows.to("cpu", non_blocking=True)
            scores = scores.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return PendingSearch(self.index, rows, scores, done)

    def retrieve(self, query_bert_ids: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Stage A -> (passage ids, scores) on the host."""
        return self.search_async(query_bert_ids).result()

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

    def _mark_step(self) -> None:
        if self.timer is not None:
            self.timer.step = self.state.step

    def train_step(self, batch: QABatch) -> Dict[str, torch.Tensor]:
        self._mark_step()
        return self.train_step_prebuilt(self.build_device_batch(batch))

    def train_step_prebuilt(self, device_batch: EMDR2Batch
                            ) -> Dict[str, torch.Tensor]:
        """One differentiable step on an already-retrieved batch; metrics
        are 0-d tensors on the device."""
        self._mark_step()
        self.state, metrics = self._step_fn(self.state, device_batch)
        if self._retrieval_snapshot is not None:
            # hand the prefetch worker this step's weights
            self.refresh_retrieval_snapshot()
        return metrics

    # ------------------------------------------------------------ evaluation

    def validation_loss(self, dataset, batch_size: Optional[int] = None,
                        max_batches: Optional[int] = None) -> Dict[str, float]:
        """Deterministic forward losses over ``dataset`` in order: ``loss``,
        ``lm_loss`` and ``retriever_loss``, averaged over the examples.
        ``batch_size`` defaults to ``global_batch_size``.

        The tail batch is not dropped: it is padded to ``batch_size`` with
        copies of its last row whose ``loss_mask`` is zeroed, so the padded
        rows add no tokens to the token-normalized losses, and each batch's
        means weigh in by its count of real examples. Under data
        parallelism every rank walks the same global batches and feeds its
        slice; ``batch_size`` must divide over the ranks."""
        batch_size = batch_size or self.global_batch_size
        self._check_divides(batch_size)
        totals: Dict[str, float] = {}
        n = 0
        for bi, batch in enumerate(dataset.epoch_batches(
                batch_size, seed=0, shuffle=False, drop_last=False)):
            if max_batches is not None and bi >= max_batches:
                break
            real = len(batch.query_uid)
            if real < batch_size:
                batch = _pad_qa_batch(batch, batch_size, zero_loss_mask=True)
            device_batch = self.build_device_batch(
                self._rank_slice(batch, batch_size))
            with stage(self.timer, "eval_forward"):
                m = self._eval_fn(self.state, device_batch)
                for k, v in m.items():
                    totals[k] = totals.get(k, 0.0) + float(v) * real
            n += real
        return {k: v / max(n, 1) for k, v in totals.items()}

    def evaluate_em(self, dataset, batch_size: Optional[int] = None,
                    beam_size: int = 1,
                    max_decode_len: Optional[int] = None,
                    max_batches: Optional[int] = None, sample: bool = False,
                    sample_seed: int = 1234,
                    kv_quant: Optional[str] = None) -> Tuple[float, int]:
        """Generate an answer per example and score exact match against its
        references -> (EM percentage, number of examples).

        Greedy when ``beam_size == 1`` (with ``sample`` a draw from each
        step's categorical; each batch's generator is seeded from
        ``sample_seed`` and the batch index, so runs repeat), else
        length-normalized beam search. The tail batch is padded with copies
        of its last row; scores are kept per uid, so a padded copy counts
        once. ``kv_quant="int8"`` stores the decode cross K/V as int8.
        ``batch_size`` defaults to ``global_batch_size``.

        Under data parallelism every rank walks the same global batches,
        decodes its slice (``batch_size`` must divide over the ranks), and
        the per-row (uid, score) records of all ranks are all-gathered and
        deduped by uid; sampling takes rank 0's ``sample_seed`` and draws
        by global row. The tp ranks of a replica decode the same slice to
        the same tokens."""
        cfg = self.cfg
        batch_size = batch_size or self.global_batch_size
        self._check_divides(batch_size)
        if sample and self.dp is not None:
            sample_seed = self.dp.world.broadcast_object(sample_seed)
        per = batch_size // self.world_size
        max_decode_len = max_decode_len or cfg.reader.decoder_seq_len
        model = self.state.model
        key = (max_decode_len, kv_quant)
        if key not in self._sessions:
            self._sessions[key] = DecoderSession(
                model, max_decode_len, kv_quant=kv_quant, timer=self.timer)
        session = self._sessions[key]
        session.model = model              # the state's current weights
        row_uids: list = []
        row_scores: list = []
        for bi, batch in enumerate(dataset.epoch_batches(
                batch_size, seed=0, shuffle=False, drop_last=False)):
            if max_batches is not None and bi >= max_batches:
                break
            if len(batch.query_uid) < batch_size:
                batch = _pad_qa_batch(batch, batch_size)
            local = self._rank_slice(batch, batch_size)
            device_batch = self.build_device_batch(local)
            if beam_size == 1:
                rng = None
                if sample:
                    rng = torch.Generator(device=self.device)
                    rng.manual_seed(_fold_sample_seed(sample_seed, bi))
                hyps = greedy_decode(session, device_batch, self.tok.bos_id,
                                     self.tok.eos_id, rng=rng, sample=sample,
                                     rows=(self.rank * per, batch_size))
            else:
                hyps = beam_search_decode(session, device_batch,
                                          self.tok.bos_id, self.tok.eos_id,
                                          beam_size=beam_size)
            for uid, refs, hyp in zip(local.query_uid.tolist(),
                                      local.references, hyps):
                text = self.tok.detokenize(hyp).strip()
                row_uids.append(uid)
                row_scores.append(metric_max_over_ground_truths(
                    exact_match_score, text, refs))
        if self.world_size > 1:
            # equal counts on every rank: the same batches, ``per`` rows
            # each; padded copies land on any rank, so dedupe after
            row_uids = self.dp.all_gather(torch.tensor(
                row_uids, dtype=torch.int64)).reshape(-1).tolist()
            row_scores = self.dp.all_gather(torch.tensor(
                row_scores, dtype=torch.float32)).reshape(-1).tolist()
        scores: Dict[int, float] = dict(zip(row_uids, row_scores))
        n = len(scores)
        return (100.0 * sum(scores.values()) / max(n, 1)), n


def _fold_sample_seed(sample_seed: int, batch_index: int) -> int:
    """One generator seed per (``sample_seed``, batch): distinct batches draw
    from distinct streams, and a run repeats."""
    return (sample_seed * 1_000_003 + batch_index) % (2 ** 63)


def _slice_qa_batch(batch: QABatch, start: int, stop: int) -> QABatch:
    """Rows [start, stop) of a global batch: a rank's contiguous slice, as
    ``DistributedBatchSampler`` cuts it."""
    return QABatch(*[
        f[start:stop] if isinstance(f, np.ndarray) else list(f)[start:stop]
        for f in batch])


def _pad_qa_batch(batch: QABatch, batch_size: int,
                  zero_loss_mask: bool = False) -> QABatch:
    """Repeat the last row until the batch has ``batch_size`` rows.

    Padded rows carry real uids, so per-uid bookkeeping scores every
    example once (a copy overwrites with the same value). With
    ``zero_loss_mask`` the padded rows' loss_mask is zeroed, so they add no
    tokens to the token-normalized losses."""
    real = len(batch.query_uid)
    pad = batch_size - real
    if pad <= 0:
        raise ValueError(f"batch of {real} rows cannot be padded to "
                         f"{batch_size}")

    def rep(x):
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        return list(x) + [x[-1]] * pad      # the references lists

    out = QABatch(*[rep(f) for f in batch])
    if zero_loss_mask:
        lm = out.loss_mask.copy()
        lm[real:] = 0.0
        out = out._replace(loss_mask=lm)
    return out
