#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --dp-cards N       (N cards: the ranks phase alone,
                                             and with 4 the embedder group,
                                             two hosts and tp)

1. Builds the hand-written CUDA kernels from ``emdr2_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel) and runs every case of
   ``kernel_checks.CHECKS``: each kernel's wrapper against its plain
   version at the main path's shapes, by the functions and at the limits
   the ``gpu`` tests (``tests/test_torch_gpu.py``) run one case a test.
   ``tools/time_kernels.py`` times the kernels; this run drives the paths
   around them.
2. Serving: drives ``QAPipeline.ask`` on 16 questions at batch 8 at full
   published width (BERT-base query tower, T5-base reader, K=50, reader
   length 512, 32 decode steps, int8 index, flash attention on: the
   flagship recipe), with weights from a seed, a synthetic ~20k-passage
   corpus and a 1,310,720-row index made on the device. Prints ms per
   stage, peak memory and each kernel's launch count during ``ask``, and
   checks the answers and the retrieved ids against an exact search.
   Generation, on the same model and questions: greedy with the int8 cross
   K/V, then ``QAPipeline(beam_size=5, kv_quant="int8")``; prints the
   stages, the slab's bytes in both forms, the share of int8 greedy answers
   equal to the bf16-path ones, and holds one decode step's log-probs of
   the int8 session against the bf16-path session's.
3. Evaluation under ``flash_key_chunk=256`` (the reader's 512-token rows
   then take the general flash kernel): ``E2EQATask.evaluate_em`` on 16
   synthetic QA examples (greedy, int8 K/V), beam 5 on 8 of them, and
   ``validation_loss`` over two batches of 8; checks counts, EM range,
   finite losses, and the losses of one batch against the same weights
   with the flash kernels off.
4. The training loop under ``flash_key_chunk=256``, full width and depth:
   ``training.engine.train`` for four iterations at B=8 (dropout 0.1,
   ``--remat --no-remat-towers``) with ``prefetch_depth=2``, an async
   interval checkpoint at 2, the final one at 4 and an evaluation callback
   at 4 (``validation_loss`` on one batch, ``evaluate_em`` on 8 examples,
   greedy over the int8 K/V); then three more iterations with
   ``prefetch_depth=0`` for the time per iteration without the prefetcher.
   Checks the final iteration, ``TrainLog.history``, that the parameters
   moved, every kernel's launch count, the tracker and the ``iter_*``
   directories, that no worker thread is left, and that the final
   checkpoint restores into a fresh task bit for bit (every parameter and
   moment), from which one more step runs. Prints ms per iteration and per
   stage, peak memory, and the checkpoint's bytes and seconds (async
   stage, background write, synchronous save, load).
5. The evidence-index build at the same widths: ``EvidenceIndexBuilder``
   embeds 32,768 synthetic passages at Lc=256, batch 128, by the host path
   (fp16 rows in host RAM) and by the device path (bf16 rows on the card):
   passages/s, peak memory and K1-fwd's 3,072 launches of each; the paths'
   rows agree and 64 sampled rows equal ``retriever.embed_context``. Then
   ``ShardedEvidenceIndex.update`` of a 1,310,720-row int8 index (the
   reference's shard a GPU) from a host fp16 array and from a device tensor:
   the swap's stall; and the full-shard pass time at the measured rates.
6. The loop with a live ``AsyncIndexRefresher`` (the flagship layout, B=8,
   prefetch 0, 8 iterations, a 16,384-passage corpus and int8 index, reload
   interval 2), then 3 iterations without it: ms per iteration with an embed
   pass in flight and without, passages/s while training, each swap's ms,
   ``refresh_count`` >= 1, peak memory; the first swapped index held to the
   embedding of the tower handed over at ``start``; no thread left.
7. The command line: ``tools.create_doc_index.main`` and
   ``tasks.run.main(["--task", "OPENQA", ...])`` by their argv with the
   flagship flags, ``--async-indexer --index-reload-interval 2
   --index-quantize int8 --train-iters 4 --save-interval 2`` and 8 valid
   examples (rc 0, the tracker at 4, "valid EM" printed), then
   ``QAPipeline.load`` from that save answers 8 questions.
8. The RETRIEVER task: ``DPRTask.train_step`` at BERT-base x 2, global
   batch 128 with one hard negative (256 contexts), dropout 0.1, under no
   remat, ``remat_policy="nothing"`` and ``"dots_no_batch"`` (ms per step,
   peak memory, K1 launches), then ``validate`` in the 30+30 layout.
9. Retrieval evaluation: 16,384 passages embedded by a DPR context tower
   into a 1,310,720-row index (random rows beyond), bf16 and int8, and
   ``OpenRetrievalEvaluator.evaluate_recall`` of 3,610 questions at k=100 in
   one search (the tensor-core K3); rows and recall held to an exact
   search.
10. Two OPENQA steps at B=4 under ``--remat-policy nothing`` and
   ``dots_no_batch`` (ms, peak memory).
11. The RETRIEVER command line (``tasks.run --task RETRIEVER``: 4
   iterations, saves, validation, post-train recall), ``checkpoint_surgery
   extract`` loaded into an OPENQA model, and ``tools.evaluate_retrieval``,
   whose recall must equal the run's.
12. One step repeats bit for bit: a DPR step at 128 and an OPENQA step at
   B=8, at published widths, each twice from one state, fingerprinted
   module by module (``utils/repeat.py``). The OPENQA task's first step is
   the main path's run of the kernels: their counts zeroed just before it
   and each launch recorded, every kernel of the step must launch, LN as
   often as ``kernel_checks.layer_norm_step_launches`` counts; then one
   ``{"kernels": [...]}`` line: each kernel's launches in that step, their
   bytes and operations, ``bound_ms`` (``flagship.bound_ms`` a launch,
   summed) and the largest error of the checks that hold it.
13. Data parallelism: (a) one rank over NCCL, the DPR step and the int8
   search bit-equal to the plain path; (b) two ranks sharing the card over
   gloo (subprocesses: ``--dp-rank R --dp-spec PATH``), each with half of
   one index, against one process: searches, step-1 losses, bit-equal
   replicas, ``evaluate_em``. ``--dp-cards N`` runs only this phase over
   NCCL, a rank a card, beside one card at the same batch a rank.
14. The embedder group: two ranks sharing the card over gloo, each running
   ``engine.train`` under the flagship layout with its
   ``AsyncIndexRefresher`` on the card (``--embed-devices 0``) and
   ``prefetch_depth=1``, an int8 index over 16,384 passages, reload
   interval 2, 6 iterations at 2 questions a rank, then 1 without the
   refresher: the ranks swap at the same iterations, the rows after the
   first swap are the hand-off tower's, the replicas bit-equal, the
   losses finite; ms per iteration with a pass in flight and without, the
   swap's stall, a rank's block of 655,360 int8 rows swapped in.
   ``--dp-cards 4`` adds the disjoint layout after its ranks phase: two
   trainers on cards 0-1 over NCCL at 8 questions a rank beside their
   embedders on cards 2-3 (32,768 passages, 8 + 3 iterations); the same
   checks, and no K1 launch at the builder's shape on a trainer card.
15. A launch across hosts: two emulated hosts of one rank each, each a
   subprocess with its own ``CUDA_VISIBLE_DEVICES`` and torchrun's
   variables, joining through ``parallel.init_distributed`` (the ranks
   learn their hosts at the rendezvous; a rank takes the card of its
   local rank on its host). Both hosts see card 0 and share it over gloo:
   the dp phase (b)'s OPENQA work without DPR (K3 searches on each rank's
   block, check steps at dropout 0, three steps at 0.1, ``evaluate_em``
   over int8 K/V) held to (b)'s one-process references by the same rules.
   ``--dp-cards 4`` adds two hosts of cards 0,1 and 2,3 over NCCL, a
   trainer on each host's card 0 beside its embedder on its card 1
   (the embedder phase's run and checks at 8 questions a rank); no two
   ranks on one trainer card, no embedder card on another host, by UUID.
16. The port's measurement tools (``emdr2_tpu_torch/tools/bench_*``), each
   through its ``main(argv)`` at ``EMDR2Config()`` widths and full depth,
   grids and iterations cut (``TOOLS_*``): the int8 re-rank window's two
   selections at k 20 and 51 over 1,310,720 rows (the same rows, the
   default window held to an exact search by the tie rule of
   ``TIE_EPS``, the recall of ``rescore=0`` beside it); K4 and K1
   forward + backward at key chunks 256-3,200 (256 and 512 must give
   times); the step's passes
   with their share of the peak (in (0, 1]); the dropout variants; a cut
   train sweep (B 8 and 16 under full remat beside an int8 index, B 8
   with the towers stored); the pipeline's stages A and B, index swap,
   embedding rate, prefetch overlap, decode and one decode-sweep row.
   Prints each tool's rows, its seconds and the phase's.

Every failure propagates (non-zero exit). Before the last line, a
``{"phase_seconds": {...}}`` line gives each phase's seconds; the last
line is ``{"ok": true, "device": {...}}``. Needs one CUDA device; without one it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import kernel_checks
# bf16 results against the plain path or the same weights another way are
# held to FWD_TOL; retrieval against an exact search to the recall rule
from kernel_checks import (FWD_TOL, K3_EXTRA, TIE_EPS, exact_top,
                           explain_misses, misses_text, recall_at)

REPO = os.path.dirname(os.path.abspath(__file__))
N_INDEX = 1_310_720
SEED = 1234
DA_COUNTED = ("dropout_add", "dropout_add_backward")
LN_COUNTED = ("layer_norm", "layer_norm_backward")


def log(*args):
    print(*args, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _errors(got, want):
    err = (got.float() - want.float()).abs()
    return err.max().item(), err.mean().item()


def _check(name, got, want, tol=FWD_TOL):
    """max / mean abs error and max|want|; fails beyond ``tol`` times the
    largest |want|."""
    max_err, mean_err = _errors(got, want)
    ref = want.float().abs().max().item() or 1.0
    if not (torch.isfinite(got.float()).all() and max_err <= tol[0] * ref
            and mean_err <= tol[1] * ref):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max {max_err} mean {mean_err} (ref {ref})")
    return max_err, mean_err, ref


K3_TIE_SEEDS = (SEED + 1, SEED + 2)  # more bf16 indexes for the widest tie


def make_corpus(cfg, tmpdir, n_docs=20_000):
    """Tokenizer with the published vocab sizes (its vocabulary written to
    ``<tmpdir>/vocab.txt``) and a synthetic corpus of ``n_docs`` passages
    at ``<tmpdir>/wiki_{text,title}``, the files the command-line tools
    read."""
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.indexed_dataset import (
        MMapIndexedDataset, MMapIndexedDatasetBuilder)
    from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer, toy_vocab

    words = ["what", "is", "the", "color", "of", "item"]
    base = len(toy_vocab(words))
    # fill the vocab to 70 below the retriever's padded vocab (BERT's 30522
    # entries for the published 30592), so the T5 tokenizer (+2 specials,
    # +100 sentinel ids) pads to the reader's published 30720
    n_words = cfg.retriever.encoder.vocab_size - 70 - base
    vocab = toy_vocab(words + [f"w{i}" for i in range(n_words)])
    with open(os.path.join(tmpdir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    tok = BertWordPieceTokenizer(vocab, vocab_extra_ids=100)
    rng = np.random.RandomState(SEED)
    lo, hi = base, len(vocab)
    text_p = os.path.join(tmpdir, "wiki_text")
    title_p = os.path.join(tmpdir, "wiki_title")
    with MMapIndexedDatasetBuilder(text_p) as b:
        for n in rng.randint(90, 140, size=n_docs):
            b.add_item(rng.randint(lo, hi, size=n).tolist())
    with MMapIndexedDatasetBuilder(title_p) as b:
        for i in range(n_docs):      # three passages per title
            b.add_item([lo + (i // 3) % (hi - lo), lo + 7])
    corpus = EvidenceCorpus(MMapIndexedDataset(text_p),
                            MMapIndexedDataset(title_p))
    return tok, corpus


def make_world(cfg, tmpdir, dev, gen, n_docs=20_000, n_rows=N_INDEX):
    """``make_corpus`` and an ``n_rows`` index made on ``dev``."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex

    tok, corpus = make_corpus(cfg, tmpdir, n_docs)
    emb = torch.randn(n_rows, cfg.index.embed_dim, device=dev, generator=gen)
    pids = 1 + np.arange(n_rows) % n_docs
    index = ShardedEvidenceIndex(cfg.index, emb, passage_ids=pids,
                                 device=dev)
    return tok, corpus, index


def exact_ids(index, q_emb, k):
    """Exact top-k rows over the stored (dequantized) index, fp32."""
    from emdr2_tpu_torch.ops import mips
    emb, scales = index.embeddings, index.scales
    rows = (mips.dequantize_int8(emb, scales, index.cfg.group_size)
            if scales is not None else emb.float())
    q = q_emb.float() if scales is not None else q_emb.to(emb.dtype).float()
    return torch.topk(torch.matmul(q, rows[:index.n_real].T), k,
                      dim=1).indices


def _counters():
    """name -> wrapper whose ``.launches`` counts its kernel's launches."""
    from emdr2_tpu_torch.ops import decode_attention as da
    from emdr2_tpu_torch.ops import dropout_add as drop
    from emdr2_tpu_torch.ops import fid_attention as fa
    from emdr2_tpu_torch.ops import layer_norm as norm
    from emdr2_tpu_torch.ops import mips
    return {"flash_self_attention": fa.flash_self_attention,
            "flash_self_attention_backward": fa.flash_self_attention_backward,
            "flash_cross_attention": fa.flash_cross_attention,
            "flash_cross_attention_backward":
                fa.flash_cross_attention_backward,
            "candidate_scan": mips.candidate_scan,
            "fid_cross_attention": fa.fid_cross_attention,
            "fid_cross_attention_backward": fa.fid_cross_attention_backward,
            "decode_cross_attention_int8": da.decode_cross_attention_int8,
            "dropout_add": drop.dropout_add,
            "dropout_add_backward": drop.dropout_add_backward,
            "layer_norm": norm.layer_norm,
            "layer_norm_backward": norm.layer_norm_backward}


def _reset_counts():
    from emdr2_tpu_torch.ops import mips
    for fn in _counters().values():
        fn.launches = 0
    mips.candidate_scan.tensor_core_launches = 0


def _read_counts(names):
    counters = _counters()
    return {name: counters[name].launches for name in names}


def kernel_phase(dev):
    """Every case of ``kernel_checks.CHECKS``: each hand-written kernel's
    wrapper against its plain version at the main path's shapes, by the
    functions and at the limits of the ``gpu`` tests. Fails at the first
    miss; -> {check: its largest error relative to its reference's largest
    magnitude}."""
    worst = {}
    for check, cases in kernel_checks.CHECKS:
        t0 = time.perf_counter()
        errs = []
        for case in cases:
            errs.append(check(dev, *case))
            _empty_cache(dev)
        worst[check.__name__] = max(errs)
        log(f"kernels {check.__name__}: {len(cases)} cases held, largest "
            f"error {max(errs):.3e} of the reference's largest, "
            f"{time.perf_counter() - t0:.1f} s")
    return worst


class _Recorded:
    """Stands in for a launch function of ``emdr2_tpu_torch.ops`` while a
    run is recorded: calls it and keeps, a call, (kernel, launches it
    counted, bytes, operations, their type). Attributes read and written
    pass through to the function, so its counters stay its own."""

    def __init__(self, fn, kernel, work, calls):
        for k, v in dict(_fn=fn, _sig=inspect.signature(fn), _kernel=kernel,
                         _work=work, _calls=calls).items():
            object.__setattr__(self, k, v)

    def __call__(self, *args, **kwargs):
        counter = _counters()[self._kernel]
        before = counter.launches
        out = self._fn(*args, **kwargs)
        a = self._sig.bind(*args, **kwargs)
        a.apply_defaults()
        self._calls.append((self._kernel, counter.launches - before,
                            *self._work(a.arguments, out)))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


def _launch_work():
    """(module, launch function, kernel it counts, work) for each launch
    function of the attention kernels, K3 and K5: work(arguments, result)
    -> (bytes, each input read once and each output written once;
    operations of the kernel's products; their type). DA and LN count
    their bytes themselves (``.bytes``)."""
    from emdr2_tpu_torch.ops import decode_attention as da
    from emdr2_tpu_torch.ops import fid_attention as fa
    from emdr2_tpu_torch.ops import mips

    def outs(r):
        return r if isinstance(r, tuple) else (r,)

    def saved(a):                # what a backward reads beside the inputs
        return a.get("lse"), a.get("out"), a.get("dout"), a.get("stats")

    def self_attention(passes):          # qkv [B, L, 3H]
        def work(a, r):
            B, L, H3 = a["qkv"].shape
            return (nbytes(a["qkv"], a["kv_bias"], a["rel_bias"], *saved(a),
                           *outs(r)),
                    passes * 4 * B * L * L * (H3 // 3), "bf16")
        return work

    def cross(passes):                   # q [B, Lq, H], kv [B, Lk, 2H]
        def work(a, r):
            B, Lq, H = a["q"].shape
            return (nbytes(a["q"], a["kv"], a["kv_bias"], *saved(a),
                           *outs(r)),
                    passes * 4 * B * Lq * a["kv"].shape[1] * H, "bf16")
        return work

    def fid(passes):                     # q [B, Lq, nh, hd], k [B, Lk, ...]
        def work(a, r):
            B, Lq, nh, hd = a["q"].shape
            return (nbytes(a["q"], a["k"], a["v"], a["kv_bias"], *saved(a),
                           *outs(r)),
                    passes * 4 * B * Lq * a["k"].shape[1] * nh * hd, "bf16")
        return work

    def scan(a, r):                      # queries [nq, D], index [N, D]
        q, index = a["queries"], a["index"]
        n, d = min(a["n_valid"], index.shape[0]), index.shape[1]
        return (nbytes(q, *r) + n * d * index.element_size(),
                2 * q.shape[0] * n * d,
                "int8" if index.dtype == torch.int8 else "bf16")

    def decode(a, r):                    # q [B, R, nh, hd], k8 [B, nh, Lk]
        B, R, nh, hd = a["q"].shape
        return (nbytes(a["q"], a["k8"], a["kscale"], a["v8"], a["vscale"],
                       a["kv_bias"], r),
                4 * B * R * nh * a["k8"].shape[2] * hd, "bf16")

    return ((fa, "flash_self_attention_forward", "flash_self_attention",
             self_attention(1)),
            (fa, "flash_self_attention_backward",
             "flash_self_attention_backward", self_attention(2.5)),
            (fa, "flash_cross_attention_forward", "flash_cross_attention",
             cross(1)),
            (fa, "_launch_cross_backward", "flash_cross_attention_backward",
             cross(2.5)),
            (fa, "fid_cross_attention_forward", "fid_cross_attention",
             fid(1)),
            (fa, "fid_cross_attention_backward",
             "fid_cross_attention_backward", fid(2.5)),
            (mips, "_launch", "candidate_scan", scan),
            (da, "_launch", "decode_cross_attention_int8", decode))


@contextlib.contextmanager
def recorded_launches(calls):
    """Record into ``calls`` every launch of the attention kernels, K3 and
    K5 (``_launch_work``) while the block runs."""
    table = _launch_work()
    originals = [getattr(module, name) for module, name, _, _ in table]
    try:
        for (module, name, kernel, work), fn in zip(table, originals):
            setattr(module, name, _Recorded(fn, kernel, work, calls))
        yield
    finally:
        for (module, name, _, _), fn in zip(table, originals):
            setattr(module, name, fn)


def step_kernels(task, batch, dev):
    """One ``task.train_step(batch)`` with every kernel's counts zeroed just
    before it and its launches recorded: -> {kernel: launches, bytes,
    operations and ``bound_ms``, the least time the card could take for
    them (``flagship.bound_ms`` a launch, summed; DA and LN by their
    counted bytes)}. Fails if a launch of a recorded kernel fell outside
    the recorded functions."""
    from emdr2_tpu_torch.tools import flagship
    _reset_counts()
    counters = _counters()
    for name in DA_COUNTED + LN_COUNTED:
        counters[name].bytes = 0
    calls = []
    with recorded_launches(calls):
        float(task.train_step(batch)["loss"])
    torch.cuda.synchronize(dev)
    rows = {}
    for name, fn in counters.items():
        if name in DA_COUNTED + LN_COUNTED:
            mine = [(name, fn.launches, fn.bytes, 0, "bf16")]
        else:
            mine = [c for c in calls if c[0] == name]
            if sum(c[1] for c in mine) != fn.launches:
                raise AssertionError(
                    f"{name}: {fn.launches} launches in the step, "
                    f"{sum(c[1] for c in mine)} of them recorded")
        bounds = [flagship.bound_ms(b, o, dev, t)[0]
                  for _, n, b, o, t in mine if n]
        rows[name] = dict(
            launches=fn.launches, bytes=sum(c[2] for c in mine),
            ops=sum(c[3] for c in mine),
            bound_ms=None if None in bounds else sum(bounds))
    return rows


def kernels_line(kernel_errors, step):
    """The ``kernels`` line: each kernel's source, its launches in the
    B=8 OPENQA step with their bytes, operations and ``bound_ms``
    (``step_kernels``), the checks that hold it and their largest error
    (``kernel_phase``)."""
    rows = [dict(name=name, route="cuda",
                 source="emdr2_tpu_torch/ops/csrc/" + source, **step[name],
                 checked_by=[c.__name__ for c in checks],
                 max_err=max(kernel_errors[c.__name__] for c in checks))
            for name, (source, checks) in kernel_checks.KERNELS.items()]
    return {"kernels": rows, "run": "E2EQATask.train_step at B=8, the "
            "flagship recipe (--remat --no-remat-towers)"}


def log_profile(what, p):
    busy = p["device_ms"] / p["wall_ms"]
    log(f"profiled {what}: wall {p['wall_ms']:.1f} ms, device kernels "
        f"{p['device_ms']:.1f} ms (busy {busy:.3f})")
    for key, ms, count in p["top"]:
        log(f"  {ms:10.3f} ms  {count:6d}x  {key[:100]}")
    log(f"  by class of kernel ({what}):")
    for label, ms in sorted(p["classes"].items(), key=lambda kv: -kv[1]):
        log(f"  {ms:10.3f} ms  {ms / p['device_ms']:6.1%}  {label}")
    log(f"  by operator ({what}):")
    for key, ms, count in p["by_op"]:
        log(f"  {ms:10.3f} ms  {count:6d}x  {key[:100]}")


def generation_runs(cfg, model, tok, corpus, index, dev, questions, batch,
                    base_pipe, base_answers, profile=False):
    """The generation path on the serving phase's model and questions:
    greedy over the int8 cross K/V, then beam 5 over it; then, outside the
    counted runs, the slab's bytes in both forms and one decode step's
    log-probs of the int8 session against the bf16-path session's."""
    from emdr2_tpu_torch.serving import QAPipeline
    from emdr2_tpu_torch.utils.timing import StageTimer

    names = ("flash_self_attention", "candidate_scan",
             "decode_cross_attention_int8")
    runs = {}
    for name, kw in (("greedy_int8", dict(kv_quant="int8")),
                     ("beam5_int8", dict(beam_size=5, kv_quant="int8"))):
        timer = StageTimer(dev)
        pipe = QAPipeline(cfg, model, tok, corpus, index, batch_size=batch,
                          timer=timer, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        answers = pipe.ask(questions)
        ask_s = time.perf_counter() - t0
        launches = _read_counts(names)
        if len(answers) != len(questions) or not all(
                isinstance(a, str) for a in answers):
            raise AssertionError(f"{name}: bad answers {answers!r}")
        runs[name] = dict(
            answers=answers, launches=launches, stage_ms=dict(timer.ms),
            ask_s=ask_s, pipe=pipe,
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else 0))
    if profile:        # one warm batch of each greedy form
        first = list(questions[:batch])
        runs["profiles"] = {
            "greedy, fp32-K slab": profile_call(
                lambda: base_pipe.ask(first), "greedy_bf16_profile.txt"),
            "greedy, int8 slab": profile_call(
                lambda: runs["greedy_int8"]["pipe"].ask(first),
                "greedy_int8_profile.txt")}
    same = sum(a == b for a, b in zip(runs["greedy_int8"]["answers"],
                                      base_answers))
    runs["greedy_int8"]["share_equal_bf16"] = same / len(questions)

    # one decode step from BOS, both sessions on the same encoder states
    dev_batch = base_pipe._build_batch(list(questions[:batch]))
    sessions = {"bf16": base_pipe.session,
                "int8": runs["greedy_int8"].pop("pipe").session}
    runs["beam5_int8"].pop("pipe")
    lps, slab_bytes = {}, {}
    for name, session in sessions.items():
        kvs, flat = session.encode(dev_batch)
        slab_bytes[name] = sum(nbytes(*kv) for kv in kvs)
        with torch.inference_mode():
            tok0 = torch.full((flat.shape[0], 1), tok.bos_id,
                              dtype=torch.long, device=dev)
            lps[name] = session._step_lp(
                tok0, flat, kvs, session.new_cache(flat.shape[0], dev), 0)
        del kvs
    diff = (lps["int8"] - lps["bf16"]).abs().max().item()
    if not (torch.isfinite(lps["int8"]).all() and diff < 0.1):
        raise AssertionError(f"int8 decode step log-probs differ from the "
                             f"bf16-path ones by {diff}")
    runs["step_logprob_max_diff"] = diff
    runs["slab_bytes"] = slab_bytes
    return runs


def slice_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
                n_questions=16, profile=False):
    """Drive QAPipeline.ask (greedy, the serving path), then the generation
    path (``generation_runs``) on the same model; returns {"launches",
    "stage_ms", ..., "generation"}."""
    from emdr2_tpu_torch.data.qa_dataset import encode_question
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.serving import QAPipeline
    from emdr2_tpu_torch.utils.timing import StageTimer

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        model = EMDR2Model(cfg, device=dev, generator=gen)
        timer = StageTimer(dev)
        pipe = QAPipeline(cfg, model, tok, corpus, index, batch_size=batch,
                          timer=timer)
        log(f"slice set-up {time.perf_counter() - t0:.1f} s: "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
            f"index {tuple(index.embeddings.shape)} "
            f"{index.embeddings.dtype}, {len(corpus)} passages")
        questions = [f"what is the color of item w{7 * i}"
                     for i in range(n_questions)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        answers = pipe.ask(questions)
        ask_s = time.perf_counter() - t0
        launches = _read_counts(("flash_self_attention", "candidate_scan"))
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)

        if len(answers) != n_questions or not all(
                isinstance(a, str) for a in answers):
            raise AssertionError(f"bad answers: {answers!r}")
        # the retrieval of every batch of the run equals an exact search
        k = cfg.index.topk
        for s in range(0, n_questions, batch):
            ids = np.asarray([encode_question(q, tok,
                                              cfg.retriever.query_seq_len)[0]
                              for q in questions[s:s + batch]])
            with torch.inference_mode():
                q_emb = model.embed_query(torch.as_tensor(ids).to(dev))
                _, got = index.search(q_emb, k)
                want = exact_ids(index, q_emb, k)
            for r in range(got.shape[0]):
                if set(got[r].tolist()) != set(want[r].tolist()):
                    raise AssertionError(f"search ids differ from the exact "
                                         f"search, batch {s // batch} row {r}")
        generation = generation_runs(cfg, model, tok, corpus, index, dev,
                                     questions, batch, pipe, answers,
                                     profile)
    return dict(answers=answers, launches=launches, stage_ms=dict(timer.ms),
                ask_s=ask_s, peak_bytes=peak, generation=generation)


def eval_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
               n_examples=16, beam_size=5):
    """Drive ``E2EQATask.evaluate_em`` (greedy over the int8 K/V on all
    examples, then beam search on one batch) and ``validation_loss`` under
    ``cfg`` (whose ``flash_key_chunk`` sends the reader's rows through the
    general flash kernel); then hold one batch's losses against the same
    weights with the flash kernels off (materialized attention)."""
    from emdr2_tpu_torch.config import with_transformers
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import step as step_lib
    from emdr2_tpu_torch.utils.timing import StageTimer

    names = ("flash_self_attention", "flash_cross_attention",
             "candidate_scan", "fid_cross_attention",
             "decode_cross_attention_int8")
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        qa = os.path.join(tmpdir, "qa.tsv")
        with open(qa, "w") as f:
            for i in range(n_examples):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        ds = OpenQADataset([qa], tok, cfg.retriever.query_seq_len,
                           cfg.reader.decoder_seq_len, seed=SEED)
        timer = StageTimer(dev)
        task = E2EQATask(cfg, tok, corpus, index, device=dev, timer=timer)
        state = task.init_state(SEED)
        log(f"eval set-up {time.perf_counter() - t0:.1f} s: flash_key_chunk "
            f"{cfg.reader.transformer.flash_key_chunk}, {n_examples} "
            f"examples, batch {batch}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        em, n = task.evaluate_em(ds, batch_size=batch, kv_quant="int8")
        t1 = time.perf_counter()
        em_beam, n_beam = task.evaluate_em(ds, batch_size=batch,
                                           beam_size=beam_size,
                                           max_batches=1)
        t2 = time.perf_counter()
        val = task.validation_loss(ds, batch_size=batch)
        t3 = time.perf_counter()
        launches = _read_counts(names)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        if n != n_examples or n_beam != min(batch, n_examples):
            raise AssertionError(f"evaluate_em counted {n} and {n_beam}")
        if not (0.0 <= em <= 100.0 and 0.0 <= em_beam <= 100.0):
            raise AssertionError(f"EM out of range: {em}, {em_beam}")
        if set(val) != {"loss", "lm_loss", "retriever_loss"} or not all(
                np.isfinite(v) for v in val.values()):
            raise AssertionError(f"validation_loss: {val}")

        # the same weights with every flash kernel off, one batch
        off = {"fid_flash_attention": False}
        plain_cfg = with_transformers(cfg, off, off)
        plain = EMDR2Model(plain_cfg, device=dev)
        plain.load_state_dict(state.model.state_dict())
        qa_batch = next(ds.epoch_batches(batch, seed=0, shuffle=False))
        dev_batch = task.build_device_batch(qa_batch)
        got = task._eval_fn(state, dev_batch)
        want = step_lib.make_eval_forward(plain_cfg, tok.eos_id)(
            step_lib.TrainState(0, SEED, plain, None), dev_batch)
        agree = {}
        for key in ("loss", "lm_loss", "retriever_loss"):
            g, w = float(got[key]), float(want[key])
            agree[key] = (g, w)
            if key != "retriever_loss" and abs(g - w) > 5e-2 * abs(w):
                raise AssertionError(f"{key} with the kernels {g} against "
                                     f"materialized attention {w}")
        del plain
    return dict(em=em, n=n, em_beam=em_beam, n_beam=n_beam, val=val,
                launches=launches, stage_ms=dict(timer.ms), peak_bytes=peak,
                seconds=dict(evaluate_em=t1 - t0, evaluate_em_beam=t2 - t1,
                             validation_loss=t3 - t2), agree=agree)


def train_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
                steps=3, total_iters=1000, profile=False,
                profile_table="train_step_profile.txt"):
    """Drive ``E2EQATask.train_step``; returns {"metrics", "launches",
    "stage_ms", ...}. The flagship schedule warms up over 1% of
    ``total_iters``, so the first update's lr is 0 and the later ones are
    not."""
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training.step import METRICS
    from emdr2_tpu_torch.utils.timing import StageTimer

    names = ("flash_self_attention", "flash_self_attention_backward",
             "flash_cross_attention", "flash_cross_attention_backward",
             "candidate_scan") + DA_COUNTED + LN_COUNTED
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        qa = os.path.join(tmpdir, "qa.tsv")
        with open(qa, "w") as f:
            for i in range(batch * (steps + 1)):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        ds = OpenQADataset([qa], tok, cfg.retriever.query_seq_len,
                           cfg.reader.decoder_seq_len, seed=SEED)
        timer = StageTimer(dev)
        task = E2EQATask(cfg, tok, corpus, index, total_train_iters=total_iters,
                         device=dev, timer=timer)
        state = task.init_state(SEED)
        n_params = sum(p.numel() for p in state.model.parameters())
        log(f"train set-up {time.perf_counter() - t0:.1f} s: "
            f"{n_params / 1e6:.1f}M params, batch {batch}, remat reader="
            f"{cfg.reader.transformer.remat} towers="
            f"{cfg.retriever.encoder.remat}, dropout "
            f"{cfg.reader.transformer.hidden_dropout}/"
            f"{cfg.reader.transformer.attention_dropout}")
        batches = ds.epoch_batches(batch, seed=SEED)
        probe = state.model.reader.decoder.layer(0).mlp.wi.kernel
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        rows = []
        for i in range(steps):
            lr = state.optimizer.schedule(state.optimizer.count)
            before = probe.detach().clone()
            t0 = time.perf_counter()
            m = task.train_step(next(batches))
            row = {k: float(m[k]) for k in METRICS}    # syncs the device
            wall = time.perf_counter() - t0
            row.update(lr=lr, wall_s=wall,
                       moved=not torch.equal(before, probe.detach()))
            rows.append(row)
            log(f"train step {i}: " + ", ".join(
                f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()))
        launches = _read_counts(names)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        top = None
        if profile:
            batch_p = next(batches)
            top = profile_call(lambda: task.train_step(batch_p),
                               profile_table)
    for i, row in enumerate(rows):
        if not all(np.isfinite(row[k]) for k in METRICS):
            raise AssertionError(f"train step {i}: non-finite metrics {row}")
        if row["grad_norm"] <= 0:
            raise AssertionError(f"train step {i}: zero gradient norm")
        if row["lr"] > 0 and not row["moved"]:
            raise AssertionError(f"train step {i}: lr {row['lr']} but the "
                                 f"parameters did not move")
    if not any(row["lr"] > 0 for row in rows):
        raise AssertionError("no step ran with a non-zero learning rate")
    return dict(metrics=rows, launches=launches, stage_ms=dict(timer.ms),
                peak_bytes=peak, top=top)


def _host_state(state):
    """(parameters, AdamW moments and step counts, (step, seed, count)) of
    a TrainState as host copies."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    params = {k: host(v) for k, v in state.model.state_dict().items()}
    adam = state.optimizer.adamw.state
    moments = {n: tuple(host(adam[p][key])
                        for key in ("exp_avg", "exp_avg_sq", "step"))
               for n, p in state.model.named_parameters()}
    return params, moments, (state.step, state.seed, state.optimizer.count)


def engine_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
                 iters=4, plain_iters=3, prefetch_depth=2, eval_examples=8,
                 total_iters=1000):
    """Drive ``training.engine.train`` under ``cfg`` (whose
    ``flash_key_chunk`` sends the reader's rows through the general flash
    kernel, forward and backward): ``iters`` iterations with the
    prefetcher, an interval checkpoint at ``iters // 2``, the final one and
    an evaluation callback at ``iters``; then ``plain_iters`` more without
    the prefetcher; then the final checkpoint restored into a fresh task
    and one more step from it; then the checkpoint's times."""
    import dataclasses
    import shutil
    import threading

    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import checkpointing as ckpt
    from emdr2_tpu_torch.training import engine
    from emdr2_tpu_torch.training.step import METRICS
    from emdr2_tpu_torch.utils.timing import StageTimer

    def loop_cfg(train_iters):
        return cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=batch, train_iters=train_iters,
            log_interval=1, save_interval=max(iters // 2, 1),
            eval_interval=iters, async_save=True, seed=SEED))

    def qa_file(path, n, offset=0):
        with open(path, "w") as f:
            for i in range(offset, offset + n):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")

    def dataset(path):
        return OpenQADataset([path], tok, cfg.retriever.query_seq_len,
                             cfg.reader.decoder_seq_len, seed=SEED)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        qa_file(os.path.join(tmpdir, "train.tsv"),
                batch * (iters + plain_iters + 1))
        qa_file(os.path.join(tmpdir, "valid.tsv"), eval_examples, 10_000)
        ds = dataset(os.path.join(tmpdir, "train.tsv"))
        valid = dataset(os.path.join(tmpdir, "valid.tsv"))
        timer = StageTimer(dev)
        task = E2EQATask(cfg, tok, corpus, index,
                         total_train_iters=total_iters, device=dev,
                         timer=timer)
        state = task.init_state(SEED)
        n_params = sum(p.numel() for p in state.model.parameters())
        log(f"engine set-up {time.perf_counter() - t0:.1f} s: "
            f"{n_params / 1e6:.1f}M params, batch {batch}, flash_key_chunk "
            f"{cfg.reader.transformer.flash_key_chunk}, prefetch_depth "
            f"{prefetch_depth}")
        probe = state.model.reader.decoder.layer(0).mlp.wi.kernel
        before = probe.detach().clone()
        root = os.path.join(tmpdir, "checkpoints")
        evals = []

        def eval_callback(iteration):
            t0 = time.perf_counter()
            val = task.validation_loss(valid, batch_size=batch, max_batches=1)
            em, n = task.evaluate_em(valid, batch_size=batch,
                                     kv_quant="int8", max_batches=1)
            out = {"valid_loss": val["loss"], "valid_lm_loss": val["lm_loss"],
                   "valid_em": em, "valid_n": n}
            evals.append(dict(out, iteration=iteration,
                              seconds=time.perf_counter() - t0))
            return out

        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        train_log = engine.TrainLog(1, log)
        t0 = time.perf_counter()
        final = engine.train(task, ds, loop_cfg(iters), save_dir=root,
                             eval_callback=eval_callback,
                             prefetch_depth=prefetch_depth, printer=log,
                             log=train_log)
        sync()
        train_s = time.perf_counter() - t0
        launches = _read_counts(tuple(_counters()))
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        stage_ms = {k: list(v) for k, v in timer.ms.items()}

        history = train_log.history
        if final != iters or state.step != iters or [
                h["iteration"] for h in history] != list(range(1, iters + 1)):
            raise AssertionError(f"engine ended at {final}, state step "
                                 f"{state.step}, history {history}")
        for h in history:
            if not all(np.isfinite(h[k]) for k in METRICS):
                raise AssertionError(f"non-finite metrics: {h}")
            if h["grad_norm"] <= 0:
                raise AssertionError(f"zero gradient norm: {h}")
        if torch.equal(before, probe.detach()):
            raise AssertionError("the parameters did not move")
        if [e["iteration"] for e in evals] != [iters] or not all(
                np.isfinite(evals[0][k]) for k in ("valid_loss",
                                                   "valid_lm_loss")) \
                or evals[0]["valid_n"] != min(eval_examples, batch) \
                or not 0.0 <= evals[0]["valid_em"] <= 100.0:
            raise AssertionError(f"evaluation callback: {evals}")
        want_dirs = sorted({f"iter_{max(iters // 2, 1):07d}",
                            f"iter_{iters:07d}", ckpt.TRACKER})
        if sorted(os.listdir(root)) != want_dirs \
                or ckpt.latest_iteration(root) != iters:
            raise AssertionError(f"checkpoints: {sorted(os.listdir(root))}, "
                                 f"tracker {ckpt.latest_iteration(root)}")
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(("batch-prefetch", "ckpt-write"))]
        if alive:
            raise AssertionError(f"threads left alive: {alive}")
        want_state = _host_state(state)
        ckpt_bytes = os.path.getsize(os.path.join(
            ckpt.iter_dir(root, iters), ckpt.STATE_FILE))

        # the same task goes on without the prefetcher
        plain_log = engine.TrainLog(1, log)
        final = engine.train(task, ds, loop_cfg(iters + plain_iters),
                             prefetch_depth=0, printer=log, log=plain_log)
        sync()
        if final != iters + plain_iters or len(plain_log.history) != \
                plain_iters:
            raise AssertionError(f"plain run ended at {final}")

        # the final checkpoint into a fresh task, bit for bit; the first
        # task's state leaves the card first (two states and a step's
        # activations do not fit)
        del state, probe, before
        task.state = None
        task._retrieval_snapshot = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        fresh = E2EQATask(cfg, tok, corpus, index,
                          total_train_iters=total_iters, device=dev)
        fresh.init_state(SEED + 1)
        t0 = time.perf_counter()
        _, it = ckpt.load_checkpoint(root, fresh.state)
        sync()
        load_s = time.perf_counter() - t0
        got_state = _host_state(fresh.state)
        if it != iters or got_state[2] != want_state[2]:
            raise AssertionError(f"restored iteration {it}, counters "
                                 f"{got_state[2]} against {want_state[2]}")
        for name, w in want_state[0].items():
            if not torch.equal(got_state[0][name], w):
                raise AssertionError(f"restored parameter {name} differs")
        for name, w in want_state[1].items():
            if not all(torch.equal(g, x)
                       for g, x in zip(got_state[1][name], w)):
                raise AssertionError(f"restored moment of {name} differs")
        n_compared = len(want_state[0]) + 2 * len(want_state[1])
        del want_state, got_state
        m = fresh.train_step(next(ds.epoch_batches(batch, seed=SEED + 99)))
        resumed = {k: float(m[k]) for k in METRICS}
        if fresh.state.step != iters + 1 or not all(
                np.isfinite(v) for v in resumed.values()) \
                or resumed["grad_norm"] <= 0:
            raise AssertionError(f"step after the restore: {resumed}")

        # the checkpoint's times, on the restored task's state
        shutil.rmtree(root)
        t0 = time.perf_counter()
        ckpt.save_checkpoint(root, fresh.state, 1, async_save=True)
        t1 = time.perf_counter()
        ckpt.finalize_async_saves()
        t2 = time.perf_counter()
        ckpt.save_checkpoint(root, fresh.state, 1)
        t3 = time.perf_counter()
    return dict(history=history, plain_history=plain_log.history,
                evals=evals, launches=launches, stage_ms=stage_ms,
                peak_bytes=peak, train_s=train_s, resumed=resumed,
                n_compared=n_compared, checkpoint=dict(
                    bytes=ckpt_bytes, async_stage_s=t1 - t0,
                    background_write_s=t2 - t1, sync_save_s=t3 - t2,
                    load_s=load_s))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _empty_cache(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def index_phase(cfg, dev, gen, n_docs=32_768, n_rows=N_INDEX, batch=128,
                n_check=64):
    """The evidence-index build at the flagship widths:
    ``EvidenceIndexBuilder`` embeds ``n_docs`` passages at
    Lc=``cfg.retriever.seq_len`` in batches of ``batch``, by the host path
    (fp16 rows in host RAM) and by the device path (rows in
    ``cfg.index.dtype`` on the card): passages/s, peak memory and K1-fwd's
    launches of each; the two paths' rows agree, and ``n_check`` sampled
    rows equal ``retriever.embed_context`` on the same passages. Then the
    swap's stall: ``ShardedEvidenceIndex.update`` of an int8 index of
    ``n_rows`` rows (the reference's shard a GPU) from a host fp16 array and
    from a device tensor."""
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder

    res = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus = make_corpus(cfg, tmpdir, n_docs)
        model = EMDR2Model(cfg, device=dev, generator=gen)
        builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                       tok.sep_id, tok.pad_id,
                                       batch_size=batch)
        with torch.inference_mode():              # warm-up: one batch
            builder._embed(model, np.arange(1, batch + 1))
        log(f"index set-up {time.perf_counter() - t0:.1f} s: {n_docs} "
            f"passages, batch {batch}, Lc {cfg.retriever.seq_len}")
        paths = {}
        for name in ("host", "device"):
            _reset_peak(dev)
            _reset_counts()
            t0 = time.perf_counter()
            rows = (builder.embed_corpus() if name == "host"
                    else builder.embed_corpus_device(None, n_docs))
            _sync(dev)
            sec = time.perf_counter() - t0
            paths[name] = dict(
                rows=rows, seconds=sec, per_s=n_docs / sec,
                peak_bytes=_peak(dev),
                launches=_read_counts(("flash_self_attention",))[
                    "flash_self_attention"])
            # 12 a batch on the card; the plain version on the CPU
            want = (-(-n_docs // batch) * cfg.retriever.encoder.num_layers
                    if dev.type == "cuda" else 0)
            if paths[name]["launches"] != want:
                raise AssertionError(f"index {name} path: K1-fwd launched "
                                     f"{paths[name]['launches']} times, "
                                     f"want {want}")
            log(f"index {name} path: {n_docs} passages in {sec:.3f} s = "
                f"{n_docs / sec:.1f} passages/s, peak memory "
                f"{paths[name]['peak_bytes'] / 2**30:.2f} GiB, K1-fwd "
                f"launches {paths[name]['launches']}")
        host = torch.from_numpy(paths["host"]["rows"]).to(dev)
        dev_rows = paths["device"].pop("rows")
        if dev_rows.dtype != cfg.index.dtype or tuple(dev_rows.shape) != (
                n_docs, cfg.index.embed_dim):
            raise AssertionError(f"device path rows {dev_rows.dtype} "
                                 f"{tuple(dev_rows.shape)}")
        # fp16 against cfg.index.dtype (bf16) roundings of the same fp32
        agree = _check("index: device path against host path", dev_rows,
                       host, FWD_TOL)
        doc_ids = np.sort(np.random.RandomState(SEED).choice(
            n_docs, n_check, replace=False)) + 1
        ids, types = builder._format_rows(doc_ids)
        with torch.inference_mode():
            want = model.retriever.embed_context(
                torch.as_tensor(ids).long().to(dev),
                torch.as_tensor(types).long().to(dev))
        sampled = _check("index: sampled rows against embed_context",
                         host[doc_ids - 1], want, FWD_TOL)
        log(f"index: device rows against host rows: max abs err "
            f"{agree[0]:.3e}, mean {agree[1]:.3e} (tol {FWD_TOL} x max|ref| "
            f"{agree[2]:.3e}); {n_check} sampled host rows against "
            f"retriever.embed_context: max abs err {sampled[0]:.3e}, mean "
            f"{sampled[1]:.3e} (same tol, max|ref| {sampled[2]:.3e})")
        del host, dev_rows, want, model, builder
        for name in paths:
            paths[name].pop("rows", None)
        res.update(paths, agree=agree[:2], sampled=sampled[:2])
    _empty_cache(dev)

    # the swap's stall at the reference's shard a GPU
    emb = torch.randn(n_rows, cfg.index.embed_dim, device=dev, generator=gen)
    index = ShardedEvidenceIndex(cfg.index, emb, device=dev)
    host_rows = emb.to(torch.float16).cpu().numpy()
    dev_rows = emb.to(cfg.index.dtype)
    del emb
    stalls = {"host": [], "device": []}
    for name, rows, reps in (("host", host_rows, 2), ("device", dev_rows, 3)):
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            index.update(rows)
            t1 = time.perf_counter()
            _sync(dev)
            stalls[name].append(((t1 - t0) * 1e3,
                                 (time.perf_counter() - t0) * 1e3))
        log(f"index: update of the {n_rows}-row int8 index from the {name} "
            f"({tuple(rows.shape)} {rows.dtype}): " + ", ".join(
                f"{h:.1f} ms on the host thread, {t:.1f} ms until the card "
                f"is done" for h, t in stalls[name]))
    del index, host_rows, dev_rows
    _empty_cache(dev)
    res["stalls"] = stalls
    res["full_shard_s"] = {name: n_rows / res[name]["per_s"]
                           for name in ("host", "device")}
    log(f"index: one full-shard pass of {n_rows} passages at these rates: "
        + ", ".join(f"{name} path {s:.1f} s"
                    for name, s in res["full_shard_s"].items()))
    return res


def refresh_phase(cfg, dev, gen, n_docs=16_384, batch=8, iters=8,
                  plain_iters=3, reload_interval=2, n_check=64,
                  total_iters=1000):
    """``training.engine.train`` at full width with a live
    ``AsyncIndexRefresher`` over an ``n_docs``-passage corpus and int8
    index (``reload_interval``, prefetch 0), ``iters`` iterations; then
    ``plain_iters`` more without a refresher. The instrumentation wraps the
    refresher's ``maybe_swap`` (each swap's stall on the trainer thread)
    and its builder's ``embed_corpus`` (each completed pass's window), and
    the loop's printer (each iteration's end); ``on_refresh`` samples
    ``n_check`` rows of the index after the first swap, which are held to
    an embedding made with a copy of the tower taken at the hand-off."""
    import copy
    import dataclasses
    import threading

    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.retrieval.builder import (EvidenceIndexBuilder,
                                                   context_tower)
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import engine
    from emdr2_tpu_torch.training.async_refresh import AsyncIndexRefresher
    from emdr2_tpu_torch.training.step import METRICS

    def loop_cfg(train_iters):
        return cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=batch, train_iters=train_iters,
            log_interval=1, save_interval=10 ** 6, eval_interval=10 ** 6,
            index_reload_interval=reload_interval, seed=SEED))

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus, index = make_world(cfg, tmpdir, dev, gen, n_docs,
                                        n_docs)
        qa = os.path.join(tmpdir, "qa.tsv")
        with open(qa, "w") as f:
            for i in range(batch * (iters + plain_iters + 1)):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        ds = OpenQADataset([qa], tok, cfg.retriever.query_seq_len,
                           cfg.reader.decoder_seq_len, seed=SEED)
        task = E2EQATask(cfg, tok, corpus, index,
                         total_train_iters=total_iters, device=dev)
        model = task.init_state(SEED).model
        start_weights = {k: v.detach().to("cpu", copy=True) for k, v in
                         context_tower(model).state_dict().items()}
        builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                       tok.sep_id, tok.pad_id)
        check_rows = np.sort(np.random.RandomState(SEED + 1).choice(
            n_docs, n_check, replace=False))
        first = {}

        def on_refresh(step):
            if not first:
                rows = mips.dequantize_int8(index.embeddings, index.scales,
                                            cfg.index.group_size)
                first.update(step=step, rows=rows[check_rows].clone(),
                             scales=index.scales[check_rows //
                                                 cfg.index.group_size])

        refresher = AsyncIndexRefresher(builder, index, reload_interval,
                                        on_refresh=on_refresh)
        passes, swaps, ends = [], [], []
        embed = builder.embed_corpus

        def timed_embed(*args, **kw):
            t0 = time.perf_counter()
            out = embed(*args, **kw)
            passes.append((t0, time.perf_counter()))
            return out

        builder.embed_corpus = timed_embed
        maybe_swap = refresher.maybe_swap

        def timed_swap(step, model):
            t0 = time.perf_counter()
            swapped = maybe_swap(step, model)
            if swapped:
                swaps.append((step, (time.perf_counter() - t0) * 1e3))
            return swapped

        refresher.maybe_swap = timed_swap

        def printer(line):
            if "ms_per_iter" in line:
                ends.append(time.perf_counter())
            log(line)

        log(f"refresh set-up {time.perf_counter() - t0:.1f} s: {n_docs} "
            f"passages, int8 index, batch {batch}, reload interval "
            f"{reload_interval}")
        _reset_peak(dev)
        _reset_counts()
        train_log = engine.TrainLog(1, printer)
        t_start = time.perf_counter()
        final = engine.train(task, ds, loop_cfg(iters), refresher=refresher,
                             printer=printer, log=train_log)
        _sync(dev)
        train_s = time.perf_counter() - t_start
        launches = _read_counts(tuple(_counters()))
        peak = _peak(dev)
        alive = [t.name for t in threading.enumerate() if t.name.startswith(
            ("index-refresh", "batch-prefetch", "ckpt-write"))]
        history = train_log.history
        if final != iters or [h["iteration"] for h in history] != list(
                range(1, iters + 1)) or alive:
            raise AssertionError(f"refresh run ended at {final}, history "
                                 f"{history}, threads left {alive}")
        for h in history:
            if not all(np.isfinite(h[k]) for k in METRICS):
                raise AssertionError(f"non-finite metrics: {h}")
        if refresher.refresh_count < 1 or refresher.error is not None \
                or len(swaps) != refresher.refresh_count or not first:
            raise AssertionError(f"refresh_count "
                                 f"{refresher.refresh_count}, swaps {swaps}, "
                                 f"error {refresher.error!r}")

        # iterations whose window overlaps a completed embed pass by half
        starts = [t_start] + ends[:-1]
        busy = []
        for s, e in zip(starts, ends):
            overlap = sum(max(0.0, min(e, pe) - max(s, ps))
                          for ps, pe in passes)
            busy.append(overlap >= 0.5 * (e - s))
        with_embed = [h["ms_per_iter"] for h, b in zip(history, busy) if b]
        without = [h["ms_per_iter"] for h, b in zip(history, busy)
                   if not b]

        plain_log = engine.TrainLog(1, log)
        engine.train(task, ds, loop_cfg(iters + plain_iters), printer=log,
                     log=plain_log)
        _sync(dev)

        # the first swapped index against the tower at the hand-off
        tower = copy.deepcopy(context_tower(model)).requires_grad_(False)
        tower.load_state_dict(start_weights)
        ids, types = builder._format_rows(check_rows + 1)
        with torch.inference_mode():
            want = tower.embed(torch.as_tensor(ids).long().to(dev),
                               torch.as_tensor(types).long().to(dev)).float()
        err = (first["rows"] - want).abs()
        # one int8 step of the row's group, plus the bf16 forward tolerance
        limit = first["scales"][:, None] + FWD_TOL[0] * want.abs().max()
        steps_err = (err / first["scales"][:, None]).max().item()
        if not bool((err <= limit).all()):
            raise AssertionError(f"swapped rows differ from the hand-off "
                                 f"tower's embedding by {err.max().item()}")
        del tower, want, task, model
    _empty_cache(dev)
    pass_s = [pe - ps for ps, pe in passes]
    return dict(history=history, plain_history=plain_log.history,
                with_embed=with_embed, without=without, swaps=swaps,
                refresh_count=refresher.refresh_count, pass_s=pass_s,
                per_s=[n_docs / s for s in pass_s], launches=launches,
                peak_bytes=peak, train_s=train_s, first_swap=first["step"],
                check_err=err.max().item(), check_steps=steps_err)


class _Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def cli_phase(cfg, dev, n_docs=16_384, batch=8, iters=4, n_valid=8,
              model_args=()):
    """The command line on one corpus: the offline index
    (``tools.create_doc_index.main``), then ``tasks.run.main`` with the
    flagship flags, the async indexer at interval 2, an int8 index, an
    interval checkpoint at 2 and a valid set of ``n_valid``; then
    ``QAPipeline.load`` from that save, with the run's configuration,
    answers ``n_valid`` questions. ``model_args`` (none: the published
    widths) go to both tools; ``cfg`` sizes the vocabulary."""
    import contextlib

    from emdr2_tpu_torch.serving import QAPipeline
    from emdr2_tpu_torch.tasks import run as run_cli
    from emdr2_tpu_torch.tools import create_doc_index
    from emdr2_tpu_torch.training import checkpointing as ckpt

    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        make_corpus(cfg, tmpdir, n_docs)
        vocab = os.path.join(tmpdir, "vocab.txt")
        prefix = os.path.join(tmpdir, "wiki")
        emb = os.path.join(tmpdir, "emb")
        save = os.path.join(tmpdir, "run")
        files = {}
        for name, n, offset in (("train", batch * iters, 0),
                                ("valid", n_valid, 10_000)):
            files[name] = os.path.join(tmpdir, f"{name}.tsv")
            with open(files[name], "w") as f:
                for i in range(offset, offset + n):
                    f.write(f"what is the color of item w{7 * i}\t"
                            f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        log(f"cli set-up {time.perf_counter() - t0:.1f} s: {n_docs} "
            f"passages")
        tee = _Tee(sys.stdout)
        seconds = {}
        _reset_counts()
        with contextlib.redirect_stdout(tee):
            t0 = time.perf_counter()
            rc_index = create_doc_index.main([
                "--evidence-data-path", prefix, "--vocab-file", vocab,
                "--embedding-path", emb, "--batch-size", "128",
                "--fid-flash-attention", "--device", dev.type,
                *model_args])
            _sync(dev)
            seconds["create_doc_index"] = time.perf_counter() - t0
            index_launches = _read_counts(("flash_self_attention",))
            _reset_counts()
            t0 = time.perf_counter()
            argv = [
                "--task", "OPENQA", "--vocab-file", vocab,
                "--train-data", files["train"],
                "--valid-data", files["valid"],
                "--evidence-data-path", prefix, "--embedding-path", emb,
                "--save", save, "--fid-flash-attention", "--remat",
                "--no-remat-towers", "--async-indexer",
                "--index-reload-interval", "2", "--index-quantize", "int8",
                "--train-iters", str(iters), "--save-interval", "2",
                "--batch-size", str(batch), "--log-interval", "1",
                "--device", dev.type, *model_args]
            rc_run = run_cli.main(argv)
            _sync(dev)
            seconds["run"] = time.perf_counter() - t0
        launches = _read_counts(tuple(_counters()))
        out = "".join(tee.parts)
        if rc_index != 0 or rc_run != 0 or "valid EM" not in out \
                or ckpt.latest_iteration(save) != iters \
                or f"wrote {n_docs} embeddings" not in out:
            raise AssertionError(f"cli: create_doc_index rc {rc_index}, "
                                 f"run rc {rc_run}, latest iteration "
                                 f"{ckpt.latest_iteration(save)}")
        _empty_cache(dev)
        t0 = time.perf_counter()
        run_cfg = run_cli.make_config(run_cli.build_parser().parse_args(argv))
        pipe = QAPipeline.load(save, vocab, prefix, emb, cfg=run_cfg,
                               device=dev, batch_size=batch, kv_quant="int8")
        seconds["load"] = time.perf_counter() - t0
        questions = [f"what is the color of item w{7 * i}"
                     for i in range(n_valid)]
        t0 = time.perf_counter()
        answers = pipe.ask(questions)
        seconds["ask"] = time.perf_counter() - t0
        if len(answers) != n_valid or not all(isinstance(a, str)
                                              for a in answers):
            raise AssertionError(f"cli: QAPipeline.load answers {answers!r}")
        del pipe
    _empty_cache(dev)
    valid = [line.strip() for line in out.splitlines() if "valid EM" in line]
    return dict(seconds=seconds, launches=launches,
                index_launches=index_launches, valid=valid, answers=answers)


def _words(cfg):
    """The synthetic vocabulary's filler words (``make_corpus``)."""
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    base = len(toy_vocab(["what", "is", "the", "color", "of", "item"]))
    return cfg.retriever.encoder.vocab_size - 70 - base


def make_dpr_json(path, n, n_words, rng, offset=0, easy=0, hard=1):
    """``n`` DPR-format examples about item w<7i>: a positive of 90-140
    filler words (a context of about Lc = 256 tokens once formatted), and
    ``hard`` hard and ``easy`` easy negatives likewise."""
    def ctx(i):
        words = " ".join(f"w{j}" for j in rng.randint(
            0, n_words, size=rng.randint(90, 140)))
        return {"title": f"w{i % n_words}", "text": words}

    rows = [{"question": f"what is the color of item w{7 * i}",
             "answers": [f"w{3 * i}"], "positive_ctxs": [ctx(i)],
             "hard_negative_ctxs": [ctx(i + 1) for _ in range(hard)],
             "negative_ctxs": [ctx(i + 2) for _ in range(easy)]}
            for i in range(offset, offset + n)]
    with open(path, "w") as f:
        json.dump(rows, f)
    return path


# the three per-layer checkpoint layouts of a stack
REMAT_LAYOUTS = (("no remat", {"remat": False}),
                 ("nothing", {"remat": True, "remat_policy": "nothing"}),
                 ("dots_no_batch", {"remat": True,
                                    "remat_policy": "dots_no_batch"}))


def dpr_phase(cfg, dev, batch=128, hard_negs=1, steps=3, valid_batches=2,
              valid_batch=16, profile=False):
    """``DPRTask.train_step`` at BERT-base x 2 (``cfg.retriever``), global
    batch ``batch`` with ``hard_negs`` hard negatives (2 x batch contexts),
    Lq 64, Lc 256, dropout 0.1, AdamW 2e-5 / wd 0.1 / clip 1.0, score
    scaling: one warm-up step and ``steps`` timed ones under each layout of
    REMAT_LAYOUTS (ms per step, peak memory, K1 launches during the timed
    steps); then ``validate`` on ``valid_batches`` batches of
    ``valid_batch`` in the 30+30 layout (976 context rows a batch).
    ``profile`` adds one more step of each layout under torch.profiler
    (device time against wall time)."""
    import dataclasses

    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks.dense_retriever import DPRDataset, DPRTask

    res = {"layouts": {}}
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, _ = make_corpus(cfg, tmpdir, n_docs=16)
        rng = np.random.RandomState(SEED)
        n_words = _words(cfg)
        train = make_dpr_json(os.path.join(tmpdir, "train.json"),
                              batch * (steps + 1), n_words, rng,
                              hard=hard_negs)
        valid = make_dpr_json(os.path.join(tmpdir, "valid.json"),
                              valid_batch * valid_batches, n_words, rng,
                              offset=10_000, easy=30, hard=30)
        rc = cfg.retriever
        ds = DPRDataset(train, tok, rc.query_seq_len, rc.seq_len,
                        hard_negs=hard_negs, seed=SEED)
        batches = list(ds.epoch_batches(batch, seed=SEED))
        vds = DPRDataset(valid, tok, rc.query_seq_len, rc.seq_len,
                         evaluate=True)
        vbatches = list(vds.epoch_batches(valid_batch, seed=0,
                                          shuffle=False))
        log(f"dpr set-up {time.perf_counter() - t0:.1f} s: {len(batches)} "
            f"batches of {batch} questions x {1 + hard_negs} contexts "
            f"(Lq {rc.query_seq_len}, Lc {rc.seq_len}), {len(vbatches)} "
            f"validation batches of {vbatches[0].ctx_ids.shape[0]} context "
            f"rows")
    opt = OptimizerConfig(lr=2e-5, weight_decay=0.1, clip_grad=1.0)
    for name, fields in REMAT_LAYOUTS:
        lcfg = dataclasses.replace(rc, encoder=dataclasses.replace(
            rc.encoder, **fields))
        task = DPRTask(lcfg, opt, total_train_iters=1000, score_scaling=True,
                       device=dev)
        state = task.init_state(SEED)
        probe = state.model.retriever.context_model.encoder.layer(
            0).mlp.wi.kernel
        float(task.train_step(batches[0])["loss"])         # warm-up
        _reset_peak(dev)
        _reset_counts()
        runs = []
        for b in batches[1:steps + 1]:
            lr = state.optimizer.schedule(state.optimizer.count)
            before = probe.detach().clone()
            t0 = time.perf_counter()
            m = task.train_step(b)
            row = {k: float(v) for k, v in m.items()}      # syncs the card
            row.update(ms=(time.perf_counter() - t0) * 1e3, lr=lr,
                       moved=not torch.equal(before, probe.detach()))
            runs.append(row)
        launches = _read_counts(("flash_self_attention",
                                 "flash_self_attention_backward")
                                + DA_COUNTED)
        peak = _peak(dev)
        for i, row in enumerate(runs):
            if not (np.isfinite(row["loss"]) and row["grad_norm"] > 0
                    and (row["lr"] == 0 or row["moved"])):
                raise AssertionError(f"dpr {name} step {i}: {row}")
        if not any(r["lr"] > 0 for r in runs):
            raise AssertionError("dpr: no step with a non-zero lr")
        for k, n in launches.items():
            if n <= 0 and dev.type == "cuda":
                raise AssertionError(f"dpr {name}: {k} never launched")
        res["layouts"][name] = dict(steps=runs, peak_bytes=peak,
                                    launches=launches)
        if profile:
            log_profile(f"warm DPR step, {name}", profile_call(
                lambda: float(task.train_step(batches[1])["loss"]),
                f"dpr_step_profile_{name.replace(' ', '_')}.txt"))
        log(f"dpr {name}: ms per step " + ", ".join(
            f"{r['ms']:.1f}" for r in runs) + f"; peak memory "
            f"{peak / 2**30:.2f} GiB; launches during {len(runs)} steps "
            f"{launches}; loss " + ", ".join(f"{r['loss']:.4f}" for r in runs)
            + "; correct " + ", ".join(
                f"{r['correct_prediction_count']:.0f}/{batch}" for r in runs)
            + "; grad_norm " + ", ".join(f"{r['grad_norm']:.4f}"
                                        for r in runs))
        if name == REMAT_LAYOUTS[-1][0]:
            _sync(dev)
            t0 = time.perf_counter()
            v = task.validate(vbatches)
            _sync(dev)
            res["validate"] = dict(metrics=v,
                                   seconds=time.perf_counter() - t0)
            if not all(np.isfinite(x) for x in v.values()):
                raise AssertionError(f"dpr validate: {v}")
            log(f"dpr validate: {len(vbatches)} batches of {valid_batch} x "
                f"{vbatches[0].ctx_ids.shape[0]} context rows in "
                f"{res['validate']['seconds']:.3f} s: " + ", ".join(
                    f"{k} {x:.4f}" for k, x in v.items()))
        del task, state, probe
        _empty_cache(dev)
    return res


def retrieval_eval_phase(cfg, dev, gen, n_docs=16_384, n_rows=N_INDEX,
                         n_questions=3610, k=100):
    """The retrieval evaluation at NQ-test's size: ``EvidenceIndexBuilder``
    embeds ``n_docs`` synthetic passages with a DPR context tower (seeded
    weights), the index is padded with random rows to ``n_rows`` (bf16,
    then int8), and ``OpenRetrievalEvaluator.evaluate_recall`` scores
    ``n_questions`` synthetic questions at ``k``: one search of all of them
    (the tensor-core K3). Prints the search's ms and the evaluation's
    seconds; the retrieved rows must equal an exact search on the card
    (the collision rule; boundary ties counted apart) and the recall dict
    the one computed from the exact rows."""
    import dataclasses
    import functools

    from emdr2_tpu_torch.data.qa_dataset import QAExample
    from emdr2_tpu_torch.models.bert import DualEncoder
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.retrieval.evaluate import OpenRetrievalEvaluator
    from emdr2_tpu_torch.retrieval.qa_validation import (SimpleTokenizer,
                                                         has_answer)
    from emdr2_tpu_torch.tasks.dense_retriever import DPRModel
    from emdr2_tpu_torch.tools import flagship

    res = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        tok, corpus = make_corpus(cfg, tmpdir, n_docs)
        model = DPRModel(cfg.retriever, dev, gen).eval()
        builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                       tok.sep_id, tok.pad_id,
                                       batch_size=128)
        _reset_counts()
        t1 = time.perf_counter()
        rows = builder.embed_corpus()
        _sync(dev)
        res["embed_s"] = time.perf_counter() - t1
        res["embed_launches"] = _read_counts(("flash_self_attention",))
        emb = torch.cat([torch.from_numpy(rows).to(dev).float(),
                         torch.randn(n_rows - n_docs, cfg.index.embed_dim,
                                     device=dev, generator=gen)])
        pids = 1 + np.arange(n_rows) % n_docs
        n_words = _words(cfg)
        examples = [QAExample(i, f"what is the color of item w{7 * i}",
                              [f"w{(3 * i) % n_words} w{i % n_words}",
                               f"w{(5 * i) % n_words}"])
                    for i in range(n_questions)]

        @functools.lru_cache(maxsize=None)
        def doc_text(pid):
            return tok.detokenize(corpus.doc_tokens(int(pid)))

        log(f"retrieval eval set-up {time.perf_counter() - t0:.1f} s: "
            f"{n_docs} passages embedded in {res['embed_s']:.3f} s "
            f"(K1-fwd launches {res['embed_launches']}), index padded with "
            f"random rows to {n_rows}, {n_questions} questions, k={k}")
        for name in ("bf16", "int8"):
            icfg = dataclasses.replace(
                cfg.index, topk=k, dtype=torch.bfloat16,
                quantize="int8" if name == "int8" else "none")
            index = ShardedEvidenceIndex(icfg, emb, passage_ids=pids,
                                         device=dev)
            ev = OpenRetrievalEvaluator(
                model.retriever, index, tok, cfg.retriever.query_seq_len,
                embed_method=DualEncoder.embed_query)
            dump = os.path.join(tmpdir, f"dump_{name}.json")
            _reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            recall = ev.evaluate_recall(examples, k=k, doc_text_fn=doc_text,
                                        dump_path=dump)
            total_s = time.perf_counter() - t0
            launches = _read_counts(("flash_self_attention",
                                     "candidate_scan"))
            launches["candidate_scan_tensor_core"] = \
                mips.candidate_scan.tensor_core_launches
            if dev.type == "cuda" and (
                    launches["candidate_scan_tensor_core"] <= 0
                    or launches["flash_self_attention"] <= 0):
                raise AssertionError(f"retrieval eval {name}: launches "
                                     f"{launches}")
            q = ev.encode_queries([e.question for e in examples])
            search_ms = (flagship.event_ms(lambda: index.search(q, k),
                                           reps=3, warmup=1)
                         if dev.type == "cuda" else float("nan"))
            _, got = index.search(q, k)
            stored = (mips.dequantize_int8(index.embeddings, index.scales,
                                           icfg.group_size)
                      if name == "int8" else index.embeddings.float())
            oracle_vals, oracle = exact_top(
                q, stored, n_rows, k,
                None if name == "int8" else torch.bfloat16)
            del stored
            hit, _ = recall_at(got, oracle[:, :k])
            ex = explain_misses(got, oracle, oracle_vals, k, ties=True)
            # the recall of the exact rows, from the evaluation's own hits
            # where the passage lists agree
            with open(dump) as f:
                hits = [d["hits"] for d in json.load(f)]
            exact_pids = index.lookup_passage_ids(
                oracle[:, :k].cpu().numpy())
            got_pids = index.lookup_passage_ids(got.cpu().numpy())
            tk = SimpleTokenizer()
            top = [0] * k
            differ = 0
            for i, e in enumerate(examples):
                h = hits[i]
                if not np.array_equal(exact_pids[i], got_pids[i]):
                    differ += 1
                    h = [has_answer(e.answers, doc_text(p), tk)
                         for p in exact_pids[i]]
                first = next((j for j, x in enumerate(h) if x), None)
                if first is not None:
                    for j in range(first, k):
                        top[j] += 1
            exact_recall = {key: top[int(key.split("@")[1]) - 1]
                            / n_questions for key in recall}
            res[name] = dict(recall=recall, exact_recall=exact_recall,
                             seconds=total_s, search_ms=search_ms,
                             launches=launches, id_recall=hit,
                             misses=ex["misses"], ties=ex["ties"],
                             tie_eps=ex["tie_eps"], lists_differ=differ)
            log(f"retrieval eval {name}: evaluate_recall over {n_questions} "
                f"questions at k={k} in {total_s:.3f} s; one search of all "
                f"of them {search_ms:.4f} ms; launches {launches}; recall "
                f"{recall}; against an exact search on the card: row recall "
                f"{hit:.6f}, {misses_text(ex, k)}; {differ} questions with "
                f"another passage list; recall of the exact rows "
                f"{exact_recall}")
            if ex["unexplained"] or exact_recall != recall:
                raise AssertionError(f"retrieval eval {name}: "
                                     f"{misses_text(ex, k)}; recall {recall} "
                                     f"against {exact_recall}")
            if name == "bf16":
                # the widest boundary tie with the random rows past the
                # passages drawn from more seeds (the same questions)
                ties = [ex["tie_eps"]]
                pad0 = emb[n_docs:].clone()
                for seed in K3_TIE_SEEDS:
                    del index
                    g = torch.Generator(device=dev)
                    g.manual_seed(seed)
                    emb[n_docs:] = torch.randn(n_rows - n_docs,
                                               cfg.index.embed_dim,
                                               device=dev, generator=g)
                    index = ShardedEvidenceIndex(icfg, emb, passage_ids=pids,
                                                 device=dev)
                    _, got = index.search(q, k)
                    oracle_vals, oracle = exact_top(
                        q, index.embeddings.float(), n_rows, k,
                        torch.bfloat16)
                    sx = explain_misses(got, oracle, oracle_vals, k,
                                        ties=True)
                    log(f"retrieval eval bf16, rows past the passages from "
                        f"seed {seed}: {misses_text(sx, k)}")
                    if sx["unexplained"]:
                        raise AssertionError(f"retrieval eval bf16 seed "
                                             f"{seed}: {misses_text(sx, k)}")
                    ties.append(sx["tie_eps"])
                emb[n_docs:] = pad0
                del pad0
                res[name]["tie_eps_seeds"] = max(ties)
                log(f"retrieval eval bf16: the widest boundary tie over "
                    f"{1 + len(K3_TIE_SEEDS)} seeds {max(ties):.3f} fp32 "
                    f"eps of |k-th score| (TIE_EPS {TIE_EPS})")
            del index, ev, q, got, oracle, oracle_vals
            _empty_cache(dev)
        del emb, model, builder
    _empty_cache(dev)
    return res


def retriever_cli_phase(cfg, dev, n_docs=16_384, batch=16, iters=4,
                        n_dev=64, model_args=()):
    """The RETRIEVER command line on one corpus: ``tasks.run.main`` with
    ``--task RETRIEVER`` for ``iters`` iterations at ``batch``, an interval
    save at 2, validation in the 30+30 layout and the post-train recall on
    ``n_dev`` questions; ``tools.checkpoint_surgery extract --submodel
    retriever`` of the save, loaded by ``load_retriever_params`` into an
    OPENQA model; ``tools.evaluate_retrieval`` on the store the run built,
    whose recall must equal the run's."""
    import contextlib

    from emdr2_tpu_torch.data.tokenizer import build_tokenizers
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.tasks import run as run_cli
    from emdr2_tpu_torch.tasks.openqa_main import padded_vocab_cfg
    from emdr2_tpu_torch.tools import checkpoint_surgery, evaluate_retrieval
    from emdr2_tpu_torch.training import checkpointing as ckpt

    seconds = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        make_corpus(cfg, tmpdir, n_docs)
        vocab = os.path.join(tmpdir, "vocab.txt")
        prefix = os.path.join(tmpdir, "wiki")
        emb = os.path.join(tmpdir, "emb")
        save = os.path.join(tmpdir, "dpr")
        rng = np.random.RandomState(SEED)
        n_words = _words(cfg)
        train = make_dpr_json(os.path.join(tmpdir, "train.json"),
                              batch * iters, n_words, rng)
        valid = make_dpr_json(os.path.join(tmpdir, "valid.json"), batch,
                              n_words, rng, offset=10_000, easy=30, hard=30)
        dev_csv = os.path.join(tmpdir, "dev.csv")
        with open(dev_csv, "w") as f:
            for i in range(n_dev):
                f.write(f"what is the color of item w{7 * i}\t"
                        f"['w{3 * i} w{i}', 'w{5 * i}']\n")
        log(f"retriever cli set-up {time.perf_counter() - t0:.1f} s")
        tee = _Tee(sys.stdout)
        _reset_counts()
        with contextlib.redirect_stdout(tee):
            t0 = time.perf_counter()
            rc = run_cli.main([
                "--task", "RETRIEVER", "--vocab-file", vocab,
                "--train-data", train, "--valid-data", valid,
                "--evidence-data-path", prefix, "--embedding-path", emb,
                "--qa-file-dev", dev_csv, "--save", save,
                "--fid-flash-attention", "--train-iters", str(iters),
                "--epochs", "1", "--save-interval", "2",
                "--batch-size", str(batch), "--log-interval", "1",
                "--device", dev.type, *model_args])
            _sync(dev)
            seconds["run"] = time.perf_counter() - t0
            launches = _read_counts(("flash_self_attention",
                                     "flash_self_attention_backward",
                                     "candidate_scan"))
            out = "".join(tee.parts)
            t0 = time.perf_counter()
            extracted = os.path.join(tmpdir, "extracted")
            rc_ext = checkpoint_surgery.main([
                "extract", "--load", save, "--submodel", "retriever",
                "--save", extracted])
            seconds["extract"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tee.parts.clear()
            rc_eval = evaluate_retrieval.main([
                "--qa-data", dev_csv, "--evidence-data-path", prefix,
                "--embedding-path", emb, "--vocab-file", vocab,
                "--load", extracted, "--fid-flash-attention",
                "--device", dev.type, *model_args])
            _sync(dev)
            seconds["evaluate_retrieval"] = time.perf_counter() - t0
            eval_out = "".join(tee.parts)
        dev_line = [line for line in out.splitlines()
                    if "DEV retrieval" in line]
        eval_line = [line for line in eval_out.splitlines()
                     if line.startswith(dev_csv)]
        if rc != 0 or rc_ext != 0 or rc_eval != 0 \
                or ckpt.latest_iteration(save) != iters \
                or len(dev_line) != 1 or len(eval_line) != 1 \
                or " epoch 0 |" not in out:
            raise AssertionError(f"retriever cli: rc {rc} / {rc_ext} / "
                                 f"{rc_eval}, latest "
                                 f"{ckpt.latest_iteration(save)}, lines "
                                 f"{dev_line} {eval_line}")
        run_recall = {kv.split()[0]: float(kv.split()[1])
                      for kv in dev_line[0].split("|")[1:]}
        tool_recall = {kv.split("=")[0]: float(kv.split("=")[1])
                       for kv in eval_line[0].split()[2:]}
        if run_recall != tool_recall:
            raise AssertionError(f"retriever cli: the run's DEV recall "
                                 f"{run_recall} against evaluate_retrieval's "
                                 f"{tool_recall}")
        for name in ("flash_self_attention",
                     "flash_self_attention_backward", "candidate_scan"):
            if launches[name] <= 0 and dev.type == "cuda":
                raise AssertionError(f"retriever cli: {name} never "
                                     f"launched")
        # the DPR save's retriever into an OPENQA model of the run's flags
        t0 = time.perf_counter()
        bert_tok, t5_tok = build_tokenizers(vocab)
        run_cfg = padded_vocab_cfg(run_cli.make_config(
            run_cli.build_parser().parse_args(
                ["--task", "OPENQA", "--vocab-file", vocab,
                 "--fid-flash-attention", *model_args])), bert_tok, t5_tok)
        model = EMDR2Model(run_cfg, device=dev)
        ckpt.load_retriever_params(extracted, model.retriever)
        seconds["load_into_openqa"] = time.perf_counter() - t0
        saved, _ = ckpt.read_payload(save)
        for key, v in model.retriever.state_dict().items():
            if not torch.equal(v.cpu(), saved["model"]["retriever." + key]):
                raise AssertionError(f"retriever cli: {key} differs after "
                                     f"the extract")
        del model, saved
    _empty_cache(dev)
    log(f"retriever cli: seconds {seconds}; launches {launches}; "
        f"{[line.strip() for line in out.splitlines() if 'epoch' in line]}"
        f"; {dev_line[0].strip()}; evaluate_retrieval: "
        f"{eval_line[0].strip()}")
    return dict(seconds=seconds, launches=launches, recall=run_recall)


# classes of device kernels in a profile, by the first substring of the
# kernel's name that matches (in this order)
# ---------------------------------------------------------------------------
# C5: one step repeats bit for bit; data parallelism (torch.distributed)
# ---------------------------------------------------------------------------

def _dpr_batches(cfg, tmpdir, batch, n_batches, rank=0, world=1,
                 seed=SEED):
    """Global DPR batches of ``batch`` questions with one hard negative
    each (so no negative is drawn at random), this rank's slice of each."""
    from emdr2_tpu_torch.tasks.dense_retriever import DPRDataset
    tmpdir = tempfile.mkdtemp(dir=tmpdir)       # beside another corpus
    tok, _ = make_corpus(cfg, tmpdir, n_docs=16)
    rng = np.random.RandomState(seed)
    path = make_dpr_json(os.path.join(tmpdir, "dpr.json"),
                         batch * n_batches, _words(cfg), rng, hard=1)
    rc = cfg.retriever
    ds = DPRDataset(path, tok, rc.query_seq_len, rc.seq_len, hard_negs=1,
                    seed=seed)
    return list(ds.epoch_batches(batch, seed=seed, rank=rank,
                                 world_size=world))


def _qa_dataset(cfg, tok, tmpdir, n):
    """``n`` questions with one reference each (no answer is drawn at
    random, so a rank's slice samples what one process samples)."""
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    path = os.path.join(tmpdir, f"qa_{n}.tsv")
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"what is the color of item w{7 * i}\t['w{3 * i}']\n")
    return OpenQADataset([path], tok, cfg.retriever.query_seq_len,
                         cfg.reader.decoder_seq_len, seed=SEED)


def _diff_text(result):
    if result["first_difference"] is None:
        return "bit-equal"
    i, a, b = result["first_difference"]
    return (f"{result['differing']} of {result['entries']} entries differ; "
            f"the first at {i}: {a} against {b}")


def c5_phase(cfg, tcfg, dev, gen, dpr_batch=128, qa_batch=8,
             n_rows=N_INDEX, n_docs=20_000):
    """A DPR step (global batch ``dpr_batch``, dropout 0.1) and an OPENQA
    step (``qa_batch``, ``tcfg``: --remat --no-remat-towers) each run twice
    from one saved state (``utils.repeat.repeat_step``: every module
    output, incoming gradient, parameter gradient, metric and updated
    parameter fingerprinted bit for bit). Fails with the first differing
    module. The OPENQA task's first step, before the repeats, is the main
    path's own run of the kernels (``step_kernels``: ``res["kernels"]``):
    each kernel of the step must launch, LN as often each way as
    ``kernel_checks.layer_norm_step_launches`` counts the step's norms."""
    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.tasks.dense_retriever import DPRTask
    from emdr2_tpu_torch.utils.repeat import repeat_step

    res = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        batches = _dpr_batches(cfg, tmpdir, dpr_batch, 2)
    task = DPRTask(cfg.retriever, OptimizerConfig(lr=2e-5), 1000,
                   device=dev)
    task.init_state(SEED)
    task.train_step(batches[0])
    t0 = time.perf_counter()
    r = repeat_step(task, batches[1])
    res["dpr"] = dict(equal=r["equal"], entries=r["entries"],
                      text=_diff_text(r),
                      loss=[float(m["loss"]) for m in r["metrics"]],
                      seconds=time.perf_counter() - t0)
    log(f"c5 DPR step at {dpr_batch}, twice from one state: "
        f"{res['dpr']['text']} over {r['entries']} fingerprints; loss "
        f"{res['dpr']['loss'][0]:.8f} / {res['dpr']['loss'][1]:.8f}")
    del task, batches, r
    _empty_cache(dev)
    with tempfile.TemporaryDirectory() as tmpdir:
        tok, corpus, index = make_world(tcfg, tmpdir, dev, gen, n_docs,
                                        n_rows)
        ds = _qa_dataset(tcfg, tok, tmpdir, 2 * qa_batch)
        task = E2EQATask(tcfg, tok, corpus, index, total_train_iters=1000,
                         device=dev)
        task.init_state(SEED)
        qbatches = list(ds.epoch_batches(qa_batch, seed=SEED))
        res["kernels"] = step_kernels(task, qbatches[0], dev)
        t0 = time.perf_counter()
        r = repeat_step(task, qbatches[1])
        res["openqa"] = dict(equal=r["equal"], entries=r["entries"],
                             text=_diff_text(r),
                             loss=[float(m["loss"]) for m in r["metrics"]],
                             seconds=time.perf_counter() - t0)
        del task, index
    log(f"c5 OPENQA step at B={qa_batch}, twice from one state: "
        f"{res['openqa']['text']} over {res['openqa']['entries']} "
        f"fingerprints; loss {res['openqa']['loss'][0]:.8f} / "
        f"{res['openqa']['loss'][1]:.8f}")
    _empty_cache(dev)
    for name in ("dpr", "openqa"):
        if not res[name]["equal"]:
            raise AssertionError(f"c5: the {name} step does not repeat: "
                                 f"{res[name]['text']}")
    step = res["kernels"]
    for name in ("flash_self_attention", "flash_self_attention_backward",
                 "flash_cross_attention", "flash_cross_attention_backward",
                 "candidate_scan") + DA_COUNTED + LN_COUNTED:
        if step[name]["launches"] <= 0:
            raise AssertionError(f"{name} never launched in the B={qa_batch} "
                                 f"OPENQA step")
    ln = tuple(step[name]["launches"] for name in LN_COUNTED)
    if ln != kernel_checks.layer_norm_step_launches(tcfg):
        raise AssertionError(
            f"LN launched {ln} times in the step, the code counts "
            f"{kernel_checks.layer_norm_step_launches(tcfg)}")
    return res


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_rows(cfg, dev, n_rows, seed):
    """The dp phase's index rows: [n_rows, d] fp32 from ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(n_rows, cfg.index.embed_dim, device=dev, generator=g)


def _dp_cfgs(cfg, rate):
    """(OPENQA under --remat --remat-policy nothing, DPR retriever) at
    dropout ``rate``."""
    from emdr2_tpu_torch.config import with_transformers
    fields = {"hidden_dropout": rate, "attention_dropout": rate,
              "remat": True, "remat_policy": "nothing"}
    qcfg = with_transformers(cfg, fields, fields)
    rc = cfg.retriever
    rcfg = dataclasses.replace(rc, encoder=dataclasses.replace(
        rc.encoder, hidden_dropout=rate, attention_dropout=rate))
    return qcfg, rcfg


def _fingerprint_params(model) -> str:
    from emdr2_tpu_torch.utils.repeat import fingerprint
    return repr([fingerprint(p) for p in model.parameters()])


def _same_or_tie(ids, vals, want_ids, want_vals, k):
    """Rows of each query equal as sets, or traded only at a boundary tie
    (scores within TIE_EPS fp32 eps of |k-th score|); -> (equal share,
    ties, unexplained)."""
    eps = TIE_EPS * float(np.finfo(np.float32).eps)
    equal = ties = bad = 0
    for i in range(ids.shape[0]):
        a, b = set(ids[i].tolist()), set(want_ids[i].tolist())
        if a == b:
            equal += 1
            continue
        kth = abs(float(want_vals[i, k - 1]))
        lo = float(want_vals[i, k - 1]) - eps * max(kth, 1.0)
        va = dict(zip(ids[i].tolist(), vals[i].tolist()))
        vb = dict(zip(want_ids[i].tolist(), want_vals[i].tolist()))
        if all(va[x] >= lo for x in a - b) and all(vb[x] >= lo
                                                   for x in b - a):
            ties += 1
        else:
            bad += 1
    return equal / ids.shape[0], ties, bad


def dp_one_rank_phase(cfg, dev, dpr_batch=128, n_rows=N_INDEX,
                      backend="nccl"):
    """(a) One rank over ``backend`` (NCCL on the card), world size 1,
    rendezvous over TCP on localhost: the DPR step through the
    distributed path (the gathered loss, the bucketed gradient all-reduce)
    against the plain step from the same state, and the sharded search
    (int8, nq 8 and 512) against the plain search: bit for bit."""
    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.parallel import DataParallel
    from emdr2_tpu_torch.parallel import distributed as dist_lib
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks.dense_retriever import DPRTask
    from emdr2_tpu_torch.utils.repeat import first_difference, recorded_step

    dist_lib.init_process_group(f"127.0.0.1:{_free_port()}", 1, 0, backend,
                                timeout_s=120,
                                device=dev if backend == "nccl" else None)
    res = {}
    try:
        dp = DataParallel.from_process_group()
        with tempfile.TemporaryDirectory() as tmpdir:
            batches = _dpr_batches(cfg, tmpdir, dpr_batch, 1)
        opt = OptimizerConfig(lr=2e-5)
        entries = []
        for group in (None, dp):
            task = DPRTask(cfg.retriever, opt, 1000, device=dev, dp=group)
            task.init_state(SEED)
            if group is not None:
                # the counts of the distributed path alone
                _reset_counts()
            _, e = recorded_step(task, batches[0])
            if group is not None:
                launches = _read_counts(tuple(_counters()))
            entries.append(e)
            del task
        diff = first_difference(*entries)
        res["dpr"] = dict(equal=diff is None, entries=len(entries[0]),
                          diff=None if diff is None else repr(diff)[:600])
        _empty_cache(dev)
        icfg = dataclasses.replace(cfg.index, quantize="int8")
        rows = _dp_rows(cfg, dev, n_rows, SEED + 17)
        plain = ShardedEvidenceIndex(icfg, rows, device=dev)
        sharded = ShardedEvidenceIndex(icfg, rows, device=dev, dp=dp)
        del rows
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 18)
        search = {}
        for nq in (8, 512):
            q = torch.randn(nq, cfg.index.embed_dim, device=dev, generator=g)
            want = plain.search(q, k=50)
            _reset_counts()
            got = sharded.search(q, k=50)
            launches_nq = _read_counts(("candidate_scan",))
            search[nq] = dict(equal=bool(torch.equal(got[0], want[0])
                                         and torch.equal(got[1], want[1])),
                              launches=launches_nq["candidate_scan"])
        res["search"] = search
        res["launches"] = launches
        res["bytes_moved"] = dict(dp.bytes_moved)
        del plain, sharded
    finally:
        dist_lib.shutdown()
    _empty_cache(dev)
    log(f"dp (a) one rank over {backend}: DPR step at {dpr_batch} through "
        f"the distributed path against the plain one: "
        f"{'bit-equal' if res['dpr']['equal'] else res['dpr']['diff']} over "
        f"{res['dpr']['entries']} fingerprints; sharded int8 search nq 8 / "
        f"512: " + ", ".join(f"{'bit-equal' if s['equal'] else 'DIFFERS'} "
                             f"({s['launches']} K3 launches)"
                             for s in search.values())
        + f"; launches {res['launches']}; bytes moved "
        f"{res['bytes_moved']}")
    if not res["dpr"]["equal"] or not all(s["equal"] for s in
                                          search.values()):
        raise AssertionError("dp (a): the one-rank distributed path is not "
                             "bit-equal to the plain path")
    return res


# the ranks phase: two ranks sharing the card (global batches DP_SIZES: 2
# / 64 / 4 a rank), or --dp-cards N ranks on cards of their own
# (DP_CARD_SIZES a rank, timed against one card at the same batch; the
# checks at DP_CARD_CHECK_SIZES a rank, against one card at their global
# batch, which fits on it)
DP_WORLD = 2
DP_SIZES = {"qa": 4, "dpr": 128, "eval": 8}
DP_CARD_SIZES = {"qa": 8, "dpr": 128, "eval": 8}
DP_CARD_CHECK_SIZES = {"qa": 2, "dpr": 32}
DP_QA_STEPS = 3
DP_CHECK_STEPS = 2
DP_EVAL_QUESTIONS = 16
DP_SEARCH_NQ = (8, 512)
DP_LOSS_RTOL = 1e-2
# the global gradient norm of a check step against one process: a sum in
# place of the mean over the ranks, or a share not scaled to the global
# batch, moves it by a factor of the world size (>= 50 times this limit)
DP_GRAD_RTOL = 1e-2


def _dp_world(cfg, tmpdir, dev, n_rows, n_docs, dp=None):
    """Tokenizer, corpus and the dp phase's index (every rank holds its
    block of the same rows)."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    tok, corpus = make_corpus(cfg, tmpdir, n_docs)
    rows = _dp_rows(cfg, dev, n_rows, SEED + 19)
    pids = 1 + np.arange(n_rows) % n_docs
    index = ShardedEvidenceIndex(cfg.index, rows, passage_ids=pids,
                                 device=dev, dp=dp)
    del rows
    return tok, corpus, index


def _dp_searches(cfg, dev, n_rows, dp=None):
    """Per dtype and nq: this rank's (vals, ids) of the dp phase's
    queries (every rank holds its block of one index)."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    rank, world = (dp.rank, dp.world_size) if dp is not None else (0, 1)
    out = {}
    rows = _dp_rows(cfg, dev, n_rows, SEED + 17)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 18)
    queries = {nq: torch.randn(nq, cfg.index.embed_dim, device=dev,
                               generator=g)
               for nq in DP_SEARCH_NQ}
    for quant in ("none", "int8"):
        index = ShardedEvidenceIndex(
            dataclasses.replace(cfg.index, quantize=quant), rows,
            device=dev, dp=dp)
        for nq, q in queries.items():
            per = nq // world
            vals, ids = index.search(q[rank * per:(rank + 1) * per], k=50)
            out[f"{quant}_{nq}"] = (vals.cpu().numpy(), ids.cpu().numpy())
        del index
    del rows
    return out


def _dp_runs(cfg, dev, tmpdir, n_rows, n_docs, n_questions, dp=None,
             sizes=DP_SIZES, checks=DP_SIZES, eval_batch=None, dpr=True):
    """What the ranks phase runs, on one rank of ``dp`` (or in one process):
    the searches; ``evaluate_em`` of the initial state, greedy over int8
    K/V, at the global batch ``eval_batch`` (default ``sizes["eval"]``);
    ``DP_CHECK_STEPS`` OPENQA and DPR steps at dropout 0 at the global
    batches ``checks`` (each step's loss and global gradient norm; the
    learning rate has no warmup, so the second step follows an update);
    ``DP_QA_STEPS`` OPENQA and DPR steps at dropout 0.1 at the global
    batches ``sizes`` (their times, and the parameters' fingerprints).
    The training questions are ``n_questions`` (one set for the ranks and
    for one process: the shuffled order depends on it). ``dpr=False``
    leaves out the DPR steps. Returns the results and the stage times."""
    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.tasks.dense_retriever import DPRTask
    from emdr2_tpu_torch.tasks import e2eqa
    from emdr2_tpu_torch.utils.timing import StageTimer

    rank, world = (dp.rank, dp.world_size) if dp is not None else (0, 1)
    ranks = {"rank": rank, "world_size": world}
    out = {"ms": {}}
    out["search"] = _dp_searches(cfg, dev, n_rows, dp)
    _empty_cache(dev)
    tok, corpus, index = _dp_world(cfg, tmpdir, dev, n_rows, n_docs, dp)
    ds = _qa_dataset(cfg, tok, tmpdir, n_questions)
    opt = OptimizerConfig(lr=2e-5, weight_decay=0.1, clip_grad=1.0,
                          warmup=0.0)

    def run_steps(name, task, batches):
        losses, norms, ms = [], [], []
        _reset_peak(dev)
        for batch in batches:
            _sync(dev)
            t0 = time.perf_counter()
            m = task.train_step(batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        out[name] = dict(loss=losses, grad_norm=norms, ms=ms,
                         peak=_peak(dev), stage_ms=dict(task.timer.ms))

    for rate in (0.0, 0.1):
        qcfg, _ = _dp_cfgs(cfg, rate)
        bs = checks["qa"] if rate == 0.0 else sizes["qa"]
        qcfg = qcfg.replace(train=dataclasses.replace(
            qcfg.train, batch_size=bs, optimizer=opt))
        task = E2EQATask(qcfg, tok, corpus, index, total_train_iters=1000,
                         device=dev, dp=dp, timer=StageTimer(dev))
        task.init_state(SEED)
        if rate == 0.0:
            rec = []
            metric = e2eqa.metric_max_over_ground_truths

            def recording(m, text, refs):
                rec.append(text)
                return metric(m, text, refs)

            e2eqa.metric_max_over_ground_truths = recording
            try:
                t0 = time.perf_counter()
                em = task.evaluate_em(
                    _qa_dataset(cfg, tok, tmpdir, DP_EVAL_QUESTIONS),
                    batch_size=eval_batch or sizes["eval"], kv_quant="int8")
                out["ms"]["evaluate_em"] = (time.perf_counter() - t0) * 1e3
            finally:
                e2eqa.metric_max_over_ground_truths = metric
            out["em"] = dict(em=em, texts=rec)
        steps = DP_CHECK_STEPS if rate == 0.0 else DP_QA_STEPS
        run_steps(f"openqa_{rate}", task,
                  list(ds.epoch_batches(bs, seed=SEED, **ranks))[:steps])
        if rate > 0:
            out["openqa_params"] = _fingerprint_params(task.state.model)
        del task
        _empty_cache(dev)
    del index
    _empty_cache(dev)
    for rate in (0.0, 0.1) if dpr else ():
        _, rcfg = _dp_cfgs(cfg, rate)
        bs = checks["dpr"] if rate == 0.0 else sizes["dpr"]
        steps = DP_CHECK_STEPS if rate == 0.0 else DP_QA_STEPS
        task = DPRTask(rcfg, opt, 1000, device=dev, dp=dp,
                       timer=StageTimer(dev))
        task.init_state(SEED)
        run_steps(f"dpr_{rate}", task, _dpr_batches(
            cfg, tmpdir, bs, steps, rank=rank, world=world))
        if rate > 0:
            out["dpr_params"] = _fingerprint_params(task.state.model)
        del task
        _empty_cache(dev)
    return out


def _stages_text(stage_ms) -> str:
    return ", ".join(f"{k} " + "/".join(f"{m:.1f}" for m in v)
                     for k, v in stage_ms.items())


def dp_rank_main(spec_path: str, rank: int) -> int:
    """One rank of the ranks phase (``chip_smoke.py --dp-rank R --dp-spec
    PATH``) on the spec's device for it, over the spec's backend; a rank
    of an emulated host (``kind`` "hosts") joins by torchrun's variables
    instead (``parallel.init_distributed``), on the card of its local rank
    among the cards its host sees."""
    from emdr2_tpu_torch.ops import build
    from emdr2_tpu_torch.parallel import DataParallel, rank_device
    from emdr2_tpu_torch.parallel import distributed as dist_lib
    with open(spec_path) as f:
        spec = json.load(f)
    layout = None
    if spec.get("kind") == "hosts":
        layout = dist_lib.init_distributed(
            device=spec["device"], backend=spec["backend"],
            timeout_s=spec["timeout"])
        dev = rank_device(spec["device"], layout)
    else:
        dev = torch.device(spec["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load()
    cfg = torch.load(spec["cfg"], weights_only=False)
    if layout is None:
        dist_lib.init_process_group(spec["address"], spec["world"], rank,
                                    spec["backend"],
                                    timeout_s=spec["timeout"], device=dev)
    try:
        dp = DataParallel.from_process_group(tp=spec.get("tp", 1))
        _reset_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmpdir:
            if spec.get("kind") == "embedder" or spec.get("mode") == \
                    "embedder":
                out = _embedder_run(cfg, dev, tmpdir, spec, dp, layout)
            elif spec.get("kind") == "tp":
                out = _tp_runs(cfg, dev, tmpdir, spec["sizes"],
                               spec["n_questions"], dp)
                out["launches"] = _read_counts(tuple(_counters()))
                out["dp_rank"], out["tp_rank"] = dp.rank, dp.tp.rank
            else:
                out = _dp_runs(cfg, dev, tmpdir, spec["n_rows"],
                               spec["n_docs"], spec["n_questions"], dp,
                               spec["sizes"], spec["checks"],
                               dpr=spec.get("dpr", True))
                out["launches"] = _read_counts(tuple(_counters()))
                for key, v in out["search"].items():
                    out["search"][key] = (v[0].tolist(), v[1].tolist())
            if layout is not None:
                out["host"] = _host_cards(layout, dev, spec)
        out["seconds"] = time.perf_counter() - t0
        out["bytes_moved"] = dict(dp.bytes_moved)
        with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist_lib.shutdown()
    return 0


def _run_ranks(cfg, what: str, timeout: float, spec: dict,
               envs=None) -> list:
    """Run the ranks of ``spec`` (its ``devices``, ``world`` and
    ``backend``; ``kind`` "dp", "embedder", "tp" or "hosts") as
    subprocesses of this script (``--dp-rank R --dp-spec PATH``), rank r
    with the variables ``envs[r]`` added to this process's, with
    ``timeout``, every one killed on the way out; -> each rank's results,
    by rank."""
    world = spec["world"]
    envs = envs or [{}] * world
    with tempfile.TemporaryDirectory() as tmpdir:
        torch.save(cfg, os.path.join(tmpdir, "cfg.pt"))
        spec = dict(spec, cfg=os.path.join(tmpdir, "cfg.pt"), out=tmpdir,
                    timeout=timeout / 2,
                    address=f"file://{os.path.join(tmpdir, 'store')}")
        path = os.path.join(tmpdir, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--dp-rank", str(r), "--dp-spec", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, **envs[r])) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"{what} rank {r} failed "
                                     f"(rc {p.returncode}):\n{text[-6000:]}")
        got = []
        for r in range(world):
            with open(os.path.join(tmpdir, f"rank{r}.json")) as f:
                got.append(json.load(f))
    return got


def dp_ranks_phase(cfg, dev, n_rows=N_INDEX, n_docs=20_000, timeout=900,
                   world=DP_WORLD, cards=False):
    """The ranks as subprocesses of this script with a timeout, each with
    its block of the same index, against one process. (b)
    ``cards=False``: two ranks sharing ``dev`` over gloo, at the global
    batches ``DP_SIZES``, against one process at them. ``cards=True``
    (``--dp-cards N``): ``world`` ranks over NCCL, rank r on card r, at
    ``DP_CARD_SIZES`` a rank, timed against one card at those sizes, with
    the check steps at ``DP_CARD_CHECK_SIZES`` a rank. Held in both: the
    searches (bf16 and int8, nq 8 and 512) give one process's rows under
    the recall rule; the losses of the two check steps at dropout 0
    (OPENQA at 2 a rank, DPR at 64 a rank in (b)) lie within
    ``DP_LOSS_RTOL`` of one process at the global batch, their global
    gradient norms within ``DP_GRAD_RTOL``; at dropout 0.1 the ranks'
    parameters are bit-equal after 3 steps; ``evaluate_em`` over 16
    questions, greedy over int8 K/V (K5), generates one process's texts
    (one process at the batch of a rank: the same rows a batch) and its
    EM."""
    what = (f"(cards: {world} over "
            f"{'NCCL' if dev.type == 'cuda' else 'gloo'})" if cards
            else "(b)")
    per_rank = DP_CARD_SIZES if cards else {
        k: v // world for k, v in DP_SIZES.items()}
    sizes = {k: v * world for k, v in per_rank.items()}
    checks_at = ({k: v * world for k, v in DP_CARD_CHECK_SIZES.items()}
                 if cards else sizes)
    n_questions = max(DP_EVAL_QUESTIONS, sizes["qa"] * DP_QA_STEPS,
                      checks_at["qa"] * DP_CHECK_STEPS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        ref = _dp_runs(cfg, dev, tmpdir, n_rows, n_docs, n_questions,
                       sizes=per_rank if cards else sizes, checks=checks_at,
                       eval_batch=per_rank["eval"])
    ref_s = time.perf_counter() - t0
    _empty_cache(dev)
    # one card each over NCCL; on the CPU (a rehearsal) gloo
    own = cards and dev.type == "cuda"
    t0 = time.perf_counter()
    got = _run_ranks(cfg, f"dp {what}", timeout, {
        "devices": ([f"cuda:{r}" for r in range(world)] if own
                    else [str(dev)] * world),
        "world": world, "backend": "nccl" if own else "gloo",
        "sizes": sizes, "checks": checks_at, "n_questions": n_questions,
        "n_rows": n_rows, "n_docs": n_docs})
    ranks_s = time.perf_counter() - t0
    res = {"ref_seconds": ref_s, "ranks_seconds": ranks_s, "ranks": got,
           "ref": ref, "plan": {"per_rank": per_rank, "sizes": sizes,
                                "checks": checks_at,
                                "n_questions": n_questions,
                                "n_rows": n_rows, "n_docs": n_docs}}
    search, checks, limits, failures = _dp_checks(
        ref, got, world, per_rank["eval"], sizes["eval"], ("openqa", "dpr"))
    res["search"], res["checks"] = search, checks
    res["launches"] = {k: sum(g["launches"][k] for g in got)
                       for k in got[0]["launches"]}
    for r, g in enumerate(got):
        log(f"dp {what} rank {r}: OPENQA step ms at dropout 0.1 "
            + ", ".join(f"{m:.1f}" for m in g["openqa_0.1"]["ms"])
            + f" (peak {g['openqa_0.1']['peak'] / 2**30:.2f} GiB); DPR "
            "step ms " + ", ".join(f"{m:.1f}" for m in g["dpr_0.1"]["ms"])
            + f" (peak {g['dpr_0.1']['peak'] / 2**30:.2f} GiB); stages "
            f"(the optimizer's holds the gradient all-reduce): OPENQA "
            + _stages_text(g["openqa_0.1"]["stage_ms"]) + "; DPR "
            + _stages_text(g["dpr_0.1"]["stage_ms"]) + "; "
            f"evaluate_em {g['ms']['evaluate_em']:.1f} ms; bytes moved "
            f"{g['bytes_moved']}; {g['seconds']:.1f} s; launches "
            f"{g['launches']}")
    ref_sizes = per_rank if cards else sizes
    log(f"dp {what} one process (references, {ref_s:.1f} s): OPENQA B="
        f"{ref_sizes['qa']} step ms {ref['openqa_0.1']['ms']} peak "
        f"{ref['openqa_0.1']['peak'] / 2**30:.2f} GiB ("
        + _stages_text(ref["openqa_0.1"]["stage_ms"]) + f"); DPR "
        f"{ref_sizes['dpr']} step ms {ref['dpr_0.1']['ms']} peak "
        f"{ref['dpr_0.1']['peak'] / 2**30:.2f} GiB ("
        + _stages_text(ref["dpr_0.1"]["stage_ms"]) + "); evaluate_em "
        f"{ref['ms']['evaluate_em']:.1f} ms")
    log(f"dp {what} {world} ranks ({ranks_s:.1f} s): "
        f"searches {search}; the {DP_CHECK_STEPS} check steps at dropout "
        f"0 (global batches {checks_at}) relative to one process: "
        + ", ".join(f"{k} {checks[k]:.3e}" for k in limits)
        + f" (limits: loss {DP_LOSS_RTOL}, grad_norm {DP_GRAD_RTOL}); "
        f"values one process / rank 0: " + ", ".join(
            f"{name}_{key} {ref[f'{name}_0.0'][key]} / "
            f"{got[0][f'{name}_0.0'][key]}" for name in ("openqa", "dpr")
            for key in ("loss", "grad_norm"))
        + f"; replicas bit-equal after {DP_QA_STEPS} steps at dropout "
        f"0.1: OPENQA {checks['openqa_replicas_equal']}, DPR "
        f"{checks['dpr_replicas_equal']}; EM one process / ranks "
        f"{checks['em']}; generated texts equal to one process's "
        f"{checks['texts_equal_share']:.4f}")
    if failures:
        raise AssertionError(f"dp {what} failed: {failures}")
    return res


def _dp_checks(ref, got, world, per_eval, global_eval, names):
    """The ranks' results ``got`` held to one process's ``ref`` by the dp
    phase's rules: each search's rows those of one process under the
    recall rule (``TIE_EPS``); for each of ``names`` ("openqa", "dpr") the
    losses and global gradient norms of the check steps at dropout 0
    within ``DP_LOSS_RTOL`` / ``DP_GRAD_RTOL``, the replicas bit-equal
    after the steps at dropout 0.1; ``evaluate_em``'s texts (``per_eval``
    rows a rank of every global batch of ``global_eval``) and EM those of
    one process. -> (search, checks, limits, failures)."""
    search = {}
    for key, (want_vals, want_ids) in ref["search"].items():
        nq = want_ids.shape[0]
        assert nq % world == 0
        ids = np.concatenate([np.asarray(g["search"][key][1]) for g in got])
        vals = np.concatenate([np.asarray(g["search"][key][0])
                               for g in got])
        share, ties, bad = _same_or_tie(ids, vals, want_ids, want_vals, 50)
        search[key] = dict(equal_share=share, ties=ties, unexplained=bad,
                           exact=bool(np.array_equal(ids, want_ids)))
    checks = {}
    limits = {}
    for name in names:
        for key, limit in (("loss", DP_LOSS_RTOL),
                           ("grad_norm", DP_GRAD_RTOL)):
            for step in range(DP_CHECK_STEPS):
                want = ref[f"{name}_0.0"][key][step]
                rel = max(abs(g[f"{name}_0.0"][key][step] - want)
                          / abs(want) for g in got)
                checks[f"{name}_{key}_{step + 1}_rel"] = rel
                limits[f"{name}_{key}_{step + 1}_rel"] = limit
        checks[f"{name}_replicas_equal"] = all(
            g[f"{name}_params"] == got[0][f"{name}_params"] for g in got)
    checks["em"] = (list(ref["em"]["em"]), [list(g["em"]["em"])
                                            for g in got])
    texts = []
    for i in range(-(-DP_EVAL_QUESTIONS // global_eval)):
        for g in got:
            texts += g["em"]["texts"][i * per_eval:(i + 1) * per_eval]
    want_texts = dict(zip(range(DP_EVAL_QUESTIONS), ref["em"]["texts"]))
    checks["texts_equal_share"] = (
        sum(t == want_texts.get(i) for i, t in
            enumerate(texts[:DP_EVAL_QUESTIONS])) / DP_EVAL_QUESTIONS)
    failures = [k for k, s in search.items() if s["unexplained"]]
    failures += [k for k, limit in limits.items() if not checks[k] <= limit]
    failures += [k for k in [f"{n}_replicas_equal" for n in names]
                 + ["texts_equal_share"] if checks[k] != 1]
    if any(e != checks["em"][0] for e in checks["em"][1]):
        failures.append("em")
    return search, checks, limits, failures


# the embedder phase: every rank trains under the flagship recipe's
# asynchronous refresher and prefetch at depth 1, its embedder on its own
# card (EMB_SHARED: two ranks sharing the card over gloo, embed-devices 0)
# or on a card of its own (EMB_CARDS, ``--dp-cards``: two trainers over
# NCCL beside two embedder cards); sizes a rank
EMB_WORLD = 2
EMB_SHARED = {"docs": 16_384, "qa": 2, "iters": 6, "plain_iters": 1}
EMB_CARDS = {"docs": 32_768, "qa": 8, "iters": 8, "plain_iters": 3}
EMB_RELOAD = 2
EMB_CHECK_ROWS = 64
EMB_BUILDER_SHAPE = (128, 256)      # K1's batch of passages in the builder
EMB_SWAP_REPS = 3


def _embedder_run(cfg, dev, tmpdir, spec, dp, layout=None):
    """One rank of the embedder phase: ``engine.train`` over an int8 index
    of ``sizes["docs"]`` passages (this rank holding its block) with an
    ``AsyncIndexRefresher`` (reload interval ``EMB_RELOAD``) whose builder
    runs on the rank's embedder devices (``parallel.embed_devices``),
    ``prefetch_depth=1``, ``iters`` iterations at ``sizes["qa"]`` questions
    a rank; then ``plain_iters`` more without the refresher (``layout``:
    the rank's ``HostLayout`` in a launch across hosts, whose embedder
    cards are its own host's). Records each
    iteration's ms and whether an embed pass overlapped it by half, each
    pass's window, each ``maybe_swap`` that swapped (iteration, ms of the
    trainer thread's stall: the agreement all-reduce and the swap, the
    card synchronized on both sides), the launches (counts set to 0 just
    before the refreshed run and read just after; K1's by card at the
    builder's shape), peak memory per device, and after the first swap
    ``EMB_CHECK_ROWS`` of the rank's rows against a copy of the tower
    taken at the hand-off. Last, the swap of a block of ``swap_rows`` /
    W int8 rows made and quantized on the embedder's device, timed
    ``EMB_SWAP_REPS`` times, and held bit for bit to the rows moved first
    and quantized on the trainer's device."""
    import copy
    import threading

    from emdr2_tpu_torch.config import MeshConfig
    from emdr2_tpu_torch.ops import fid_attention as fa
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.parallel import check_mesh_config, embed_devices
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import (EvidenceIndexBuilder,
                                                   context_tower)
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import engine
    from emdr2_tpu_torch.training.step import METRICS
    from emdr2_tpu_torch.training.async_refresh import AsyncIndexRefresher

    cuda = dev.type == "cuda"
    mesh = MeshConfig(dp=dp.world_size, embed_devices=spec["embed_devices"])
    check_mesh_config(mesh, dp.world_size,
                      torch.cuda.device_count() if cuda else None,
                      layout=layout)
    edevs = embed_devices(mesh, dp.rank, dev, layout)
    edev = edevs[0]
    devices = [dev] + [d for d in edevs if d != dev]
    sizes = spec["sizes"]
    n_docs, batch = sizes["docs"], sizes["qa"] * dp.world_size
    iters, plain_iters = sizes["iters"], sizes["plain_iters"]

    def sync():
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)

    def sync_trainer():
        # the trainer's stream alone: the embedder's keeps running (a
        # copy from its card is on a stream the trainer's waits for)
        if cuda:
            torch.cuda.current_stream(dev).synchronize()

    def loop_cfg(train_iters):
        return cfg.replace(train=dataclasses.replace(
            cfg.train, batch_size=batch, train_iters=train_iters,
            log_interval=1, save_interval=10 ** 6, eval_interval=10 ** 6,
            index_reload_interval=EMB_RELOAD, seed=SEED))

    tok, corpus = make_corpus(cfg, tmpdir, n_docs)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 23)
    index = ShardedEvidenceIndex(
        cfg.index, torch.randn(n_docs, cfg.index.embed_dim, device=dev,
                               generator=g), device=dev, dp=dp)
    ds = _qa_dataset(cfg, tok, tmpdir, batch * (iters + plain_iters + 2))
    task = E2EQATask(loop_cfg(iters), tok, corpus, index,
                     total_train_iters=1000, device=dev, dp=dp)
    model = task.init_state(SEED).model
    start_weights = {k: v.detach().to("cpu", copy=True) for k, v in
                     context_tower(model).state_dict().items()}
    builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                   tok.sep_id, tok.pad_id, devices=edevs)
    lo, hi = index.process_row_range()
    real = max(0, min(hi, n_docs) - lo)
    scans = index.shard_rows > cfg.index.chunk_rows
    check_rows = np.sort(np.random.RandomState(SEED + 1 + dp.rank).choice(
        real, EMB_CHECK_ROWS, replace=False))
    first = {}

    def on_refresh(step):
        if not first:
            rows = mips.dequantize_int8(index.embeddings, index.scales,
                                        cfg.index.group_size)
            first.update(step=step, rows=rows[check_rows].cpu(),
                         scales=index.scales[
                             check_rows // cfg.index.group_size].cpu())

    refresher = AsyncIndexRefresher(builder, index, EMB_RELOAD,
                                    on_refresh=on_refresh,
                                    zero_copy=spec["embed_devices"] > 0)
    passes, swaps, agree_ms, ends = [], [], [], []
    for name in ("embed_corpus", "embed_corpus_device"):
        def timed(*args, _fn=getattr(builder, name), **kw):
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            if isinstance(out, torch.Tensor) and out.is_cuda:
                # the rows are queued on this thread's stream: the pass
                # ends when they are written
                torch.cuda.current_stream(out.device).synchronize()
            passes.append((t0, time.perf_counter()))
            return out
        setattr(builder, name, timed)
    maybe_swap = refresher.maybe_swap

    def timed_swap(step, model):
        boundary = step - refresher._last_reload_step >= EMB_RELOAD
        if boundary:
            sync_trainer()
        t0 = time.perf_counter()
        swapped = maybe_swap(step, model)
        if boundary:
            sync_trainer()
            ms = (time.perf_counter() - t0) * 1e3
            (swaps.append((step, ms)) if swapped else agree_ms.append(ms))
        return swapped

    refresher.maybe_swap = timed_swap

    def printer(line):
        if "ms_per_iter" in line:
            ends.append(time.perf_counter())

    for d in devices:
        _reset_peak(d)
    _reset_counts()
    train_log = engine.TrainLog(1, printer)
    t_start = time.perf_counter()
    final = engine.train(task, ds, loop_cfg(iters), refresher=refresher,
                         prefetch_depth=1, dp=dp, printer=printer,
                         log=train_log)
    sync()
    train_s = time.perf_counter() - t_start
    launches = _read_counts(tuple(_counters()))
    by_shape = dict(fa.flash_self_attention.launches_by_shape)
    peaks = {str(d): _peak(d) for d in devices}
    alive = [t.name for t in threading.enumerate() if t.name.startswith(
        ("index-refresh", "batch-prefetch"))]
    history = train_log.history
    if final != iters or len(history) != iters or alive:
        raise AssertionError(f"embedder run ended at {final}, history "
                             f"{history}, threads left {alive}")
    if refresher.error is not None or not first:
        raise AssertionError(f"refresh_count {refresher.refresh_count}, "
                             f"swaps {swaps}, error {refresher.error!r}")
    starts = [t_start] + ends[:-1]
    busy = [sum(max(0.0, min(e, pe) - max(s, ps)) for ps, pe in passes)
            >= 0.5 * (e - s) for s, e in zip(starts, ends)]
    plain_log = engine.TrainLog(1, lambda line: None)
    engine.train(task, ds, loop_cfg(iters + plain_iters), prefetch_depth=1,
                 dp=dp, printer=lambda line: None, log=plain_log)
    sync()
    fingerprint = _fingerprint_params(task.state.model)

    # the first swapped block against the tower handed over at start
    tower = copy.deepcopy(context_tower(model)).requires_grad_(False)
    tower.load_state_dict(start_weights)
    tower = tower.to(edev)
    ids, types = builder._format_rows(check_rows + lo + 1)
    with torch.inference_mode():
        want = tower.embed(torch.as_tensor(ids).long().to(edev),
                           torch.as_tensor(types).long().to(edev)
                           ).float().cpu()
    err = (first["rows"] - want).abs()
    limit = first["scales"][:, None] + FWD_TOL[0] * want.abs().max()
    check = dict(err=err.max().item(),
                 steps=(err / first["scales"][:, None]).max().item(),
                 ok=bool((err <= limit).all()))
    losses_finite = all(np.isfinite(h[k]) for h in history
                        + plain_log.history for k in METRICS)
    del tower, want, task, model, builder, refresher, index
    for d in devices:
        _empty_cache(d)

    # a block of a full shard's rows, made and quantized where the
    # embedder runs, swapped in card to card
    block_ms, block_equal = [], True
    n_rows = spec["swap_rows"]
    icfg = dataclasses.replace(cfg.index, quantize="int8")
    index = ShardedEvidenceIndex(
        icfg, torch.zeros(n_rows // dp.world_size, icfg.embed_dim,
                          device=dev), device=dev, dp=dp, local=True,
        n_real=n_rows)
    g = torch.Generator(device=edev)
    g.manual_seed(SEED + 29 + dp.rank)
    for _ in range(EMB_SWAP_REPS):
        rows = torch.randn(index.shard_rows, icfg.embed_dim, device=edev,
                           generator=g).to(icfg.dtype)
        block = index.local_block(rows)
        ready = torch.cuda.Event() if cuda else None
        if cuda:
            ready.record(torch.cuda.current_stream(edev))
        sync()
        t0 = time.perf_counter()
        index.update_from_process_local(block, ready=ready)
        sync()
        block_ms.append((time.perf_counter() - t0) * 1e3)
        want_rows, want_scales = index.local_block(rows.to(dev))
        block_equal &= bool(torch.equal(index.embeddings, want_rows)
                            and torch.equal(index.scales, want_scales))
        del rows, block, want_rows, want_scales
    del index
    for d in devices:
        _empty_cache(d)
    pass_s = [pe - ps for ps, pe in passes]
    return dict(
        devices=[str(d) for d in devices], embedder=[str(d) for d in edevs],
        ms=[h["ms_per_iter"] for h in history],
        with_embed=[h["ms_per_iter"] for h, b in zip(history, busy) if b],
        without=[h["ms_per_iter"] for h, b in zip(history, busy) if not b],
        plain=[h["ms_per_iter"] for h in plain_log.history],
        pass_s=pass_s, per_s=[real / s for s in pass_s], block_rows=real,
        swaps=swaps, agree_ms=agree_ms, first_step=first["step"],
        refresh_count=len(swaps), check=check, scans=scans,
        losses_finite=losses_finite, fingerprint=fingerprint,
        launches=launches,
        builder_launches={dev_name: n for (dev_name, B, L), n in
                          by_shape.items() if (B, L) == EMB_BUILDER_SHAPE},
        peaks=peaks, train_s=train_s, block_ms=block_ms,
        block_equal=block_equal, block_shard_rows=n_rows // dp.world_size)


def embedder_phase(cfg, dev, cards=False, timeout=900, sizes=None):
    """Two ranks with their embedders (``_embedder_run``) as subprocesses.
    ``cards=False``: sharing ``dev`` over gloo, ``--embed-devices 0``, at
    ``EMB_SHARED``. ``cards=True`` (``--dp-cards``): trainers on cards 0-1
    over NCCL, their embedders on cards 2-3 (``--embed-devices 2``), at
    ``EMB_CARDS``; on the CPU a rehearsal of the same layout over gloo.
    Held: the ranks swap at the same iterations, at least once; after the
    first swap each rank's sampled rows equal the hand-off tower's
    embedding within one int8 step of their group plus the bf16 forward
    tolerance (``refresh_phase``'s rule); the replicas are bit-equal after
    the runs; the losses finite; K1, K2 and K3 launched; the block swapped
    card to card bit-equal to the one quantized on the trainer's card;
    with cards, no K1 launch at the builder's shape on a trainer card.
    ``sizes`` replaces the sizes a rank (a rehearsal on the CPU)."""
    on_cards = cards and dev.type == "cuda"
    sizes = sizes or (EMB_CARDS if cards else EMB_SHARED)
    what = (f"embedder (cards: {EMB_WORLD} trainers over "
            f"{'NCCL' if on_cards else 'gloo'} beside {EMB_WORLD} "
            f"embedders)" if cards else "embedder (shared card, gloo)")
    t0 = time.perf_counter()
    got = _run_ranks(cfg, what, timeout, {
        "kind": "embedder",
        "devices": ([f"cuda:{r}" for r in range(EMB_WORLD)] if on_cards
                    else [str(dev)] * EMB_WORLD),
        "world": EMB_WORLD, "backend": "nccl" if on_cards else "gloo",
        "embed_devices": EMB_WORLD if cards else 0, "sizes": sizes,
        "swap_rows": N_INDEX if dev.type == "cuda" else 4096})
    seconds = time.perf_counter() - t0
    failures, launches, steps = _embedder_checks(what, got, dev, on_cards)
    log(f"{what}: {seconds:.1f} s; swap iterations {steps}")
    if failures:
        raise AssertionError(f"{what} failed: {failures}")
    return dict(ranks=got, launches=launches, seconds=seconds)


def _embedder_checks(what, got, dev, on_cards):
    """Log each rank of the embedder phase and hold them to its rules
    (``embedder_phase``) -> (failures, launches summed over the ranks,
    each rank's swap iterations)."""
    for r, g in enumerate(got):
        log(f"{what} rank {r} on {g['devices']} (embedder {g['embedder']}):"
            f" ms per iteration with an embed pass in flight "
            + ", ".join(f"{m:.1f}" for m in g["with_embed"]) + "; without "
            + ", ".join(f"{m:.1f}" for m in g["without"])
            + "; with no refresher " + ", ".join(f"{m:.1f}"
                                                 for m in g["plain"])
            + f"; passes of {g['block_rows']} passages: "
            + ", ".join(f"{s:.3f} s ({p:.1f} passages/s)"
                        for s, p in zip(g["pass_s"], g["per_s"]))
            + "; swaps (iteration, ms of the stall) "
            + ", ".join(f"({i}, {ms:.1f})" for i, ms in g["swaps"])
            + "; agreements that did not swap (ms) "
            + ", ".join(f"{ms:.1f}" for ms in g["agree_ms"])
            + f"; the block of {g['block_shard_rows']} int8 rows card to "
            f"card: " + ", ".join(f"{ms:.2f}" for ms in g["block_ms"])
            + f" ms, bit-equal {g['block_equal']}; peaks "
            + ", ".join(f"{d} {b / 2**30:.2f} GiB"
                        for d, b in g["peaks"].items())
            + f"; K1 at the builder's {EMB_BUILDER_SHAPE} by card "
            f"{g['builder_launches']}; K3 scans a block "
            f"({'yes' if g['scans'] else 'no: the exact product'}); launches "
            f"{g['launches']}; first swap "
            f"at {g['first_step']}: max abs err {g['check']['err']:.3e} = "
            f"{g['check']['steps']:.3f} int8 steps; {g['seconds']:.1f} s")
    failures = []
    steps = [[i for i, _ in g["swaps"]] for g in got]
    if not steps[0] or any(s != steps[0] for s in steps):
        failures.append(f"swap iterations {steps}")
    if any(g["first_step"] != got[0]["first_step"] for g in got):
        failures.append("first swap")
    failures += [f"rank {r} rows" for r, g in enumerate(got)
                 if not g["check"]["ok"]]
    if any(g["fingerprint"] != got[0]["fingerprint"] for g in got):
        failures.append("replicas")
    failures += [f"rank {r} losses" for r, g in enumerate(got)
                 if not g["losses_finite"]]
    failures += [f"rank {r} block swap" for r, g in enumerate(got)
                 if not g["block_equal"]]
    launches = {k: sum(g["launches"][k] for g in got)
                for k in got[0]["launches"]}
    # K3 scans a rank's block only above chunk_rows (smaller blocks take
    # the exact product, as the JAX search does)
    needed = ["flash_self_attention", "flash_self_attention_backward",
              "flash_cross_attention", "flash_cross_attention_backward"]
    if all(g["scans"] for g in got):
        needed.append("candidate_scan")
    failures += [f"{k} never launched" for k in needed
                 if dev.type == "cuda" and launches[k] <= 0]
    if on_cards:
        for g in got:
            trainer = g["devices"][0]
            if g["builder_launches"].get(trainer, 0) != 0:
                failures.append(f"K1 at the builder's shape on {trainer}")
            if not all(g["builder_launches"].get(d, 0) > 0
                       for d in g["embedder"]):
                failures.append(f"no builder launch on {g['embedder']}")
    return failures, launches, steps


# the two-host phase: a launch across hosts, each emulated host a group of
# this script's subprocesses with its own CUDA_VISIBLE_DEVICES and
# torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
# LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK), one rank a host, each joining
# through parallel.init_distributed. Default: both hosts see card 0 and the
# two ranks share it over gloo, doing the dp phase (b)'s OPENQA work held
# to its one-process references; --dp-cards 4: hosts of cards 0,1 and 2,3,
# each a trainer on its card 0 beside its embedder on its card 1, NCCL
HOSTS_VISIBLE = ("0", "0")
HOSTS_CARDS_VISIBLE = ("0,1", "2,3")


def _host_envs(visible, port):
    """torchrun's variables of one rank a host, host h seeing the cards
    ``visible[h]``, the rendezvous at 127.0.0.1:``port``."""
    return [{"CUDA_VISIBLE_DEVICES": v, "RANK": str(h),
             "WORLD_SIZE": str(len(visible)), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "LOCAL_RANK": "0",
             "LOCAL_WORLD_SIZE": "1", "GROUP_RANK": str(h)}
            for h, v in enumerate(visible)]


def _host_cards(layout, dev, spec):
    """A rank's place in a launch across hosts: its host and local rank,
    and the UUIDs (``torch.cuda.get_device_properties(i).uuid``; None on
    the CPU) of its trainer card, its embedder cards
    (``parallel.embed_devices``) and every card its host shows it."""
    from emdr2_tpu_torch.config import MeshConfig
    from emdr2_tpu_torch.parallel import embed_devices

    def uuid(d):
        return (str(torch.cuda.get_device_properties(d).uuid)
                if d.type == "cuda" else None)

    mesh = MeshConfig(dp=len(layout.rank_hosts),
                      embed_devices=spec.get("embed_devices", 0))
    edevs = embed_devices(mesh, torch.distributed.get_rank(), dev, layout)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [])
    return dict(host=layout.host, name=layout.name,
                local_rank=layout.local_rank,
                visible_env=os.environ.get("CUDA_VISIBLE_DEVICES"),
                trainer=str(dev), trainer_uuid=uuid(dev),
                embedder=[str(d) for d in edevs],
                embedder_uuids=[uuid(d) for d in edevs],
                visible_uuids=[uuid(d) for d in visible])


def _card_failures(got, own_cards):
    """Each rank on its own host; with ``own_cards`` (the hosts' cards
    apart) no two ranks on one trainer card, and each embedder card one of
    its own host's, no trainer's and no other host's. UUIDs are None on
    the CPU, where only the hosts are held."""
    hosts = [g["host"] for g in got]
    failures = []
    if sorted(h["host"] for h in hosts) != list(range(len(got))):
        failures.append(f"hosts {[h['host'] for h in hosts]}")
    if not own_cards or hosts[0]["trainer_uuid"] is None:
        return failures
    trainers = [h["trainer_uuid"] for h in hosts]
    if len(set(trainers)) != len(trainers):
        failures.append(f"ranks share a trainer card: {trainers}")
    for r, h in enumerate(hosts):
        others = {u for o in hosts if o["host"] != h["host"]
                  for u in o["visible_uuids"]}
        for u in h["embedder_uuids"]:
            if u not in h["visible_uuids"] or u in others:
                failures.append(f"rank {r}'s embedder card {u} is not its "
                                f"host's alone")
            if u in trainers:
                failures.append(f"rank {r}'s embedder card {u} trains")
    return failures


def hosts_phase(cfg, dev, dpb=None, cards=False, timeout=900, sizes=None):
    """Two emulated hosts of one rank each (``HOSTS_VISIBLE``: both see
    card 0; ``cards=True``: ``HOSTS_CARDS_VISIBLE``), the ranks placed by
    torchrun's variables at the rendezvous (``host_layout``): each takes
    the card of its local rank among the cards its host sees. Default
    (``dpb``: the dp phase (b)'s result): over gloo, the dp phase's work
    without the DPR steps (``_dp_runs(dpr=False)``: the K3 searches on
    each rank's block, the OPENQA check steps at dropout 0, three steps at
    dropout 0.1, ``evaluate_em`` over int8 K/V) at (b)'s global batches,
    held to (b)'s one-process references by ``_dp_checks``; every kernel
    of the path launched. ``cards=True`` (``--dp-cards 4``): over NCCL,
    ``engine.train`` with each rank's refresher on its host's embedder
    card (``--embed-devices 2``: one a host) and prefetch 1 at
    ``EMB_CARDS`` (8 questions a rank), held by the embedder phase's
    rules (``_embedder_checks``); no two ranks on one trainer card, no
    embedder card on another host. Each rank prints its cards' UUIDs; a
    rank's step time, passages/s and swap time are printed with the
    card's name and power limit. On the CPU a rehearsal over gloo
    (``sizes`` replaces the embedder's sizes there)."""
    from emdr2_tpu_torch.tools import flagship
    on_cards = cards and dev.type == "cuda"
    visible = HOSTS_CARDS_VISIBLE if cards else HOSTS_VISIBLE
    world = len(visible)
    what = (f"two hosts (cards {' and '.join(visible)}: a trainer beside "
            f"its embedder a host, {'NCCL' if on_cards else 'gloo'})"
            if cards else "two hosts (both see card 0, gloo)")
    spec = {"kind": "hosts", "world": world, "device": dev.type,
            "backend": "nccl" if on_cards else "gloo"}
    if cards:
        spec.update(mode="embedder", embed_devices=world,
                    sizes=sizes or EMB_CARDS,
                    swap_rows=N_INDEX if dev.type == "cuda" else 4096)
    else:
        plan = dpb["plan"]
        spec.update(mode="dp", dpr=False, sizes=plan["sizes"],
                    checks=plan["checks"], n_questions=plan["n_questions"],
                    n_rows=plan["n_rows"], n_docs=plan["n_docs"])
    t0 = time.perf_counter()
    got = _run_ranks(cfg, what, timeout, spec,
                     _host_envs(visible, _free_port()))
    seconds = time.perf_counter() - t0
    res = dict(ranks=got, seconds=seconds)
    if cards:
        failures, launches, steps = _embedder_checks(what, got, dev,
                                                     on_cards)
        times = [f"rank {r}: ms per iteration with a pass in flight "
                 + ", ".join(f"{m:.1f}" for m in g["with_embed"])
                 + ", without " + ", ".join(f"{m:.1f}" for m in g["without"])
                 + ", with no refresher "
                 + ", ".join(f"{m:.1f}" for m in g["plain"])
                 + "; passages/s " + ", ".join(f"{p:.1f}"
                                               for p in g["per_s"])
                 + "; swaps (iteration, ms) " + ", ".join(
                     f"({i}, {ms:.1f})" for i, ms in g["swaps"])
                 for r, g in enumerate(got)]
        res["swap_iterations"] = steps
    else:
        plan = dpb["plan"]
        search, checks, limits, failures = _dp_checks(
            dpb["ref"], got, world, plan["per_rank"]["eval"],
            plan["sizes"]["eval"], ("openqa",))
        launches = {k: sum(g["launches"][k] for g in got)
                    for k in got[0]["launches"]}
        # the OPENQA path's kernels, as in the tp phase (K4 is off it)
        failures += [f"{k} never launched" for k in TP_COUNTED
                     if dev.type == "cuda" and launches[k] <= 0]
        times = [f"rank {r}: OPENQA step ms at dropout 0.1 "
                 + ", ".join(f"{m:.1f}" for m in g["openqa_0.1"]["ms"])
                 + f" at {plan['per_rank']['qa']} questions (peak "
                 f"{g['openqa_0.1']['peak'] / 2**30:.2f} GiB; stages "
                 + _stages_text(g["openqa_0.1"]["stage_ms"])
                 + f"); evaluate_em {g['ms']['evaluate_em']:.1f} ms; bytes "
                 f"moved {g['bytes_moved']}; launches {g['launches']}"
                 for r, g in enumerate(got)]
        log(f"{what}: searches {search}; the {DP_CHECK_STEPS} check steps "
            f"at dropout 0 relative to one process: "
            + ", ".join(f"{k} {checks[k]:.3e}" for k in limits)
            + f" (limits: loss {DP_LOSS_RTOL}, grad_norm {DP_GRAD_RTOL}); "
            f"replicas bit-equal after {DP_QA_STEPS} steps at dropout 0.1: "
            f"{checks['openqa_replicas_equal']}; EM one process / ranks "
            f"{checks['em']}; generated texts equal to one process's "
            f"{checks['texts_equal_share']:.4f}")
        res.update(search=search, checks=checks)
    for r, g in enumerate(got):
        h = g["host"]
        log(f"{what} rank {r}: host {h['host']} ({h['name']}, "
            f"CUDA_VISIBLE_DEVICES={h['visible_env']}), local rank "
            f"{h['local_rank']}: trainer {h['trainer']} "
            f"{h['trainer_uuid']}, embedder {h['embedder']} "
            f"{h['embedder_uuids']}; {g['seconds']:.1f} s")
    failures += _card_failures(got, on_cards)
    res["launches"] = launches
    log(f"{what}: " + "; ".join(times) + f"; {seconds:.1f} s in all; "
        + (flagship.card_name_and_power() if dev.type == "cuda"
           else "the CPU"))
    if failures:
        raise AssertionError(f"{what} failed: {failures}")
    return res


def dp_cards_main(world: int, dev, card: str, t_start: float) -> int:
    """``chip_smoke.py --dp-cards N``: the ranks phase over NCCL, rank r on
    card r, at the flagship widths; prints its results as one JSON line
    and the ``{"ok": ...}`` line."""
    if torch.cuda.device_count() < world:
        raise AssertionError(f"--dp-cards {world} needs {world} cards, "
                             f"{torch.cuda.device_count()} visible")
    _reset_counts()
    res = dp_ranks_phase(_flagship_cfg(), dev, world=world, cards=True)
    emb = None
    if world >= 2 * EMB_WORLD:
        # the disjoint embedder layout: two trainers beside two embedders
        from emdr2_tpu_torch.config import with_transformers
        _empty_cache(dev)
        emb = embedder_phase(with_transformers(
            _flagship_cfg(), {"remat": False}, {"remat": True}), dev,
            cards=True)
    hosts = None
    if world >= 2 * len(HOSTS_CARDS_VISIBLE):
        # a launch across two hosts of two cards each: a trainer beside
        # its embedder on each host
        from emdr2_tpu_torch.config import with_transformers
        _empty_cache(dev)
        hosts = hosts_phase(with_transformers(
            _flagship_cfg(), {"remat": False}, {"remat": True}), dev,
            cards=True)
    tps = []
    if world >= 4:
        # tensor parallelism over NCCL: --tp 2 on cards 0-1 at the
        # flagship step's B=8, then --dp 2 --tp 2 on four cards
        for layout in TP_CARDS:
            _empty_cache(dev)
            t0 = time.perf_counter()
            r = tp_phase(_flagship_cfg(), dev, cards=True, layout=layout)
            log(f"tp phase dp {layout['dp']} x tp {layout['tp']}: "
                f"{time.perf_counter() - t0:.1f} s")
            tps.append({"sizes": r["sizes"], "checks": r["checks"],
                        "launches_by_rank": r["launches_by_rank"],
                        "one_card": {k: r["ref"][k] for k in (
                            "openqa_0.0", "openqa_0.1", "dpr_0.0")},
                        "ranks": [{k: g[k] for k in (
                            "dp_rank", "tp_rank", "openqa_0.0",
                            "openqa_0.1", "dpr_0.0", "seconds")}
                            for g in r["ranks"]]})
    summary = {"dp_cards": world, "checks": res["checks"], "tp": tps,
               "search": res["search"], "launches": res["launches"],
               "ranks": [{k: g[k] for k in ("openqa_0.1", "dpr_0.1",
                                            "bytes_moved", "seconds")}
                         for g in res["ranks"]],
               "one_card": {k: res["ref"][k] for k in ("openqa_0.1",
                                                       "dpr_0.1")},
               "embedder": emb and [
                   {k: g[k] for k in (
                       "devices", "embedder", "with_embed", "without",
                       "plain", "pass_s", "per_s", "swaps", "agree_ms",
                       "block_ms", "peaks", "builder_launches", "check",
                       "seconds")} for g in emb["ranks"]],
               "hosts": hosts and {
                   "launches": hosts["launches"],
                   "swap_iterations": hosts["swap_iterations"],
                   "ranks": [{k: g[k] for k in (
                       "host", "with_embed", "without", "plain", "pass_s",
                       "per_s", "swaps", "agree_ms", "block_ms", "peaks",
                       "builder_launches", "check", "seconds")}
                       for g in hosts["ranks"]]}}
    log(f"chip_smoke --dp-cards {world} total "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the tensor-parallel phase: the ranks of a [dp, tp] grid (world rank
# dp_idx * tp + tp_idx), each replica's heads, MLP columns and vocabulary
# split over its tp ranks, the index's blocks over all of them. Sizes are
# global batches; "check_qa" the check steps' batch (against one process
# at the same batch), "qa" the timed steps' at dropout 0.1
TP_SHARED = {"dp": 1, "tp": 2, "check_qa": 2, "qa": 2, "dpr": 32,
             "eval": 2}
TP_CARDS = ({"dp": 1, "tp": 2, "check_qa": 8, "qa": 8, "dpr": 64,
             "eval": 8},
            {"dp": 2, "tp": 2, "check_qa": 4, "qa": 16, "dpr": 64,
             "eval": 8})
TP_CHECK_STEPS = 2
TP_DROP_STEPS = 2
TP_EVAL_QUESTIONS = 4
TP_N_ROWS = 131_072         # a block of 65,536 / 32,768 rows: the K3 scan
TP_N_DOCS = 8_192
TP_COUNTED = ("flash_self_attention", "flash_self_attention_backward",
              "flash_cross_attention", "flash_cross_attention_backward",
              "candidate_scan", "decode_cross_attention_int8")


def _tp_cfg(cfg, rate):
    """The flagship recipe (--remat --no-remat-towers) at dropout
    ``rate``."""
    from emdr2_tpu_torch.config import with_transformers
    drop = {"hidden_dropout": rate, "attention_dropout": rate}
    qcfg = with_transformers(cfg, dict(drop, remat=False),
                             dict(drop, remat=True, remat_policy="nothing"))
    rc = cfg.retriever
    rcfg = dataclasses.replace(rc, encoder=dataclasses.replace(
        rc.encoder, remat=False, **drop))
    return qcfg, rcfg


def _split_fingerprints(model):
    """(fingerprint of the parameters every tp rank holds whole, of all
    of this rank's parameters)."""
    from emdr2_tpu_torch.parallel.tensor import split_of
    from emdr2_tpu_torch.utils.repeat import fingerprint
    named = list(model.named_parameters())
    return (repr([fingerprint(p) for n, p in named if split_of(n) is None]),
            repr([fingerprint(p) for _, p in named]))


def _tp_runs(cfg, dev, tmpdir, sizes, n_questions, dp=None):
    """What one rank of the tp phase runs (or one process, ``dp=None``):
    ``evaluate_em`` of the initial state over ``TP_EVAL_QUESTIONS``
    questions, greedy over int8 K/V (K5 on the rank's heads);
    ``TP_CHECK_STEPS`` OPENQA steps at dropout 0 at ``sizes["check_qa"]``
    (loss and global gradient norm); ``TP_DROP_STEPS`` at dropout 0.1 at
    ``sizes["qa"]`` (their times, the peak, the bytes each tp collective
    moved, the fingerprints); one DPR step at dropout 0 at
    ``sizes["dpr"]``. Batches are global: each replica feeds its slice of
    the ``n_questions`` training questions (one set for the ranks and one
    process: the shuffled order depends on it)."""
    from emdr2_tpu_torch.config import OptimizerConfig
    from emdr2_tpu_torch.tasks import E2EQATask, e2eqa
    from emdr2_tpu_torch.tasks.dense_retriever import DPRTask
    from emdr2_tpu_torch.utils.timing import StageTimer

    rank, world = (dp.rank, dp.world_size) if dp is not None else (0, 1)
    ranks = {"rank": rank, "world_size": world}
    out = {"ms": {}}
    tok, corpus, index = _dp_world(cfg, tmpdir, dev, TP_N_ROWS, TP_N_DOCS,
                                   dp)
    ds = _qa_dataset(cfg, tok, tmpdir, n_questions)
    opt = OptimizerConfig(lr=2e-5, weight_decay=0.1, clip_grad=1.0,
                          warmup=0.0)

    def moved():
        if dp is None:
            return {}
        return {f"tp_{k}": v for k, v in dp.tp.bytes_moved.items()} | {
            f"dp_{k}": v for k, v in dp.bytes_moved.items()} | {
            f"world_{k}": v for k, v in dp.world.bytes_moved.items()}

    def run_steps(name, task, batches):
        losses, norms, ms = [], [], []
        before = moved()
        _reset_peak(dev)
        for batch in batches:
            _sync(dev)
            t0 = time.perf_counter()
            m = task.train_step(batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        after = moved()
        out[name] = dict(loss=losses, grad_norm=norms, ms=ms,
                         peak=_peak(dev), stage_ms=dict(task.timer.ms),
                         bytes_per_step={k: (after[k] - before.get(k, 0))
                                         / len(batches) for k in after})

    for rate in (0.0, 0.1):
        qcfg, _ = _tp_cfg(cfg, rate)
        bs = sizes["check_qa"] if rate == 0.0 else sizes["qa"]
        qcfg = qcfg.replace(train=dataclasses.replace(
            qcfg.train, batch_size=bs, optimizer=opt))
        task = E2EQATask(qcfg, tok, corpus, index, total_train_iters=1000,
                         device=dev, dp=dp, timer=StageTimer(dev))
        task.init_state(SEED)
        if rate == 0.0:
            rec = []
            metric = e2eqa.metric_max_over_ground_truths

            def recording(m, text, refs):
                rec.append(text)
                return metric(m, text, refs)

            e2eqa.metric_max_over_ground_truths = recording
            try:
                t0 = time.perf_counter()
                em = task.evaluate_em(
                    _qa_dataset(cfg, tok, tmpdir, TP_EVAL_QUESTIONS),
                    batch_size=sizes["eval"], kv_quant="int8")
                out["ms"]["evaluate_em"] = (time.perf_counter() - t0) * 1e3
            finally:
                e2eqa.metric_max_over_ground_truths = metric
            out["em"] = dict(em=em, texts=rec)
        steps = TP_CHECK_STEPS if rate == 0.0 else TP_DROP_STEPS
        run_steps(f"openqa_{rate}", task,
                  list(ds.epoch_batches(bs, seed=SEED, **ranks))[:steps])
        if rate > 0:
            out["whole_params"], out["all_params"] = _split_fingerprints(
                task.state.model)
        del task
        _empty_cache(dev)
    del index
    _empty_cache(dev)
    _, rcfg = _tp_cfg(cfg, 0.0)
    task = DPRTask(rcfg, opt, 1000, device=dev, dp=dp, timer=StageTimer(dev))
    task.init_state(SEED)
    run_steps("dpr_0.0", task, _dpr_batches(cfg, tmpdir, sizes["dpr"], 1,
                                             rank=rank, world=world))
    del task
    _empty_cache(dev)
    return out


def tp_phase(cfg, dev, cards=False, layout=None, timeout=900):
    """The ranks of a ``[dp, tp]`` grid as subprocesses of this script
    against one process from the same state. Default (one card): two
    gloo ranks share ``dev`` at ``--tp 2`` (``TP_SHARED``); ``cards=True``
    (``--dp-cards 4``): NCCL, rank r on card r, at ``layout`` (one of
    ``TP_CARDS``). Held: the losses and global gradient norms of the
    check steps at dropout 0 within ``DP_LOSS_RTOL`` / ``DP_GRAD_RTOL``
    of one process at the same global batch; after the steps at dropout
    0.1 the parameters every tp rank holds whole bit-equal on the tp
    ranks of a replica, and each rank's parameters bit-equal to its
    counterpart's in another replica; K1, K2, K3 and K5 launched on every
    rank; the DPR step's loss and norm within the same limits."""
    sizes = dict(layout or TP_SHARED)
    dp_n, tp_n = sizes["dp"], sizes["tp"]
    world = dp_n * tp_n
    what = (f"(cards: dp {dp_n} x tp {tp_n} over "
            f"{'NCCL' if dev.type == 'cuda' else 'gloo'})" if cards
            else f"(one card: tp {tp_n} over gloo)")
    # one process: the check steps at the same global batch, the timed
    # steps at a replica's batch (what one card holds)
    ref_sizes = dict(sizes, qa=sizes["qa"] // dp_n)
    n_questions = max(TP_EVAL_QUESTIONS, sizes["qa"] * TP_DROP_STEPS,
                      sizes["check_qa"] * TP_CHECK_STEPS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        ref = _tp_runs(cfg, dev, tmpdir, ref_sizes, n_questions)
    ref_s = time.perf_counter() - t0
    _empty_cache(dev)
    own = cards and dev.type == "cuda"
    t0 = time.perf_counter()
    got = _run_ranks(cfg, f"tp {what}", timeout, {
        "kind": "tp", "tp": tp_n,
        "devices": ([f"cuda:{r}" for r in range(world)] if own
                    else [str(dev)] * world),
        "world": world, "backend": "nccl" if own else "gloo",
        "sizes": sizes, "n_questions": n_questions})
    ranks_s = time.perf_counter() - t0
    checks, limits = {}, {}
    for name, steps in (("openqa", TP_CHECK_STEPS), ("dpr", 1)):
        for key, limit in (("loss", DP_LOSS_RTOL),
                           ("grad_norm", DP_GRAD_RTOL)):
            for step in range(steps):
                want = ref[f"{name}_0.0"][key][step]
                checks[f"{name}_{key}_{step + 1}_rel"] = max(
                    abs(g[f"{name}_0.0"][key][step] - want) / abs(want)
                    for g in got)
                limits[f"{name}_{key}_{step + 1}_rel"] = limit
    grid = {(g["dp_rank"], g["tp_rank"]): g for g in got}
    checks["whole_params_equal_over_tp"] = all(
        g["whole_params"] == grid[(d, 0)]["whole_params"]
        for (d, _), g in grid.items())
    checks["replicas_equal_over_dp"] = all(
        g["all_params"] == grid[(0, t)]["all_params"]
        for (_, t), g in grid.items())
    # the kernels launch on a card only (the plain versions run on the
    # CPU, where this phase rehearses)
    missing = [(r, k) for r, g in enumerate(got)
               for k in TP_COUNTED + DA_COUNTED
               if g["launches"][k] <= 0 and dev.type == "cuda"]
    # a replica's texts: its rows of each evaluation batch
    per, n_eval = sizes["eval"] // dp_n, len(ref["em"]["texts"])
    checks["texts_equal_share"] = []
    for g in got:
        d = g["dp_rank"]
        want = [t for i in range(0, n_eval, sizes["eval"])
                for t in ref["em"]["texts"][i + d * per:i + (d + 1) * per]]
        checks["texts_equal_share"].append(
            sum(a == b for a, b in zip(g["em"]["texts"], want))
            / max(len(want), 1))
    for r, g in enumerate(got):
        o = g["openqa_0.1"]
        log(f"tp {what} rank {r} (dp {g['dp_rank']}, tp {g['tp_rank']}): "
            f"OPENQA step ms at dropout 0.1 (B={sizes['qa']} global) "
            + ", ".join(f"{m:.1f}" for m in o["ms"])
            + f"; peak {o['peak'] / 2**30:.2f} GiB; bytes a step "
            f"{o['bytes_per_step']}; stages " + _stages_text(o["stage_ms"])
            + f"; check steps {g['openqa_0.0']['ms']} ms; DPR B="
            f"{sizes['dpr']} {g['dpr_0.0']['ms']} ms (peak "
            f"{g['dpr_0.0']['peak'] / 2**30:.2f} GiB); evaluate_em "
            f"{g['ms']['evaluate_em']:.1f} ms EM {g['em']['em']}; "
            f"{g['seconds']:.1f} s; launches {g['launches']}")
    log(f"tp {what} one process (references, {ref_s:.1f} s): OPENQA B="
        f"{ref_sizes['qa']} step ms {ref['openqa_0.1']['ms']} peak "
        f"{ref['openqa_0.1']['peak'] / 2**30:.2f} GiB; check steps B="
        f"{sizes['check_qa']} {ref['openqa_0.0']['ms']} ms peak "
        f"{ref['openqa_0.0']['peak'] / 2**30:.2f} GiB; DPR "
        f"{ref['dpr_0.0']['ms']} ms; EM {ref['em']['em']}")
    log(f"tp {what} {world} ranks ({ranks_s:.1f} s): the check steps "
        f"relative to one process: "
        + ", ".join(f"{k} {checks[k]:.3e}" for k in limits)
        + f" (limits: loss {DP_LOSS_RTOL}, grad_norm {DP_GRAD_RTOL}); "
        f"values one process / rank 0: " + ", ".join(
            f"{name}_{key} {ref[f'{name}_0.0'][key]} / "
            f"{got[0][f'{name}_0.0'][key]}" for name in ("openqa", "dpr")
            for key in ("loss", "grad_norm"))
        + f"; whole parameters bit-equal over tp after {TP_DROP_STEPS} "
        f"steps at dropout 0.1: {checks['whole_params_equal_over_tp']}; "
        f"replicas bit-equal over dp: {checks['replicas_equal_over_dp']}; "
        f"generated texts equal to one process's (greedy int8, a share "
        f"by rank) {checks['texts_equal_share']}")
    failures = [k for k, limit in limits.items() if not checks[k] <= limit]
    failures += [k for k in ("whole_params_equal_over_tp",
                             "replicas_equal_over_dp") if not checks[k]]
    failures += [f"{k} never launched on rank {r}" for r, k in missing]
    if failures:
        raise AssertionError(f"tp {what} failed: {failures}")
    return {"ref_seconds": ref_s, "ranks_seconds": ranks_s, "ranks": got,
            "ref": ref, "checks": checks, "sizes": sizes,
            "launches_by_rank": [dict(g["launches"]) for g in got]}


# the measurement tools' phase: every tool of emdr2_tpu_torch/tools/bench_*
# through its main(argv), at EMDR2Config() widths and full depth, grids and
# iterations cut to fit TOOLS_BUDGET_S
TOOLS_BUDGET_S = 360
TOOLS_SWEEP_ROWS = (["--bs", "8,16", "--policies", "full", "--residency",
                     "int8"],
                    ["--bs", "8", "--policies", "towers", "--residency",
                     "none"])
TOOLS_EMBED_DOCS = 16_384


def _share_ok(x) -> bool:
    return x is not None and 0.0 < x <= 1.0


def tools_phase(dev):
    """16. The port's measurement tools (``emdr2_tpu_torch/tools/bench_*``),
    each through ``main(argv)`` on the card: the rescore tool (its two
    window selections at k 20 and 51 give the same rows, the default
    window's rows equal an exact search up to the ties ``TIE_EPS`` allows,
    and the recall of ``rescore=0`` beside it), the kernel sweep (K4 on the
    cross shape: chunks 256 and 512 give times), the step breakdown (every
    pass's share of the peak in (0, 1], and the whole step's), the dropout
    breakdown, a cut train sweep (each row's share in (0, 1] or an
    out-of-memory row), and the pipeline's stages A and B, ``--refresh``,
    ``--embed``, ``--overlap``, ``--decode`` and one decode-sweep row."""
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.tools import (bench_dropout_breakdown,
                                       bench_kernel_sweep, bench_mips_rescore,
                                       bench_pipeline, bench_step_breakdown,
                                       bench_train_sweep, flagship)
    t_phase = time.perf_counter()
    seconds = {}
    on = ["--device", str(dev)]
    icfg = flagship.base_config().index
    group = icfg.group_size

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        seconds[name] = time.perf_counter() - t0
        log(f"tools: {name} in {seconds[name]:.1f} s")
        return r

    _reset_counts()
    # rescore: the two selections agree; the default window against an
    # exact search (float64 sums), misses only where TIE_EPS allows
    res = timed("bench_mips_rescore",
                lambda: bench_mips_rescore.main(["--iters", "5"] + on))
    qf, q8, scales = res[0]["inputs"]
    n = q8.shape[0]
    rows_f = mips.dequantize_int8(q8, scales, group)
    oracle_vals, oracle = exact_top(qf, rows_f, n, max(bench_mips_rescore.KS))
    del rows_f
    for k in bench_mips_rescore.KS:
        by = {r["row"]["window_select"]: r for r in res if r["row"]["k"] == k}
        blocked, exact = by["blocked"]["ids"], by["exact_topk"]["ids"]
        if not np.array_equal(np.sort(blocked, 1), np.sort(exact, 1)):
            raise AssertionError(f"tools rescore k={k}: the blocked window "
                                 f"and the exact top-M give other rows")
        ex = explain_misses(blocked, oracle[:, :k + K3_EXTRA],
                            oracle_vals[:, :k + K3_EXTRA], k, ties=True,
                            group=group)
        _, ids0 = mips.mips_topk(qf, q8, k, chunk_rows=icfg.chunk_rows,
                                 group_size=group, shard_scales=scales,
                                 rescore=0)
        recall0 = bench_mips_rescore.recall(ids0.cpu().numpy(),
                                            by["blocked"]["ref"])
        log(f"tools rescore k={k}: {by['blocked']['row']} / "
            f"{by['exact_topk']['row']}; against an exact search: "
            f"{misses_text(ex, k)}; recall with rescore=0 {recall0:.6f}")
        if ex["unexplained"]:
            raise AssertionError(f"tools rescore k={k}: {misses_text(ex, k)}")
    del res, qf, q8, scales, oracle, oracle_vals
    _empty_cache(dev)

    sweep = timed("bench_kernel_sweep", lambda: bench_kernel_sweep.main(
        ["--batch", "8", "--iters", "5"] + on))
    for chunk in (256, 512):
        row = next(r for r in sweep if r.get("key_chunk") == chunk)
        if "fwd_bwd_ms" not in row:
            raise AssertionError(f"tools kernel sweep chunk {chunk}: {row}")
    _empty_cache(dev)

    bd = timed("bench_step_breakdown", lambda: bench_step_breakdown.main(
        ["--batch", "8", "--iters", "3"] + on))
    rows = bd["breakdown"]
    cfg = flagship.flagship_step_config(8, 50)
    step_flops = flagship.model_flops_per_step(cfg, 8, 50)
    full_share = flagship.share_of_peak(
        step_flops, rows["full_step"]["ms"] / 1e3, flagship.peak_flops(dev))
    log(f"tools step breakdown: {json.dumps(bd)}; the whole step "
        f"{step_flops / 1e12:.1f} model TFLOP in {rows['full_step']['ms']} "
        f"ms: {full_share} of the peak")
    for name in ("retriever_fwdbwd", "reader_fwdbwd", "teacher_fwd"):
        if not _share_ok(rows[name]["util_vs_peak"]):
            raise AssertionError(f"tools step breakdown {name}: "
                                 f"{rows[name]}")
    if not _share_ok(full_share):
        raise AssertionError(f"tools step breakdown: step share {full_share}")
    _empty_cache(dev)

    drop = timed("bench_dropout_breakdown",
                 lambda: bench_dropout_breakdown.main(["--iters", "3"]
                                                      + on))
    for r in drop:
        if "ms_per_step" not in r:
            raise AssertionError(f"tools dropout breakdown: {r}")

    train = []
    for argv in TOOLS_SWEEP_ROWS:
        train += timed("bench_train_sweep " + " ".join(argv),
                       lambda a=argv: bench_train_sweep.main(
                           a + ["--iters", "2"] + on))
    for r in train:
        oom = "OutOfMemoryError" in r.get("error", "")
        if not (oom or _share_ok(r.get("model_flops_util"))):
            raise AssertionError(f"tools train sweep: {r}")

    for argv in (["--iters", "5", "--decode"], ["--iters", "3", "--refresh"],
                 ["--embed", "--n-docs", str(TOOLS_EMBED_DOCS)],
                 ["--iters", "3", "--overlap"]):
        timed("bench_pipeline " + " ".join(argv),
              lambda a=argv: bench_pipeline.main(a + on))
        _empty_cache(dev)
    row = timed("bench_pipeline --decode-sweep-row 8:1:int8", lambda:
                bench_pipeline.main(["--iters", "3", "--decode-sweep-row",
                                     "8:1:int8"] + on))
    if "error" in row:
        raise AssertionError(f"tools decode sweep row: {row}")
    launches = _read_counts(list(_counters()))
    phase_s = time.perf_counter() - t_phase
    log(f"tools phase: {phase_s:.1f} s (budget {TOOLS_BUDGET_S} s); "
        f"launches {launches}")
    _empty_cache(dev)
    return dict(launches=launches, seconds=seconds, phase_s=phase_s)


def _flagship_cfg():
    from emdr2_tpu_torch.config import EMDR2Config, IndexConfig
    from emdr2_tpu_torch.config import with_flash_attention
    return with_flash_attention(EMDR2Config(index=IndexConfig(
        quantize="int8")))


KERNEL_CLASSES = (
    ("K1 flash self-attention", ("RowMaxInv",)),
    ("K4 general flash attention", ("aflash::Lse",)),
    ("K2 flash cross-attention", ("::cross_",)),
    ("K3, K5", ("candidate_scan", "::decode_")),
    ("matrix products (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma",
                                  "cublas")),
    ("integer elementwise (the plain dropout hash)",
     ("<int, int, int", "Bitwise", "bitwise", "shift")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
    ("other elementwise", ("elementwise_kernel",)),
)


def kernel_class(name: str) -> str:
    for label, words in KERNEL_CLASSES:
        if any(w in name for w in words):
            return label
    return "other"


def profile_call(fn, table_name, n_top=15):
    """One warm call of ``fn`` under torch.profiler: (device ms summed over
    kernels, wall ms, the top kernels by device time); the operator table
    goes to ``chiprun_out/<table_name>``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: an operator's row repeats the device time of the
    # kernels it launched; a kernel's own row has no CPU time
    averages = prof.key_averages()
    events = [e for e in averages
              if dev_us(e) > 0 and e.self_cpu_time_total == 0]
    events.sort(key=dev_us, reverse=True)
    total_ms = sum(dev_us(e) for e in events) / 1e3
    top = [(e.key, dev_us(e) / 1e3, e.count) for e in events[:n_top]]
    # the same device time by the operator that launched the kernels
    ops = sorted((e for e in averages
                  if dev_us(e) > 0 and e.self_cpu_time_total > 0),
                 key=dev_us, reverse=True)
    by_op = [(e.key, dev_us(e) / 1e3, e.count) for e in ops[:2 * n_top]]
    classes = {}
    for e in events:
        label = kernel_class(e.key)
        classes[label] = classes.get(label, 0.0) + dev_us(e) / 1e3
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", table_name), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=60))
    return dict(device_ms=total_ms, wall_ms=wall_ms, top=top, by_op=by_op,
                classes=classes)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm train step at B=4 under "
                         "each remat policy, a DPR step under each layout "
                         "and one warm greedy batch with each cross-K/V "
                         "form")
    ap.add_argument("--dp-cards", type=int, default=None,
                    help="run only the data-parallel phase, over NCCL with "
                         "this many ranks, one a card, against one card at "
                         "the same batch a rank")
    ap.add_argument("--dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # a rank of the ranks phase
    ap.add_argument("--dp-spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dp_rank is not None:
        sys.path.insert(0, REPO)
        return dp_rank_main(args.dp_spec, args.dp_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from emdr2_tpu_torch.config import with_transformers
    from emdr2_tpu_torch.ops import build
    from emdr2_tpu_torch.tools import flagship

    card = flagship.card_name_and_power()
    log(f"nvidia-smi name, power.limit: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # reference products in true fp32 (stated and set, for matmul and conv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t_start = time.perf_counter()

    info = build.build()
    log(f"kernel build: {info['seconds']:.1f} s (built={info['built']}) "
        f"-> {os.path.relpath(info['path'], REPO)}")
    if args.dp_cards is not None:
        return dp_cards_main(args.dp_cards, dev, card, t_start)

    seconds = {}                     # each phase's, in the order run

    def timed(name, phase, *args, **kwargs):
        t0 = time.perf_counter()
        out = phase(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    # each kernel against its plain version at the main path's shapes
    kernel_errors = timed("kernels", kernel_phase, dev)
    cfg = _flagship_cfg()
    res = timed("serving", slice_phase, cfg, dev, gen,
                profile=args.profile)
    for name, ms in res["stage_ms"].items():
        log(f"slice stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms per batch")
    log(f"slice ask: {len(res['answers'])} answers in {res['ask_s']:.3f} s, "
        f"peak memory {res['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{res['launches']}; first answers {res['answers'][:2]!r}")
    for name, n in res["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched during ask")
    gn = res["generation"]
    for run in ("greedy_int8", "beam5_int8"):
        r = gn[run]
        for name, ms in r["stage_ms"].items():
            log(f"generation {run} stage {name}: "
                + ", ".join(f"{m:.2f}" for m in ms) + " ms per batch")
        log(f"generation {run}: {len(r['answers'])} answers in "
            f"{r['ask_s']:.3f} s, peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, launches {r['launches']}; "
            f"first answers {r['answers'][:2]!r}")
        for name, n in r["launches"].items():
            if n <= 0:
                raise AssertionError(f"{name} never launched during the "
                                     f"{run} generation run")
    log(f"generation: cross K/V slab of a batch of 8, 12 layers: "
        f"{gn['slab_bytes']['bf16'] / 1e9:.3f} GB as fp32 K + bf16 V, "
        f"{gn['slab_bytes']['int8'] / 1e9:.3f} GB as int8 + scales; int8 "
        f"greedy answers equal to the bf16-path ones: "
        f"{gn['greedy_int8']['share_equal_bf16']:.4f}; first decode step "
        f"log-probs, int8 against bf16 path: max abs diff "
        f"{gn['step_logprob_max_diff']:.3e}")
    for what, prof in gn.get("profiles", {}).items():
        log_profile(f"warm batch of 8, {what}", prof)
    del gn
    gc.collect()
    torch.cuda.empty_cache()

    # the flagship recipe: --remat --no-remat-towers (reader stacks
    # checkpointed, towers stored), dropout 0.1 (the config defaults)
    tcfg = with_transformers(cfg, {"remat": False}, {"remat": True})

    # evaluation under --flash-key-chunk 256: rows longer than the chunk
    # (the reader's 512 tokens) run the general flash kernel
    chunked = {"flash_key_chunk": 256}
    ev = timed("eval", eval_phase, with_transformers(cfg, chunked, chunked),
               dev, gen)
    for name, ms in ev["stage_ms"].items():
        log(f"eval stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms")
    log(f"eval: evaluate_em greedy int8 EM {ev['em']:.4f} n {ev['n']} in "
        f"{ev['seconds']['evaluate_em']:.3f} s; beam 5 EM "
        f"{ev['em_beam']:.4f} n {ev['n_beam']} in "
        f"{ev['seconds']['evaluate_em_beam']:.3f} s; validation_loss "
        f"{ev['val']} in {ev['seconds']['validation_loss']:.3f} s; peak "
        f"memory {ev['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{ev['launches']}")
    log("eval: one batch's losses, flash kernels against materialized "
        "attention: " + ", ".join(f"{k} {g:.6f} / {w:.6f}"
                                  for k, (g, w) in ev["agree"].items()))
    for name, n in ev["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched during evaluation")

    del ev
    gc.collect()
    torch.cuda.empty_cache()

    # the training loop under --flash-key-chunk 256, --remat
    # --no-remat-towers: prefetcher, checkpoints, evaluation callback
    eg = timed("engine", engine_phase,
               with_transformers(tcfg, chunked, chunked), dev, gen)
    for name, ms in eg["stage_ms"].items():
        log(f"engine stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms")
    log("engine: ms per iteration with prefetch "
        + ", ".join(f"{h['ms_per_iter']:.1f}" for h in eg["history"])
        + " (the third also stages the interval checkpoint, the fourth "
        "runs beside its write); without prefetch "
        + ", ".join(f"{h['ms_per_iter']:.1f}" for h in eg["plain_history"])
        + f"; {len(eg['history'])} iterations, saves and the evaluation in "
        f"{eg['train_s']:.3f} s; peak memory "
        f"{eg['peak_bytes'] / 2**30:.2f} GiB")
    log(f"engine: evaluation callback {eg['evals']}")
    ck = eg["checkpoint"]
    log(f"engine: checkpoint {ck['bytes'] / 1e9:.3f} GB; async stage "
        f"{ck['async_stage_s']:.3f} s, background write "
        f"{ck['background_write_s']:.3f} s, synchronous save "
        f"{ck['sync_save_s']:.3f} s, load into a fresh task "
        f"{ck['load_s']:.3f} s; {eg['n_compared']} restored tensors equal "
        f"bit for bit; the step after the restore: {eg['resumed']}")
    log(f"engine: launches {eg['launches']} (one step should launch K4-bwd "
        f"12, K4-fwd 36, K1-fwd 36, K1-bwd 24, K2-fwd 36, K2-bwd 12, K3 1)")
    for name, n in eg["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched in the engine phase")

    gc.collect()
    torch.cuda.empty_cache()

    # the evidence-index build, its live refresh in the loop, and the
    # command line around them
    timed("index", index_phase, cfg, dev, gen)
    rf = timed("refresh", refresh_phase, tcfg, dev, gen)
    log("refresh: ms per iteration with an embed pass in flight "
        + ", ".join(f"{m:.1f}" for m in rf["with_embed"])
        + "; without " + ", ".join(f"{m:.1f}" for m in rf["without"])
        + "; with no refresher " + ", ".join(
            f"{h['ms_per_iter']:.1f}" for h in rf["plain_history"])
        + f"; {len(rf['history'])} iterations in {rf['train_s']:.3f} s")
    log(f"refresh: {len(rf['pass_s'])} completed embed passes while "
        f"training: " + ", ".join(f"{s:.3f} s ({p:.1f} passages/s)"
                                  for s, p in zip(rf["pass_s"],
                                                  rf["per_s"]))
        + "; swaps (iteration, ms of maybe_swap on the trainer thread) "
        + ", ".join(f"({i}, {ms:.1f})" for i, ms in rf["swaps"])
        + f"; refresh_count {rf['refresh_count']}; peak memory "
        f"{rf['peak_bytes'] / 2**30:.2f} GiB; launches {rf['launches']}")
    log(f"refresh: the index swapped at iteration {rf['first_swap']} "
        f"against the hand-off tower's embedding: max abs err "
        f"{rf['check_err']:.3e} = {rf['check_steps']:.3f} int8 steps of "
        f"its group (limit: one step + {FWD_TOL[0]} x max|ref|)")
    for name in ("flash_self_attention", "candidate_scan"):
        if rf["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched in the refresh "
                                 f"phase")
    cl = timed("cli", cli_phase, cfg, dev)
    log(f"cli: seconds {cl['seconds']}; {cl['valid']}; create_doc_index "
        f"launches {cl['index_launches']}; run launches {cl['launches']}; "
        f"QAPipeline.load answers {cl['answers'][:2]!r}")
    for name in ("flash_self_attention", "flash_self_attention_backward",
                 "flash_cross_attention", "flash_cross_attention_backward",
                 "candidate_scan"):
        if cl["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched by the command line")
    if cl["index_launches"]["flash_self_attention"] <= 0:
        raise AssertionError("create_doc_index never launched K1-fwd")

    # the RETRIEVER task (DPR training under the three remat layouts), the
    # retrieval evaluation at NQ-test's size, the OPENQA step under
    # dots_no_batch, and the RETRIEVER command line with its tools
    timed("dpr", dpr_phase, cfg, dev, profile=args.profile)
    _empty_cache(dev)
    timed("retrieval_eval", retrieval_eval_phase, cfg, dev, gen)
    for policy in ("nothing", "dots_no_batch"):
        pcfg = with_transformers(cfg, {"remat": False},
                                 {"remat": True, "remat_policy": policy})
        r = timed(f"train_b4_{policy}", train_phase, pcfg, dev, gen,
                  batch=4, steps=2, profile=args.profile,
                  profile_table=f"train_step_profile_b4_{policy}.txt")
        if r["top"] is not None:
            log_profile(f"warm train step at B=4, {policy}", r["top"])
        log(f"train B=4 --remat-policy {policy}: " + "; ".join(
            f"{name} " + ", ".join(f"{m:.2f}" for m in ms)
            for name, ms in r["stage_ms"].items())
            + f" ms; peak memory {r['peak_bytes'] / 2**30:.2f} GiB; "
            f"launches {r['launches']}")
        for name, n in r["launches"].items():
            if n <= 0:
                raise AssertionError(f"{name} never launched in the B=4 "
                                     f"{policy} steps")
        _empty_cache(dev)
    timed("retriever_cli", retriever_cli_phase, cfg, dev)
    _empty_cache(dev)

    # C5: a DPR step and an OPENQA step, each twice from one state, bit
    # for bit; then data parallelism: one rank over NCCL against the plain
    # path, two ranks sharing the card over gloo against one process
    c5 = timed("c5", c5_phase, cfg, tcfg, dev, gen)
    log(json.dumps(kernels_line(kernel_errors, c5["kernels"])))
    dpa = timed("dp_one_rank", dp_one_rank_phase, cfg, dev)
    dpb = timed("dp_ranks", dp_ranks_phase, cfg, dev)
    dpl = dict(dpb["launches"])
    for name, n in dpa["launches"].items():
        dpl[name] = dpl.get(name, 0) + n
    dpl["candidate_scan"] += sum(s["launches"]
                                 for s in dpa["search"].values())
    for name in ("flash_self_attention", "flash_self_attention_backward",
                 "flash_cross_attention", "flash_cross_attention_backward",
                 "candidate_scan", "decode_cross_attention_int8"):
        if dpl[name] <= 0:
            raise AssertionError(f"{name} never launched on the "
                                 f"data-parallel path")
    # a launch across hosts: two emulated hosts of one rank each, both
    # seeing card 0, placed by torchrun's variables, held to (b)'s
    # one-process references
    _empty_cache(dev)
    timed("hosts", hosts_phase, cfg, dev, dpb)
    # the asynchronous refresh and prefetch across ranks: two ranks share
    # the card over gloo, each with its embedder on it (--embed-devices 0)
    _empty_cache(dev)
    timed("embedder", embedder_phase, tcfg, dev)
    # tensor parallelism: two gloo ranks share the card at --tp 2, each on
    # its 6 of the 12 heads
    _empty_cache(dev)
    t0 = time.perf_counter()
    tp = timed("tp", tp_phase, _flagship_cfg(), dev)
    log(f"tp phase: {time.perf_counter() - t0:.1f} s (one process "
        f"{tp['ref_seconds']:.1f} s, the ranks {tp['ranks_seconds']:.1f} s)")
    # the measurement tools, each through its main(argv)
    _empty_cache(dev)
    timed("tools", tools_phase, dev)
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"phase_seconds": seconds}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
