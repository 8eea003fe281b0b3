#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. Builds the hand-written CUDA kernels from ``emdr2_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version at the shapes the
   serving and training paths give it, and times both with CUDA events:
   flash self-attention (K1) forward at [8, 64, 2304] and [400, 512, 2304]
   (bf16, 12 heads) and with dropout 0.1, its backward at [8, 64],
   [400, 256] and [400, 512] (gradients checked on 32 rows, timed on all);
   flash cross-attention (K2) forward and backward at the reader shape
   (8 rows, 32 queries x 25,600 keys) and the teacher shape (400 rows, 32 x
   512), dropout 0 and 0.1, padded keys present; the MIPS candidate scan
   (K3) over a 1,310,720 x 768 index in bf16 and int8, nq in {8, 512}, plus
   top-50 recall of the whole search against an exact fp32 search.
3. Serving: drives ``QAPipeline.ask`` on 16 questions at batch 8 at full
   published width (BERT-base query tower, T5-base reader, K=50, reader
   length 512, 32 decode steps, int8 index, flash attention on: the
   flagship recipe), with weights from a seed, a synthetic ~20k-passage
   corpus and a 1,310,720-row index made on the device. Prints ms per
   stage, peak memory and each kernel's launch count during ``ask``, and
   checks the answers and the retrieved ids against an exact search.
4. Training: three ``E2EQATask.train_step``s at ``EMDR2Config()`` widths
   (BERT-base x 2, T5-base, K=50, Lr=512, Lc=256, Lq=64, Ld=32, dropout
   0.1, flash attention, the flagship AdamW / clip / schedule) at batch 8,
   the flagship ``--remat --no-remat-towers`` layout, on the same world
   with synthetic question/answer pairs. Prints ms per stage, peak memory,
   the metrics of each step and each kernel's launch count during the
   steps; checks the metrics are finite, the gradient norm positive and
   the parameters moved once the learning rate is non-zero.
   ``--profile`` adds a fourth step under ``torch.profiler`` and prints its
   top device kernels.

Every failure propagates (non-zero exit). The second-to-last line is the
kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA device; without one it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_INDEX = 1_310_720
SEED = 1234
# forward kernels, bf16 output: max / mean abs error relative to the
# largest |reference output| (the readings are about one bf16 ulp of it)
FWD_TOL = (2e-2, 2e-3)
# backward kernels: bf16 gradients, dS and the dropped probabilities rounded
# to bf16 for the products -> max / mean abs error relative to the largest
# reference gradient
GRAD_TOL = (2e-2, 2e-3)
LSE_TOL = 1e-3                 # abs error of K2's fp32 lse
RATE = 0.1                     # attention dropout of the flagship recipe
DROP_SEED = 0x5EED


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median ms of ``reps`` runs of ``fn``, each between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def k1_phase(dev, gen):
    from emdr2_tpu_torch.ops.fid_attention import (
        flash_self_attention, flash_self_attention_reference)
    rows = []
    for B, L in ((8, 64), (400, 512)):
        qkv = torch.randn(B, L, 3 * 768, device=dev, generator=gen
                          ).to(torch.bfloat16)
        lens = torch.randint(1, L + 1, (B,), device=dev, generator=gen)
        bias = torch.where(torch.arange(L, device=dev)[None, :] < lens[:, None],
                           0.0, -1e9).float()
        got = flash_self_attention(qkv, bias, 12)
        torch.cuda.synchronize()
        want = flash_self_attention_reference(qkv, bias, 12)
        max_err, mean_err, ref = _check(f"K1 [{B}, {L}]", got, want,
                                        FWD_TOL)
        ms = time_ms(lambda: flash_self_attention(qkv, bias, 12))
        plain_ms = time_ms(lambda: flash_self_attention_reference(qkv, bias,
                                                                  12))
        flop = 4 * B * 12 * L * L * 64
        log(f"K1 flash_self_attention [{B}, {L}, 2304] bf16: max_abs_err "
            f"{max_err:.3e} mean_abs_err {mean_err:.3e} (tol {FWD_TOL} x "
            f"max|ref| {ref:.3e}) | kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.2f} TFLOP/s) | plain {plain_ms:.4f} ms")
        rows.append(dict(B=B, L=L, max_abs_err=max_err, ms=ms,
                         plain_ms=plain_ms))
        del qkv, bias, got, want
    return rows


def _errors(got, want):
    err = (got.float() - want.float()).abs()
    return err.max().item(), err.mean().item()


def _check(name, got, want, tol=GRAD_TOL):
    """max / mean abs error and max|want|; fails beyond ``tol`` times the
    largest |want|."""
    max_err, mean_err = _errors(got, want)
    ref = want.float().abs().max().item() or 1.0
    if not (torch.isfinite(got.float()).all() and max_err <= tol[0] * ref
            and mean_err <= tol[1] * ref):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max {max_err} mean {mean_err} (ref {ref})")
    return max_err, mean_err, ref


def _self_inputs(dev, gen, B, L):
    qkv = torch.randn(B, L, 3 * 768, device=dev, generator=gen
                      ).to(torch.bfloat16)
    lens = torch.randint(1, L + 1, (B,), device=dev, generator=gen)
    bias = torch.where(torch.arange(L, device=dev)[None, :] < lens[:, None],
                       0.0, -1e9).float()
    dout = torch.randn(B, L, 768, device=dev, generator=gen
                       ).to(torch.bfloat16)
    return qkv, bias, dout


def k1_dropout_phase(dev, gen):
    """K1 forward with the flagship attention dropout at [400, 512]."""
    from emdr2_tpu_torch.ops.fid_attention import (
        flash_self_attention, flash_self_attention_reference)
    qkv, bias, _ = _self_inputs(dev, gen, 400, 512)
    got = flash_self_attention(qkv, bias, 12, DROP_SEED, RATE)
    torch.cuda.synchronize()
    want = flash_self_attention_reference(qkv, bias, 12, DROP_SEED, RATE)
    max_err, mean_err, ref = _check(f"K1 dropout {RATE}", got, want, FWD_TOL)
    ms = time_ms(lambda: flash_self_attention(qkv, bias, 12, DROP_SEED,
                                              RATE))
    plain_ms = time_ms(lambda: flash_self_attention_reference(
        qkv, bias, 12, DROP_SEED, RATE), reps=5, warmup=1)
    log(f"K1 flash_self_attention [400, 512, 2304] bf16 dropout {RATE}: "
        f"max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} (tol "
        f"{FWD_TOL} x max|ref| {ref:.3e}) | kernel {ms:.4f} ms | plain "
        f"{plain_ms:.4f} ms")
    return dict(B=400, L=512, max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def k1_bwd_phase(dev, gen, check_rows=32):
    """K1 backward at the towers' and the reader's shapes, dropout 0.1:
    gradients held against the plain backward on the first ``check_rows``
    rows (its fp32 [B, nh, L, L] tensors), both timed on all rows."""
    from emdr2_tpu_torch.ops.fid_attention import (
        flash_self_attention_backward, flash_self_attention_bwd_reference,
        flash_self_attention_forward)
    rows = []
    for B, L in ((8, 64), (400, 256), (400, 512)):
        qkv, bias, dout = _self_inputs(dev, gen, B, L)
        out, stats = flash_self_attention_forward(qkv, bias, 12, DROP_SEED,
                                                  RATE)

        def kernel():
            return flash_self_attention_backward(qkv, bias, out, dout, 12,
                                                 DROP_SEED, RATE, stats)

        def plain():
            return flash_self_attention_bwd_reference(qkv, bias, out, dout,
                                                      12, DROP_SEED, RATE)

        got = kernel()
        torch.cuda.synchronize()
        n = min(B, check_rows)
        want = flash_self_attention_bwd_reference(
            qkv[:n], bias[:n], out[:n], dout[:n], 12, DROP_SEED, RATE)
        max_err, mean_err, ref = _check(f"K1-bwd [{B}, {L}]", got[:n],
                                             want)
        if not torch.equal(kernel(), got):
            raise AssertionError(f"K1-bwd [{B}, {L}] is not deterministic")
        del want
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        flop = 2.5 * 4 * B * 12 * L * L * 64
        log(f"K1-bwd flash_self_attention_backward [{B}, {L}, 2304] dropout "
            f"{RATE}: max_abs_err {max_err:.3e} mean_abs_err {mean_err:.3e} "
            f"(rows 0..{n - 1}; tol {GRAD_TOL} x max|ref| {ref:.3e}), "
            f"repeat bit-identical | kernel {ms:.4f} ms "
            f"({flop / ms / 1e9:.2f} TFLOP/s by 2.5 x 4*L^2*hd) | plain "
            f"{plain_ms:.4f} ms")
        rows.append(dict(B=B, L=L, max_abs_err=max_err, ms=ms,
                         plain_ms=plain_ms))
        del qkv, bias, dout, out, stats, got
        torch.cuda.empty_cache()
    return rows


def k2_phase(dev, gen):
    """K2 forward and backward at the reader shape (8 x 32 queries over
    25,600 keys in 512-key chunks, the last document's keys padded) and the
    teacher shape (400 x 32 over 512), dropout 0 and 0.1."""
    from emdr2_tpu_torch.ops import fid_attention as fa
    rows = []
    for name, B, Lk in (("reader", 8, 25_600), ("teacher", 400, 512)):
        q = torch.randn(B, 32, 768, device=dev, generator=gen
                        ).to(torch.bfloat16)
        kv = torch.randn(B, Lk, 1536, device=dev, generator=gen
                         ).to(torch.bfloat16)
        real = torch.randint(Lk // 2, Lk - 100, (B,), device=dev,
                             generator=gen)
        bias = torch.where(torch.arange(Lk, device=dev)[None, :]
                           < real[:, None], 0.0, -1e9).float()
        dout = torch.randn(B, 32, 768, device=dev, generator=gen
                           ).to(torch.bfloat16)
        for rate in (0.0, RATE):
            seed = DROP_SEED if rate else None
            out, lse = fa.flash_cross_attention_forward(q, kv, bias, 12, 512,
                                                        seed, rate)
            torch.cuda.synchronize()
            w_out, w_lse = fa.flash_cross_attention_reference(
                q, kv, bias, 12, 512, seed, rate)
            f_max, f_mean, f_ref = _check(f"K2-fwd {name} rate {rate}", out,
                                          w_out, FWD_TOL)
            lse_err = (lse - w_lse).abs().max().item()
            if lse_err > LSE_TOL:
                raise AssertionError(f"K2-fwd {name} rate {rate}: lse error "
                                     f"{lse_err}")
            dq, dkv = fa.flash_cross_attention_backward(
                q, kv, bias, w_lse, w_out, dout, 12, 512, seed, rate)
            torch.cuda.synchronize()
            w_dq, w_dkv = fa.flash_cross_attention_bwd_reference(
                q, kv, bias, w_lse, w_out, dout, 12, 512, seed, rate)
            dq_err = _check(f"K2-bwd dq {name}", dq, w_dq)
            dkv_err = _check(f"K2-bwd dkv {name}", dkv, w_dkv)
            again = fa.flash_cross_attention_backward(
                q, kv, bias, w_lse, w_out, dout, 12, 512, seed, rate)
            if not (torch.equal(again[0], dq) and torch.equal(again[1], dkv)):
                raise AssertionError(f"K2-bwd {name} is not deterministic")
            del w_dq, w_dkv, again
            ms = time_ms(lambda: fa.flash_cross_attention_forward(
                q, kv, bias, 12, 512, seed, rate))
            plain_ms = time_ms(lambda: fa.flash_cross_attention_reference(
                q, kv, bias, 12, 512, seed, rate), reps=3, warmup=1)
            bwd_ms = time_ms(lambda: fa.flash_cross_attention_backward(
                q, kv, bias, w_lse, w_out, dout, 12, 512, seed, rate))
            bwd_plain_ms = time_ms(
                lambda: fa.flash_cross_attention_bwd_reference(
                    q, kv, bias, w_lse, w_out, dout, 12, 512, seed, rate),
                reps=3, warmup=1)
            kv_gb = kv.numel() * 2 / 1e9
            log(f"K2 flash_cross_attention {name} [{B}, 32 x {Lk}] rate "
                f"{rate}: fwd max_abs_err {f_max:.3e} mean {f_mean:.3e} (tol "
                f"{FWD_TOL} x max|ref| {f_ref:.3e}) lse {lse_err:.3e} | bwd dq max {dq_err[0]:.3e} mean "
                f"{dq_err[1]:.3e}, dkv max {dkv_err[0]:.3e} mean "
                f"{dkv_err[1]:.3e} (tol {GRAD_TOL} x max|ref|), repeat "
                f"bit-identical | fwd kernel {ms:.4f} ms "
                f"({kv_gb / ms * 1e3:.1f} GB/s of kv) plain {plain_ms:.4f} ms"
                f" | bwd kernel "
                f"{bwd_ms:.4f} ms ({2 * kv_gb / bwd_ms * 1e3:.1f} GB/s of kv + "
                f"dkv) plain {bwd_plain_ms:.4f} ms")
            rows.append(dict(shape=name, rate=rate, max_abs_err=f_max,
                             bwd_max_abs_err=max(dq_err[0], dkv_err[0]),
                             ms=ms, plain_ms=plain_ms, bwd_ms=bwd_ms,
                             bwd_plain_ms=bwd_plain_ms))
            del out, lse, w_out, w_lse, dq, dkv
        del q, kv, bias, dout
        torch.cuda.empty_cache()
    return rows



def k3_phase(dev, gen):
    from emdr2_tpu_torch.ops import mips
    rows = []
    n_valid = N_INDEX - 1000
    emb = torch.randn(N_INDEX, 768, device=dev, generator=gen)
    emb[n_valid:] = 0.0
    stored = {"bf16": emb.to(torch.bfloat16)}
    stored["int8"] = mips.quantize_int8(emb, 128)
    del emb
    for name in ("bf16", "int8"):
        for nq in (8, 512):
            qf = torch.randn(nq, 768, device=dev, generator=gen)
            if name == "bf16":
                index, scales = stored["bf16"], None
                q = qf.to(torch.bfloat16)
            else:
                index, scales = stored["int8"]
                qs = qf.abs().amax(dim=1).clamp(min=1e-30) / 127.0
                q = torch.clamp(torch.round(qf / qs[:, None]), -127,
                                127).to(torch.int8)
            gv, gi = mips.candidate_scan(q, index, n_valid, 128, 2)
            torch.cuda.synchronize()
            wv, wi = mips.candidate_scan_reference(q, index, n_valid, 128, 2)
            if name == "int8":
                ok = torch.equal(gv, wv) and torch.equal(gi, wi)
                max_err = (gv - wv).abs().max().item()
            else:
                ok = bool(((gv - wv).abs() <= 1e-3 * wv.abs() + 1e-3).all())
                max_err = (gv - wv).abs().max().item()
            id_agree = (gi == wi).float().mean().item()
            del gv, gi, wv, wi
            ms = time_ms(lambda: mips.candidate_scan(q, index, n_valid, 128,
                                                     2))
            plain_ms = time_ms(lambda: mips.candidate_scan_reference(
                q, index, n_valid, 128, 2), reps=10, warmup=1)
            nbytes = index.numel() * index.element_size()
            # top-50 recall of the whole search vs exact fp32 over the
            # stored rows (rows past n_valid excluded)
            vals, ids = mips.mips_topk(qf, index, 50, n_valid=n_valid,
                                       shard_scales=scales)
            rows_f = (index.float() if scales is None
                      else mips.dequantize_int8(index, scales, 128))
            qe = qf.to(torch.bfloat16).float() if scales is None else qf
            exact = torch.matmul(qe, rows_f[:n_valid].T)
            oracle = torch.topk(exact, 50, dim=1).indices
            del rows_f, exact
            recall, collided = recall_at(ids, oracle)
            log(f"K3 candidate_scan {name} nq={nq} N={N_INDEX}: "
                f"{'equal' if name == 'int8' else 'within 1e-3*|v|+1e-3'}="
                f"{ok} max_abs_err {max_err:.3e} id_agreement {id_agree:.6f} "
                f"| kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s of "
                f"3350 GB/s data sheet) | plain {plain_ms:.4f} ms | "
                f"recall@50 {recall:.6f} (misses {collided[0]}, of them in "
                f"a group holding >= 3 of the true top-50: {collided[1]})")
            if not ok:
                raise AssertionError(f"K3 {name} nq={nq} disagrees")
            # per-group top-2 loses a row only when three true winners share
            # a 128-row group (~2e-4 per query at k=50, N=1.31M): the serving
            # batch must be exact, and any miss at nq=512 must be such one
            if (nq <= 8 and recall != 1.0) or collided[0] != collided[1]:
                raise AssertionError(f"K3 {name} nq={nq} recall {recall}, "
                                     f"misses {collided}")
            rows.append(dict(dtype=name, nq=nq, max_abs_err=max_err, ms=ms,
                             plain_ms=plain_ms, gbps=nbytes / ms / 1e6,
                             recall=recall))
    del stored
    return rows


def recall_at(ids, oracle, group=128):
    """Mean recall of ``ids`` against ``oracle`` (rows of equal length), and
    (misses, misses whose group holds >= 3 oracle rows)."""
    hits, misses, collided = 0, 0, 0
    for got, want in zip(ids.tolist(), oracle.tolist()):
        groups = [w // group for w in want]
        for w in set(want) - set(got):
            misses += 1
            collided += groups.count(w // group) >= 3
        hits += len(set(got) & set(want))
    return hits / oracle.numel(), (misses, collided)


def make_world(cfg, tmpdir, dev, gen, n_docs=20_000, n_rows=N_INDEX):
    """Tokenizer with the published vocab sizes, a synthetic corpus of
    ``n_docs`` passages on disk, and an ``n_rows`` index made on ``dev``."""
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.indexed_dataset import (
        MMapIndexedDataset, MMapIndexedDatasetBuilder)
    from emdr2_tpu_torch.data.tokenizer import BertWordPieceTokenizer, toy_vocab
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex

    words = ["what", "is", "the", "color", "of", "item"]
    base = len(toy_vocab(words))
    # fill the vocab to 70 below the retriever's padded vocab (BERT's 30522
    # entries for the published 30592), so the T5 tokenizer (+2 specials,
    # +100 sentinel ids) pads to the reader's published 30720
    n_words = cfg.retriever.encoder.vocab_size - 70 - base
    vocab = toy_vocab(words + [f"w{i}" for i in range(n_words)])
    tok = BertWordPieceTokenizer(vocab, vocab_extra_ids=100)
    rng = np.random.RandomState(SEED)
    lo, hi = base, len(vocab)
    text_p, title_p = os.path.join(tmpdir, "text"), os.path.join(tmpdir,
                                                                 "title")
    with MMapIndexedDatasetBuilder(text_p) as b:
        for n in rng.randint(90, 140, size=n_docs):
            b.add_item(rng.randint(lo, hi, size=n).tolist())
    with MMapIndexedDatasetBuilder(title_p) as b:
        for i in range(n_docs):      # three passages per title
            b.add_item([lo + (i // 3) % (hi - lo), lo + 7])
    corpus = EvidenceCorpus(MMapIndexedDataset(text_p),
                            MMapIndexedDataset(title_p))
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


def slice_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
                n_questions=16):
    """Drive QAPipeline.ask; returns {"launches", "stage_ms", ...}."""
    from emdr2_tpu_torch.data.qa_dataset import encode_question
    from emdr2_tpu_torch.models import EMDR2Model
    from emdr2_tpu_torch.ops import fid_attention, mips
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
        fid_attention.flash_self_attention.launches = 0
        mips.candidate_scan.launches = 0
        t0 = time.perf_counter()
        answers = pipe.ask(questions)
        ask_s = time.perf_counter() - t0
        launches = {"flash_self_attention":
                    fid_attention.flash_self_attention.launches,
                    "candidate_scan": mips.candidate_scan.launches}
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
    return dict(answers=answers, launches=launches, stage_ms=dict(timer.ms),
                ask_s=ask_s, peak_bytes=peak)


def train_phase(cfg, dev, gen, n_rows=N_INDEX, n_docs=20_000, batch=8,
                steps=3, total_iters=1000, profile=False):
    """Drive ``E2EQATask.train_step``; returns {"metrics", "launches",
    "stage_ms", ...}. The flagship schedule warms up over 1% of
    ``total_iters``, so the first update's lr is 0 and the later ones are
    not."""
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.ops import fid_attention as fa
    from emdr2_tpu_torch.ops import mips
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training.step import METRICS
    from emdr2_tpu_torch.utils.timing import StageTimer

    counters = {"flash_self_attention": fa.flash_self_attention,
                "flash_self_attention_backward":
                    fa.flash_self_attention_backward,
                "flash_cross_attention": fa.flash_cross_attention,
                "flash_cross_attention_backward":
                    fa.flash_cross_attention_backward,
                "candidate_scan": mips.candidate_scan}
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
        for fn in counters.values():
            fn.launches = 0
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
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        top = profile_step(task, next(batches)) if profile else None
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


def profile_step(task, batch, n_top=15):
    """One warm train step under torch.profiler: (device ms summed over
    kernels, wall ms, the top kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # kernels only: an operator's row repeats the device time of the
    # kernels it launched; a kernel's own row has no CPU time
    events = [e for e in prof.key_averages()
              if dev_us(e) > 0 and e.self_cpu_time_total == 0]
    events.sort(key=dev_us, reverse=True)
    total_ms = sum(dev_us(e) for e in events) / 1e3
    top = [(e.key, dev_us(e) / 1e3, e.count) for e in events[:n_top]]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "train_step_profile.txt"),
              "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    return dict(device_ms=total_ms, wall_ms=wall_ms, top=top)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm train step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from emdr2_tpu_torch.config import EMDR2Config, IndexConfig
    from emdr2_tpu_torch.config import with_flash_attention, with_transformers
    from emdr2_tpu_torch.ops import build

    card = gpu_name_and_power()
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

    info = build.build(extra_flags=("-Xptxas", "-v"))
    log(f"kernel build: {info['seconds']:.1f} s (built={info['built']}) "
        f"-> {os.path.relpath(info['path'], REPO)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas:", line.strip())

    k1 = k1_phase(dev, gen)
    k1_drop = k1_dropout_phase(dev, gen)
    k1_bwd = k1_bwd_phase(dev, gen)
    k2 = k2_phase(dev, gen)
    k3 = k3_phase(dev, gen)
    torch.cuda.empty_cache()

    cfg = with_flash_attention(EMDR2Config(index=IndexConfig(quantize="int8")))
    res = slice_phase(cfg, dev, gen)
    for name, ms in res["stage_ms"].items():
        log(f"slice stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms per batch")
    log(f"slice ask: {len(res['answers'])} answers in {res['ask_s']:.3f} s, "
        f"peak memory {res['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{res['launches']}; first answers {res['answers'][:2]!r}")
    for name, n in res["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched during ask")
    gc.collect()
    torch.cuda.empty_cache()

    # the flagship recipe: --remat --no-remat-towers (reader stacks
    # checkpointed, towers stored), dropout 0.1 (the config defaults)
    tcfg = with_transformers(cfg, {"remat": False}, {"remat": True})
    tr = train_phase(tcfg, dev, gen, batch=8, profile=args.profile)
    for name, ms in tr["stage_ms"].items():
        log(f"train stage {name}: " + ", ".join(f"{m:.2f}" for m in ms)
            + " ms per step")
    log(f"train: peak memory {tr['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"during {len(tr['metrics'])} steps {tr['launches']}")
    for name, n in tr["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name} never launched during the steps")
    if tr["top"] is not None:
        p = tr["top"]
        busy = p["device_ms"] / p["wall_ms"]
        log(f"profiled warm step: wall {p['wall_ms']:.1f} ms, device kernels "
            f"{p['device_ms']:.1f} ms (busy {busy:.3f})")
        for key, ms, count in p["top"]:
            log(f"  {ms:10.3f} ms  {count:6d}x  {key[:100]}")

    k1_main = k1[-1]                                   # [400, 512, 2304]
    k1_bwd_main = k1_bwd[-1]                           # [400, 512]
    k2_main = next(r for r in k2 if r["shape"] == "reader"
                   and r["rate"] == RATE)
    k3_main = next(r for r in k3 if r["dtype"] == "int8" and r["nq"] == 8)
    serve, train = res["launches"], tr["launches"]
    csrc = "emdr2_tpu_torch/ops/csrc/"
    summary = {"kernels": [
        {"name": "flash_self_attention", "route": "cuda",
         "source": csrc + "flash_self_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:383",
         "launches": serve["flash_self_attention"],
         "launches_train": train["flash_self_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k1 + [k1_drop]),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "ms_dropout": k1_drop["ms"], "plain_ms_dropout": k1_drop["plain_ms"]},
        {"name": "flash_self_attention_backward", "route": "cuda",
         "source": csrc + "flash_self_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:414",
         "launches": train["flash_self_attention_backward"],
         "max_abs_err": max(r["max_abs_err"] for r in k1_bwd),
         "ms": k1_bwd_main["ms"], "plain_ms": k1_bwd_main["plain_ms"]},
        {"name": "flash_cross_attention", "route": "cuda",
         "source": csrc + "flash_cross_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:562",
         "launches": train["flash_cross_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k2),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"]},
        {"name": "flash_cross_attention_backward", "route": "cuda",
         "source": csrc + "flash_cross_attention.cu",
         "replaces": "emdr2_tpu/ops/fid_attention.py:612",
         "launches": train["flash_cross_attention_backward"],
         "max_abs_err": max(r["bwd_max_abs_err"] for r in k2),
         "ms": k2_main["bwd_ms"], "plain_ms": k2_main["bwd_plain_ms"]},
        {"name": "candidate_scan", "route": "cuda",
         "source": csrc + "candidate_scan.cu",
         "replaces": "emdr2_tpu/ops/mips.py:116",
         "launches": serve["candidate_scan"],
         "launches_train": train["candidate_scan"],
         "max_abs_err": max(r["max_abs_err"] for r in k3),
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"]},
    ]}
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
