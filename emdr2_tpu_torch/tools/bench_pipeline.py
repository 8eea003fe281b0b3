"""The stages of a training iteration around the step, on one card's share
of the index (port of ``emdr2_tpu/tools/bench_pipeline.py``).

The train step (stage C) is timed by the other tools; this one times the
two stages before it on a synthetic world of one card:

  stage A   the BERT-base query tower's CLS embedding -> ``mips_topk`` at
            K+1 over the resident index (``flagship.SHARD_ROWS`` x 768
            rows, bf16) -> the rows read back to the host
  stage B   ``data/postprocess.py`` (the port's C++ ``native/store_ops``):
            B*K reader, teacher and context rows with neighbour windows

over a synthetic corpus of ``--n-docs`` pre-tokenized passages (two
passages a title, so neighbour windows exist), written once into
``.bench_cache/`` (git-ignored) and memory-mapped afterwards. Prints one
JSON line with the ms of each stage. Other modes:

  --refresh       ``ShardedEvidenceIndex.update`` at the shard's size:
                  from a host array, and from tensors already on the card
                  (the refresher's zero-copy swap)
  --embed         ``EvidenceIndexBuilder.embed_corpus_device``: passages/s
                  of the context tower over at most 65,536 passages
  --overlap       the iteration with the prefetcher (``BatchPrefetcher``):
                  stages A and B of the next batch beside the step, against
                  the serial A -> B -> C loop and the bare step (int8 index)
  --decode        FiD encode + greedy decode (and beam 5) of a batch
  --decode-sweep  the decode path's encode / token-loop split at batches 4
                  to 32 (bf16 stored weights, int8 cross K/V), each row in
                  a process of its own

Runs on the card unless ``--device cpu``:

    python -m emdr2_tpu_torch.tools.bench_pipeline [--batch 4] [--topk 50]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

from emdr2_tpu_torch.tools import flagship

MODULE = "emdr2_tpu_torch.tools.bench_pipeline"
CACHE = flagship.REPO / ".bench_cache"
CLS, SEP, PAD = 2, 3, 0


def token_high(cfg, high: int = 25000) -> int:
    """Token ids are drawn below ``high`` and below both vocabularies."""
    return min(high, cfg.retriever.encoder.vocab_size,
               cfg.reader.transformer.vocab_size)


def build_world(cache: pathlib.Path, n_docs: int, doc_len: int = 30,
                title_len: int = 4):
    """An ``EvidenceCorpus`` of ``n_docs`` random passages, two a title,
    written under ``cache`` on first use and memory-mapped."""
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.indexed_dataset import (
        MMapIndexedDataset, MMapIndexedDatasetBuilder)

    high = token_high(flagship.base_config())
    text_p = str(cache / f"text_{n_docs}_{high}")
    title_p = str(cache / f"title_{n_docs}_{high}")
    if not os.path.exists(title_p + ".idx"):
        rng = np.random.RandomState(0)
        toks = rng.randint(5, high, size=(n_docs, doc_len)).astype(np.int32)
        with MMapIndexedDatasetBuilder(text_p) as b:
            for row in toks:
                b.add_item(row)
        # two docs share each title -> 2-passage neighbour windows
        ttoks = rng.randint(5, high, size=(n_docs // 2, title_len)
                            ).astype(np.int32)
        with MMapIndexedDatasetBuilder(title_p) as b:
            for i in range(n_docs):
                b.add_item(ttoks[i // 2])
    return EvidenceCorpus(MMapIndexedDataset(text_p),
                          MMapIndexedDataset(title_p))


def query_tower(device, seed: int = 0):
    """The BERT-base query tower (the configuration's encoder, flash
    attention on the card) with weights from ``seed``."""
    import dataclasses

    from emdr2_tpu_torch.models.bert import BertEncoder
    from emdr2_tpu_torch.models.layers import init_weights
    enc_cfg = dataclasses.replace(flagship.base_config().retriever.encoder,
                                  fid_flash_attention=device.type == "cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    enc = BertEncoder(enc_cfg, device)
    init_weights(enc, gen)
    return enc


def bench_refresh(n_docs: int, device, iters: int = 3) -> dict:
    """The swap of the index at the shard's size, by both paths of
    ``ShardedEvidenceIndex.update``: a host fp32 array (quantized or cast
    and copied to the card; measured once) and a bf16 tensor already on
    the card (the refresher's zero-copy path), each until the swapped-in
    rows exist on the card."""
    from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex

    cfg = flagship.base_config().index
    d = cfg.embed_dim
    host = np.random.default_rng(0).standard_normal((n_docs, d),
                                                   dtype=np.float32)
    index = ShardedEvidenceIndex(cfg, host, device=device)

    def fence():
        index.embeddings[:1, :1].float().sum().item()

    fence()
    t0 = time.perf_counter()
    index.update(host)
    fence()
    host_ms = (time.perf_counter() - t0) * 1000

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    slabs = [torch.randn(index.n_padded, d, generator=gen, device=device,
                         dtype=torch.bfloat16) for _ in range(iters)]
    flagship.sync(device)
    t0 = time.perf_counter()
    for s in slabs:
        index.update(s)
        fence()
    dev_ms = (time.perf_counter() - t0) / iters * 1000
    return {"rows": index.n_padded,
            "update_host_ms": round(host_ms, 1),
            "swap_device_ms": round(dev_ms, 1)}


def bench_embed(corpus, device, batch_size: int = 512) -> dict:
    """Passages/s of ``EvidenceIndexBuilder.embed_corpus_device`` (the
    refresher's zero-copy path: C++ row formatting, the copy to the card,
    the context tower's forward, the rows placed on the card) over
    ``corpus``, the second of two passes; and the time a pass over the
    card's shard and over the 21M-passage corpus on 8 embedder cards would
    take at that rate."""
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder

    cfg = flagship.base_config()
    enc = query_tower(device)       # a context tower has the same shapes
    builder = EvidenceIndexBuilder(cfg, enc, corpus, cls_id=CLS, sep_id=SEP,
                                   pad_id=PAD, batch_size=batch_size)
    n = len(corpus)
    buf = builder.embed_corpus_device(enc, n)
    flagship.sync(device)
    del buf
    t0 = time.perf_counter()
    buf = builder.embed_corpus_device(enc, n)
    flagship.sync(device)
    wall = time.perf_counter() - t0
    pps = n / wall
    return {
        "batch_size": builder.batch_size,
        "n_docs": n,
        "mesh_devices": 1,
        "passages_per_sec_per_chip": round(pps, 1),
        "ms_per_batch": round(wall / -(-n // builder.batch_size) * 1e3, 2),
        "shard_1p31M_refresh_s": round(1_310_720 / pps, 1),
        "full_21M_8chip_refresh_s": round(21_015_324 / (8 * pps), 1),
    }


def _stage_b(corpus, cfg, B: int, K: int, rng):
    """``postprocess_retrieved`` with this tool's synthetic questions:
    fn(topk_passage_ids) -> ``PostprocessedBatch``."""
    from emdr2_tpu_torch.data.postprocess import postprocess_retrieved
    qt5 = rng.randint(5, token_high(cfg), size=(B, 64)).astype(np.int32)
    return functools.partial(
        postprocess_retrieved, query_uids=-np.arange(1, B + 1),
        query_t5_ids=qt5, query_t5_lens=np.full(B, 24, np.int32),
        corpus=corpus, topk=K, retriever_seq_len=cfg.retriever.seq_len,
        reader_seq_len=cfg.reader.seq_len, cls_id=CLS, sep_id=SEP,
        pad_id=PAD)


def bench_overlap(corpus, B: int, K: int, device, iters: int = 8) -> dict:
    """ms of an iteration with the prefetch pipeline (stage A over an int8
    index of ``len(corpus)`` rows + stage B of batch N+1 on the
    prefetcher's thread and stream while step N runs) against the serial A
    -> B -> C loop and the bare step (``flagship.make_flagship_step``)."""
    from emdr2_tpu_torch.models.decoding import bf16_eval_params
    from emdr2_tpu_torch.models.emdr2 import EMDR2Batch
    from emdr2_tpu_torch.ops.mips import mips_topk, quantize_int8
    from emdr2_tpu_torch.training.prefetch import BatchPrefetcher

    step_fn, state, proto = flagship.make_flagship_step(B, K, device=device)
    cfg = flagship.base_config()
    icfg = cfg.index
    rng = np.random.RandomState(3)
    n_docs = len(corpus)
    Lq = proto.query_bert_ids.shape[1]
    qids_h = rng.randint(5, token_high(cfg), size=(B, Lq)).astype(np.int32)
    # stage A selects only (the step recomputes the scores from the fp32
    # parameters): the tower's kernels stored in bf16, as evaluation does
    enc = bf16_eval_params(query_tower(device))

    g = icfg.group_size
    if n_docs % g:
        raise ValueError(f"--n-docs must be a multiple of the quantization "
                         f"group size {g}")
    gen = torch.Generator(device=device)
    gen.manual_seed(100)
    shard = torch.empty((n_docs, icfg.embed_dim), dtype=torch.int8,
                        device=device)
    scales = torch.empty(n_docs // g, dtype=torch.float32, device=device)
    chunk = max(g, n_docs // 8 // g * g)
    for s in range(0, n_docs, chunk):
        e = torch.randn(min(chunk, n_docs - s), icfg.embed_dim,
                        generator=gen, device=device, dtype=torch.bfloat16)
        shard[s:s + e.shape[0]], scales[s // g:(s + e.shape[0]) // g] = \
            quantize_int8(e, g)
    post = _stage_b(corpus, cfg, B, K, rng)

    class _Task:
        def __init__(self):
            self.device = device

        @torch.inference_mode()
        def stage_a(self, qids):
            q = torch.as_tensor(qids, dtype=torch.long).to(device)
            emb = enc.embed(q)
            _, rows = mips_topk(emb.to(torch.bfloat16), shard, K + 1,
                                chunk_rows=icfg.chunk_rows,
                                group_size=icfg.group_size,
                                cands_per_group=icfg.cands_per_group,
                                shard_scales=scales)
            return rows.cpu().numpy() + 1       # row -> 1-based passage id

        def build_device_batch(self, qids):
            p = post(topk_passage_ids=self.stage_a(qids))

            def dev(a):
                return torch.as_tensor(a, dtype=torch.long).to(device)
            return EMDR2Batch(
                query_bert_ids=dev(qids),
                context_bert_ids=dev(p.context_bert_ids),
                context_bert_types=dev(p.context_bert_types),
                reader_ids=dev(p.reader_ids),
                reader_one_ctx_ids=dev(p.reader_one_ctx_ids),
                dec_ids=proto.dec_ids, labels=proto.labels,
                loss_mask=proto.loss_mask)

    task = _Task()
    step_ms = flagship.seconds_per_call(lambda: step_fn(state, proto), 3,
                                        device) * 1000
    serial_ms = flagship.seconds_per_call(
        lambda: step_fn(state, task.build_device_batch(qids_h)), iters,
        device) * 1000

    feed = BatchPrefetcher(task, iter([qids_h] * (iters + 1)), depth=1)
    try:
        step_fn(state, next(feed))              # the first batch: no overlap
        flagship.sync(device)
        t0 = time.perf_counter()
        n = 0
        for db in feed:
            step_fn(state, db)
            n += 1
        flagship.sync(device)
        overlap_ms = (time.perf_counter() - t0) / n * 1000
    finally:
        feed.close()
    return {"step_ms": round(step_ms, 1),
            "serial_iter_ms": round(serial_ms, 1),
            "overlap_iter_ms": round(overlap_ms, 1),
            "overlap_overhead_ms": round(overlap_ms - step_ms, 1)}


def bench_decode(B: int, K: int, device, max_decode_len: int = 32,
                 iters: int = 5, include_beam: bool = True,
                 breakdown: bool = False, bf16_params: bool = False,
                 kv_quant=None) -> dict:
    """Generation latency at the flagship size: the FiD encode of K
    contexts + greedy decode of ``max_decode_len`` tokens over the cached
    cross K/V (``DecoderSession``), the cost of a batch of ``evaluate_em``
    or ``QAPipeline.ask``; then beam 5. ``breakdown`` also times the encode
    (FiD encoder + the cross K/V of every layer) alone and its share of the
    card's peak. ``bf16_params`` stores the kernels in bf16
    (``bf16_eval_params``); ``kv_quant="int8"`` keeps the cross K/V as int8
    rows read by the K5 kernel."""
    from emdr2_tpu_torch.models.decoding import (DecoderSession,
                                                 beam_search_decode,
                                                 bf16_eval_params,
                                                 greedy_decode)
    from emdr2_tpu_torch.models.emdr2 import EMDR2Model

    cfg = flagship.flagship_step_config(B, K)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = EMDR2Model(cfg, device=device, generator=gen)
    # the decode reads the reader ids alone (bench.py's draws)
    batch = flagship.flagship_batch(cfg, B, K, device)
    if bf16_params:
        bf16_eval_params(model)
    session = DecoderSession(model, max_decode_len, kv_quant=kv_quant)
    hyps = None

    def greedy():
        nonlocal hyps
        hyps = greedy_decode(session, batch, bos_id=1, eos_id=0)

    dt = flagship.seconds_per_call(greedy, iters, device)
    assert len(hyps) == B
    out = {"decode_ms_per_batch": round(dt * 1000, 1),
           "questions_per_sec_per_chip": round(B / dt, 2)}
    if breakdown:
        kvs = None

        def encode():
            nonlocal kvs
            kvs = None      # free the previous slab before the next
            kvs = session.encode(batch)
        enc_dt = flagship.seconds_per_call(encode, iters, device)
        del kvs
        # B*K*Lr tokens through the T5 encoder (qkv / out / MLP products
        # and the attention scores) + every layer's cross K/V projections
        t = cfg.reader.transformer
        H, F, L = t.hidden_size, t.ffn_size, cfg.reader.seq_len
        toks = B * K * L
        per_tok = t.num_layers * 2 * (H * 3 * H + H * H + 2 * H * F
                                      + 2 * L * H)
        kv_flops = t.num_layers * 2 * toks * H * 2 * H
        enc_flops = toks * per_tok + kv_flops
        out["encode_ms"] = round(enc_dt * 1000, 1)
        out["token_loop_ms"] = round((dt - enc_dt) * 1000, 1)
        out["encode_model_tflops"] = round(enc_flops / 1e12, 1)
        out["encode_mfu"] = flagship.share_of_peak(
            enc_flops, enc_dt, flagship.peak_flops(device))
    if not include_beam:
        return out

    hb = None

    def beam():
        nonlocal hb
        hb = beam_search_decode(session, batch, bos_id=1, eos_id=0,
                                beam_size=5)
    dtb = flagship.seconds_per_call(beam, iters, device)
    assert len(hb) == B
    out["beam5_ms_per_batch"] = round(dtb * 1000, 1)
    out["beam5_vs_greedy"] = round(dtb / dt, 2)
    return out


# (batch, bf16 stored weights, int8 cross K/V) of the decode sweep
DECODE_SWEEP = ((4, False, None), (4, False, "int8"), (8, True, None),
                (8, True, "int8"), (16, True, "int8"), (32, True, "int8"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--n-docs", type=int, default=flagship.SHARD_ROWS)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--decode", action="store_true",
                   help="also measure FiD encode + greedy decode latency")
    p.add_argument("--decode-sweep", action="store_true",
                   help="batch sweep of the decode path with the "
                        "encode/token-loop breakdown (B in 4/8/16/32)")
    p.add_argument("--decode-sweep-row", default=None,
                   help="internal: run ONE decode-sweep row ('B:bf16:kvq') "
                        "in this process and print its JSON")
    p.add_argument("--overlap", action="store_true",
                   help="also measure the full overlapped iteration "
                        "(prefetch pipeline: stage A+B hidden under step C)")
    p.add_argument("--refresh", action="store_true",
                   help="also measure the index swap at shard scale (host "
                        "update vs zero-copy device swap)")
    p.add_argument("--embed", action="store_true",
                   help="measure corpus-embedding throughput of the "
                        "refresher's zero-copy path (passages/s)")
    p.add_argument("--embed-batch", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="where to run (default the card; 'cpu' to run "
                        "without one)")
    args = p.parse_args(argv)

    from emdr2_tpu_torch.ops.mips import mips_topk
    from emdr2_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    CACHE.mkdir(exist_ok=True)

    if args.decode_sweep_row:
        b, bf16, kvq = args.decode_sweep_row.split(":")
        try:
            row = bench_decode(int(b), args.topk, device,
                               iters=min(5, args.iters), include_beam=False,
                               breakdown=True, bf16_params=bf16 == "1",
                               kv_quant=kvq or None)
        except Exception as e:    # an out-of-memory row is data
            import traceback
            traceback.print_exc()
            row = {"error": f"{type(e).__name__}: {e}"[:160]}
        print(json.dumps(row), flush=True)
        return row

    if args.decode_sweep:
        result = {"topk": args.topk, "decode_sweep": {}}
        for B, bf16, kvq in DECODE_SWEEP:
            key = (f"B{B}" + ("_bf16params" if bf16 else "")
                   + ("_kvint8" if kvq else ""))
            row, failure = flagship.child_row(MODULE, [
                "--decode-sweep-row", f"{B}:{int(bf16)}:{kvq or ''}",
                "--topk", str(args.topk), "--iters", str(args.iters),
                "--device", args.device])
            result["decode_sweep"][key] = (
                row if row is not None
                else {"error": f"row process died {failure}"[:160]})
            print(f"  {key} -> {result['decode_sweep'][key]}",
                  file=sys.stderr, flush=True)
        print(json.dumps(result), flush=True)
        return result

    if args.overlap or args.refresh or args.embed:
        # modes of their own: each holds most of a card at the shard's size
        result = {"n_docs": args.n_docs, "batch": args.batch,
                  "topk": args.topk}
        if args.overlap:
            t0 = time.perf_counter()
            corpus = build_world(CACHE, args.n_docs)
            corpus.neighbour_table()
            result["world_setup_s"] = round(time.perf_counter() - t0, 1)
            result["overlap"] = bench_overlap(corpus, args.batch, args.topk,
                                              device, min(8, args.iters))
        if args.refresh:
            result["refresh"] = bench_refresh(args.n_docs, device,
                                              min(3, args.iters))
        if args.embed:
            # the rate projects linearly to the shard: 65,536 passages keep
            # the tower busy
            corpus = build_world(CACHE, min(args.n_docs, 65_536))
            result["embed"] = bench_embed(corpus, device, args.embed_batch)
            result["n_docs"] = result["embed"]["n_docs"]
        print(json.dumps(result), flush=True)
        return result

    t0 = time.perf_counter()
    corpus = build_world(CACHE, args.n_docs)
    corpus.neighbour_table()            # built once, cached on the corpus
    setup_s = time.perf_counter() - t0

    cfg = flagship.base_config()
    B, K = args.batch, args.topk
    kq = K + 1                          # trivial-doc drop fetches K+1
    rng = np.random.RandomState(1)

    # stage A: the query tower's embedding, the search, the host readback
    enc = query_tower(device)
    qids = torch.as_tensor(rng.randint(
        5, token_high(cfg), size=(B, cfg.retriever.query_seq_len)),
        dtype=torch.long).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    shard = torch.randn(args.n_docs, cfg.index.embed_dim, generator=gen,
                        device=device, dtype=torch.bfloat16)
    pids = None

    @torch.inference_mode()
    def run_a():
        nonlocal pids
        q = enc.embed(qids)
        _, rows = mips_topk(q.to(torch.bfloat16), shard, kq,
                            chunk_rows=cfg.index.chunk_rows,
                            group_size=cfg.index.group_size,
                            cands_per_group=cfg.index.cands_per_group)
        pids = rows.cpu().numpy() + 1   # row -> 1-based passage id

    a_ms = flagship.seconds_per_call(run_a, args.iters, device) * 1000

    # stage B: C++ postprocess of the retrieved ids
    post = _stage_b(corpus, cfg, B, K, rng)
    b_ms = flagship.seconds_per_call(lambda: post(topk_passage_ids=pids),
                                     args.iters, device) * 1000

    result = {
        "n_docs": args.n_docs, "batch": B, "topk": K,
        "stage_a_retrieve_ms": round(a_ms, 2),
        "stage_b_postprocess_ms": round(b_ms, 2),
        "world_setup_s": round(setup_s, 1),
    }
    if args.decode:
        del shard
        result["decode"] = bench_decode(B, K, device,
                                        iters=min(5, args.iters))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
