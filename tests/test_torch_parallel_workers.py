"""The rank processes of tests/test_torch_parallel.py: they import torch and
the port, never jax.

    python tests/test_torch_parallel_workers.py SPEC RANK

``SPEC`` (a ``torch.save``d dict) names the world size, the rendezvous
address (a ``file://`` store), the output directory, the cases to run in
order and their inputs; each case's results go into
``<out>/rank<RANK>.pt`` as {case: results}. Every rank joins one gloo group
on the CPU with a timeout, so a rank that hangs fails its test instead of
stalling the run.
"""

import contextlib
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from emdr2_tpu_torch.parallel import DataParallel  # noqa: E402
from emdr2_tpu_torch.parallel import distributed as dist_lib  # noqa: E402

TIMEOUT_S = 120.0


@contextlib.contextmanager
def one_thread():
    """Run the block on one intra-op thread. A process's first call of
    ``torch.exp`` on the CPU over two threads (PyTorch 2.13, MKL) may run
    one thread's half of the tensor through a less accurate path (errors
    of ~2e-5; seen with several processes at work on the machine), and
    every call after it through the accurate one; on one thread every call
    takes the accurate path. A refresh compares rows from two processes
    at rtol 1e-5, where such a half moves fp16 rows by an ulp."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _world(spec):
    """Tokenizer, corpus and QA dataset of the toy world in ``spec``."""
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.indexed_dataset import MMapIndexedDataset
    from emdr2_tpu_torch.data.qa_dataset import OpenQADataset
    from emdr2_tpu_torch.data.tokenizer import (BertWordPieceTokenizer,
                                                toy_vocab)

    w = spec["world"]
    tok = BertWordPieceTokenizer(toy_vocab(w["words"]), vocab_extra_ids=10)
    corpus = EvidenceCorpus(MMapIndexedDataset(w["text"]),
                            MMapIndexedDataset(w["title"]))
    cfg = spec["cfg"]
    ds = OpenQADataset([w["qa"]], tok,
                       max_seq_length=cfg.retriever.query_seq_len,
                       decoder_seq_length=cfg.reader.decoder_seq_len)
    if w.get("n_examples"):
        ds.examples = ds.examples[:w["n_examples"]]
    return tok, corpus, ds


def _task(spec, dp, cfg=None, index=None):
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks import E2EQATask
    cfg = cfg or spec["cfg"]
    tok, corpus, ds = _world(spec)
    if index is None:
        index = ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu",
                                     dp=dp)
    task = E2EQATask(cfg, tok, corpus, index, total_train_iters=4,
                     device="cpu", dp=dp)
    task.init_state(0, state_dict=spec["params"])
    return task, ds


def case_mips(spec, dp):
    """Each rank's queries against the index its ranks share."""
    import dataclasses

    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    out = {}
    q = torch.as_tensor(spec["mips"]["queries"])
    b = q.shape[0] // dp.world_size
    local = q[dp.rank * b:(dp.rank + 1) * b]
    for quant in ("none", "int8"):
        icfg = dataclasses.replace(spec["mips"]["index_cfg"], quantize=quant)
        index = ShardedEvidenceIndex(icfg, spec["mips"]["rows"],
                                     device="cpu", dp=dp)
        vals, ids = index.search(local, k=spec["mips"]["k"])
        out[quant] = (vals, ids, index.process_row_range(),
                      index.embeddings.shape[0])
    return out


def case_dpr_loss(spec, dp):
    from emdr2_tpu_torch.training.losses import dpr_in_batch_loss
    d = spec["dpr_loss"]
    q, c = torch.as_tensor(d["q"]), torch.as_tensor(d["c"])
    b, cr = q.shape[0] // dp.world_size, c.shape[0] // dp.world_size
    lq = q[dp.rank * b:(dp.rank + 1) * b].clone().requires_grad_(True)
    lc = c[dp.rank * cr:(dp.rank + 1) * cr].clone().requires_grad_(True)
    loss, correct = dpr_in_batch_loss(lq, lc, hidden_size=q.shape[1],
                                      score_scaling=True, dp=dp)
    loss.backward()
    # the global loss: the mean over the ranks; the count: their sum
    both = dp.all_reduce_sum_(torch.stack([loss.detach(), correct]))
    return {"loss": float(both[0]) / dp.world_size, "correct": float(both[1]),
            "grad_q": lq.grad, "grad_c": lc.grad}


class _Recorder:
    def __init__(self, fn):
        self.fn = fn
        self.texts = []

    def __call__(self, metric, prediction, truths):
        self.texts.append(prediction)
        return self.fn(metric, prediction, truths)


def case_openqa(spec, dp):
    """validation_loss, evaluate_em (greedy, beam 3) with the generated
    texts, then two train steps at dropout 0; two more from fresh weights
    at dropout 0.1."""
    from emdr2_tpu_torch.config import with_transformers
    from emdr2_tpu_torch.tasks import e2eqa
    from emdr2_tpu_torch.tasks.e2eqa import _slice_qa_batch
    from emdr2_tpu_torch.training.step import METRICS
    B = spec["batch"]
    out = {}
    task, ds = _task(spec, dp)
    out["val"] = task.validation_loss(ds, batch_size=B, max_batches=2)
    for name, kw in (("greedy", {}), ("beam3", {"beam_size": 3}),
                     ("sample", {"sample": True, "sample_seed": 5 + dp.rank})):
        rec = _Recorder(e2eqa.metric_max_over_ground_truths)
        e2eqa.metric_max_over_ground_truths = rec
        try:
            em = task.evaluate_em(ds, batch_size=B, max_decode_len=4, **kw)
        finally:
            e2eqa.metric_max_over_ground_truths = rec.fn
        out[f"em_{name}"] = (em, rec.texts)
    per = B // dp.world_size
    steps = []
    for batch in list(ds.epoch_batches(B, seed=0))[:2]:
        local = _slice_qa_batch(batch, dp.rank * per, (dp.rank + 1) * per)
        m = task.train_step(local)
        steps.append({k: float(m[k]) for k in METRICS})
    out["steps"] = steps
    out["params"] = {k: v.clone() for k, v in
                     task.state.model.state_dict().items()}
    kw = dict(hidden_dropout=0.1, attention_dropout=0.1)
    dtask, _ = _task(spec, dp, with_transformers(spec["cfg"], kw, kw))
    drop_steps = []
    for batch in list(ds.epoch_batches(B, seed=1))[:2]:
        local = _slice_qa_batch(batch, dp.rank * per, (dp.rank + 1) * per)
        m = dtask.train_step(local)
        drop_steps.append({k: float(m[k]) for k in METRICS})
    out["dropout_steps"] = drop_steps
    out["dropout_params"] = {k: v.clone() for k, v in
                             dtask.state.model.state_dict().items()}
    return out


def case_engine(spec, dp):
    """engine.train for 2 iterations with a save at the end, then a
    restore into a fresh task on every rank."""
    import dataclasses

    from emdr2_tpu_torch.training import checkpointing, engine
    e = spec["engine"]
    cfg = spec["cfg"]
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=spec["batch"], train_iters=2, log_interval=1,
        save_interval=2, eval_interval=100, async_save=False))
    task, ds = _task(spec, dp, cfg)
    writes = []
    write = checkpointing._write

    def counting_write(*args, **kwargs):
        writes.append(args[1])
        return write(*args, **kwargs)

    checkpointing._write = counting_write
    try:
        engine.train(task, ds, cfg, save_dir=e["save"], dp=dp,
                     printer=lambda s: None)
    finally:
        checkpointing._write = write
    saved = {k: v.clone() for k, v in task.state.model.state_dict().items()}
    fresh, _ = _task(spec, dp, cfg)
    _, it = checkpointing.load_checkpoint(e["save"], fresh.state, dp=dp)
    restored = fresh.state.model.state_dict()
    same = all(torch.equal(saved[k], restored[k]) for k in saved)
    adam_a = task.state.optimizer.adamw.state_dict()["state"]
    adam_b = fresh.state.optimizer.adamw.state_dict()["state"]
    same_adam = all(torch.equal(adam_a[i][n], adam_b[i][n])
                    for i in adam_a for n in ("exp_avg", "exp_avg_sq"))
    # two more iterations under the prefetcher of a data-parallel rank
    more = cfg.replace(train=dataclasses.replace(cfg.train, train_iters=4))
    prefetched = engine.train(task, ds, more, prefetch_depth=2, dp=dp,
                              printer=lambda s: None)
    who = [dist_lib.process_index(), dist_lib.process_count(),
           dist_lib.is_coordinator()]
    return {"iteration": it, "params_equal": same, "adam_equal": same_adam,
            "who": who,
            "writes": writes, "prefetched": prefetched,
            "prefetched_params": {k: v.clone() for k, v in
                                  task.state.model.state_dict().items()},
            "params": saved,
            "step": (fresh.state.step, fresh.state.optimizer.count),
            "files": sorted(os.listdir(e["save"]))}


@one_thread()
def case_refresh(spec, dp):
    """A synchronous refresh: each rank embeds its own rows and swaps them
    in; the search after it."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.training.async_refresh import (AsyncIndexRefresher,
                                                        SynchronousRefresher)
    cfg = spec["cfg"]
    tok, corpus, ds = _world(spec)
    index = ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu", dp=dp)
    task, _ = _task(spec, dp, index=index)
    builder = EvidenceIndexBuilder(cfg, task.state.model, corpus, tok.cls_id,
                                   tok.sep_id, tok.pad_id, batch_size=16)
    refresher = SynchronousRefresher(builder, index, reload_interval=1)
    start, stop = index.process_row_range()
    swapped = refresher.maybe_swap(1, task.state.model)
    # the asynchronous refresher over the same group, the same weights
    index2 = ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu", dp=dp)
    refresher2 = AsyncIndexRefresher(builder, index2, reload_interval=1)
    refresher2.start(task.state.model)
    assert refresher2.wait_for_result(timeout=120)
    async_swapped = refresher2.maybe_swap(1, task.state.model)
    refresher2.stop()
    batch = next(ds.epoch_batches(spec["batch"], seed=0, shuffle=False))
    per = spec["batch"] // dp.world_size
    # the global batch's queries, embedded as one process embeds them (a
    # CPU product's bits depend on its rows), then this rank's slice
    q = task.state.model.embed_query(task._ids(batch.query_bert_ids))
    q = q.float()[dp.rank * per:(dp.rank + 1) * per]
    vals, ids = index.search(q.detach(), k=cfg.index.topk)
    return {"swapped": swapped, "row_range": (start, stop),
            "rows": index.embeddings.clone(), "vals": vals, "ids": ids,
            "async_swapped": async_swapped,
            "async_rows": index2.embeddings.clone()}


def case_dpr_task(spec, dp):
    """Two DPRTask steps on each rank's slice of the global batches, then
    ``validate`` merged over the ranks, also of a dev set with a ragged
    tail."""
    from emdr2_tpu_torch.data.tokenizer import (BertWordPieceTokenizer,
                                                toy_vocab)
    from emdr2_tpu_torch.tasks.dense_retriever import DPRDataset, DPRTask
    d = spec["dpr_task"]
    tok = BertWordPieceTokenizer(toy_vocab(d["words"]))
    cfg = d["cfg"]
    kw = dict(query_seq_len=cfg.query_seq_len, ctx_seq_len=cfg.seq_len)
    ranks = dict(rank=dp.rank, world_size=dp.world_size)
    train = DPRDataset(d["path"], tok, hard_negs=1, **kw)
    evald = DPRDataset(d["path"], tok, evaluate=True,
                       val_av_rank_other_neg=2, val_av_rank_hard_neg=2, **kw)
    task = DPRTask(cfg, d["opt"], total_train_iters=10, score_scaling=True,
                   device="cpu", dp=dp)
    task.init_state(0, state_dict=d["params"])
    steps = []
    for batch in list(train.epoch_batches(d["batch"], seed=0, **ranks))[:2]:
        m = task.train_step(batch)
        steps.append({k: float(v) for k, v in m.items()})
    valid = task.validate(evald.epoch_batches(d["batch"], seed=0,
                                              shuffle=False, **ranks))
    # a dev set whose tail batch does not divide over the ranks
    evald.examples = evald.examples[:d["n_tail_dev"]]
    valid_tail = task.validate(evald.epoch_batches(
        d["batch"], seed=0, shuffle=False, drop_last=False, **ranks))
    return {"steps": steps, "valid": valid, "valid_tail": valid_tail,
            "params": {k: v.clone()
                       for k, v in task.model.state_dict().items()}}


def case_recall(spec, dp):
    """``evaluate_recall`` over the sharded index."""
    from emdr2_tpu_torch.data.qa_dataset import read_qa_csv
    from emdr2_tpu_torch.retrieval.evaluate import OpenRetrievalEvaluator
    task, _ = _task(spec, dp)
    tok, corpus, _ = _world(spec)
    ev = OpenRetrievalEvaluator(task.state.model, task.index, tok,
                                spec["cfg"].retriever.query_seq_len,
                                batch_size=4)
    return ev.evaluate_recall(
        read_qa_csv(spec["world"]["qa"]), k=10,
        doc_text_fn=lambda pid: tok.detokenize(corpus.doc_tokens(int(pid))),
        report_at=[1, 5, 10])


def case_embedder(spec, dp):
    """``engine.train`` at ``--dp 2 --embed-devices 2`` (CPU devices stand
    for the cards) with the asynchronous refresher (zero-copy, reload
    interval 1) and the prefetcher at depth 1. Rank 1's embedder is held
    back until its iteration 3, and rank 0 waits for its own result before
    its first boundary, so rank 0 is ready two boundaries before rank 1.
    Records, at every ``maybe_swap`` call, the iteration, whether this
    rank's block was ready and whether the index was swapped; the block
    after the first swap; the losses."""
    import dataclasses
    import threading

    from emdr2_tpu_torch.config import MeshConfig
    from emdr2_tpu_torch.parallel import check_mesh_config, embed_devices
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.training import engine
    from emdr2_tpu_torch.training.async_refresh import AsyncIndexRefresher
    mesh = MeshConfig(dp=dp.world_size, embed_devices=spec["embed_devices"])
    check_mesh_config(mesh, dp.world_size)
    cfg = spec["cfg"]
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=spec["batch"], train_iters=5, log_interval=1,
        save_interval=10 ** 6, eval_interval=10 ** 6))
    tok, corpus, ds = _world(spec)
    index = ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu", dp=dp)
    task, _ = _task(spec, dp, cfg, index=index)
    devices = embed_devices(mesh, dp.rank, torch.device("cpu"))
    builder = EvidenceIndexBuilder(cfg, task.state.model, corpus, tok.cls_id,
                                   tok.sep_id, tok.pad_id, batch_size=16,
                                   devices=devices)
    first = {}

    def on_refresh(step):
        if not first:
            first.update(step=step, rows=index.embeddings.clone())

    # zero-copy on a disjoint embedder, as the command line passes it
    refresher = AsyncIndexRefresher(builder, index, reload_interval=1,
                                    on_refresh=on_refresh,
                                    zero_copy=mesh.embed_devices > 0)
    gate = threading.Event()
    if dp.rank == 0:
        gate.set()
    embed = builder.embed_corpus_device

    def gated(*args, **kw):
        assert gate.wait(120)
        return embed(*args, **kw)

    builder.embed_corpus_device = gated
    calls = []
    swap = refresher.maybe_swap

    def watched(step, model):
        if not first and step >= 1 and (dp.rank == 0 or step == 3):
            gate.set()
            assert refresher.wait_for_result(timeout=120)
        with refresher._result_lock:
            ready = refresher._result is not None
        swapped = swap(step, model)
        calls.append((step, ready, swapped))
        return swapped

    refresher.maybe_swap = watched
    log = engine.TrainLog(1, lambda s: None)
    final = engine.train(task, ds, cfg, refresher=refresher,
                         prefetch_depth=1, dp=dp, printer=lambda s: None,
                         log=log)
    start, stop = index.process_row_range()
    return {"final": final, "calls": calls, "first_step": first["step"],
            "first_rows": first["rows"], "row_range": (start, stop),
            "devices": [str(d) for d in devices],
            "zero_copy": refresher.zero_copy,
            "losses": [h["loss"] for h in log.history],
            "refresh_count": refresher.refresh_count,
            "params": {k: v.clone()
                       for k, v in task.state.model.state_dict().items()}}


def case_prefetch(spec, dp):
    """``engine.train`` with the retriever frozen, three iterations without
    the prefetcher and three under ``DataParallelPrefetcher`` (depth 1),
    from the same weights: each run's history."""
    import dataclasses

    from emdr2_tpu_torch.training import engine
    cfg = spec["cfg"].replace(update_retriever=False)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=spec["batch"], train_iters=3, log_interval=1,
        save_interval=10 ** 6, eval_interval=10 ** 6))
    out = {}
    for depth in (0, 1):
        task, ds = _task(spec, dp, cfg)
        log = engine.TrainLog(1, lambda s: None)
        engine.train(task, ds, cfg, prefetch_depth=depth, dp=dp,
                     printer=lambda s: None, log=log)
        out[depth] = [{k: v for k, v in h.items() if k != "ms_per_iter"}
                      for h in log.history]
    return out


CASES = {"mips": case_mips, "embedder": case_embedder,
         "prefetch": case_prefetch, "dpr_task": case_dpr_task, "recall": case_recall,
         "dpr_loss": case_dpr_loss,
         "openqa": case_openqa, "engine": case_engine,
         "refresh": case_refresh}


def main() -> int:
    spec = torch.load(sys.argv[1], weights_only=False)
    rank = int(sys.argv[2])
    torch.set_num_threads(spec.get("threads", 2))
    dist_lib.init_process_group(spec["address"], spec["world_size"], rank,
                                "gloo", timeout_s=TIMEOUT_S)
    dp = DataParallel.from_process_group()
    results = {}
    try:
        for name in spec["cases"]:
            t0 = time.perf_counter()
            results[name] = CASES[name](spec, dp)
            results[name + "_seconds"] = time.perf_counter() - t0
    finally:
        torch.save(results, os.path.join(spec["out"], f"rank{rank}.pt"))
        dist_lib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
