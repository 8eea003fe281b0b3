"""The rank processes of tests/test_torch_tensor_parallel.py: they import
torch and the port, never jax.

    python tests/test_torch_tensor_parallel_workers.py SPEC RANK

``SPEC`` (a ``torch.save``d dict) names the world size, the tensor-parallel
size ``tp`` (the grid is ``[world / tp, tp]``, world rank ``dp_idx * tp +
tp_idx``), the rendezvous address (a ``file://`` store), the output
directory, the cases to run in order and their inputs; each case's results
go into ``<out>/rank<RANK>.pt`` as {case: results}. Every rank joins one
gloo group on the CPU with a timeout, then the dp and tp groups are made
from it (``DataParallel.from_process_group(tp=...)``).
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from emdr2_tpu_torch.parallel import DataParallel  # noqa: E402
from emdr2_tpu_torch.parallel import distributed as dist_lib  # noqa: E402
from emdr2_tpu_torch.parallel.tensor import all_gather_params  # noqa: E402
from tests.test_torch_parallel_workers import _Recorder, _world  # noqa: E402

TIMEOUT_S = 120.0


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


def _local(task):
    return {k: v.clone() for k, v in task.state.model.state_dict().items()}


def _whole(task, dp):
    return all_gather_params(_local(task), dp.tp)


def _steps(task, ds, dp, seed):
    """Two train steps on this replica's slice of the global batches."""
    from emdr2_tpu_torch.tasks.e2eqa import _slice_qa_batch
    from emdr2_tpu_torch.training.step import METRICS
    B = task.global_batch_size
    per = B // dp.world_size
    out = []
    for batch in list(ds.epoch_batches(B, seed=seed))[:2]:
        m = task.train_step(_slice_qa_batch(batch, dp.rank * per,
                                            (dp.rank + 1) * per))
        out.append({k: float(m[k]) for k in METRICS})
    return out


def case_vocab(spec, dp):
    """The vocab-parallel reader CE and its logits gradient on this rank's
    columns; the teacher's gold head of a T5 split over tp."""
    from emdr2_tpu_torch.models.t5 import T5Model
    from emdr2_tpu_torch.parallel.tensor import shard_for
    from emdr2_tpu_torch.training.losses import reader_cross_entropy
    d = spec["vocab"]
    tp = dp.tp
    logits = torch.as_tensor(d["logits"])
    cols = logits.shape[-1] // tp.world_size
    mine = logits[..., tp.rank * cols:(tp.rank + 1) * cols].clone()
    mine.requires_grad_(True)
    loss = reader_cross_entropy(mine, torch.as_tensor(d["labels"]).long(),
                                torch.as_tensor(d["mask"]), tp=tp)
    loss.backward()
    g = spec["gold"]
    t5 = T5Model(g["cfg"], device="cpu", tp=tp)
    t5.load_state_dict(shard_for(g["params"], tp), strict=True)
    with torch.no_grad():
        gold = t5.decode_gold_log_probs(
            torch.as_tensor(g["dec"]).long(), torch.as_tensor(g["hidden"]),
            torch.as_tensor(g["mask"]), torch.as_tensor(g["labels"]).long())
    return {"loss": float(loss), "grad": mine.grad.clone(), "gold": gold}


def case_mips(spec, dp):
    """Each replica's queries against the index whose blocks lie on every
    rank of the grid."""
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


def case_openqa(spec, dp):
    """``evaluate_em`` of the initial weights (greedy, and greedy over the
    int8 K/V) with the generated texts; two steps at dropout 0 (metrics,
    the whole parameters after them) and a checkpoint of that state; the
    tp = 1 checkpoint restored here; two steps from fresh weights at
    dropout 0.1."""
    from emdr2_tpu_torch.config import with_transformers
    from emdr2_tpu_torch.tasks import e2eqa
    from emdr2_tpu_torch.training import checkpointing
    out = {}
    task, ds = _task(spec, dp)
    B = task.global_batch_size
    for name, kw in (("greedy", {}), ("int8", {"kv_quant": "int8"})):
        rec = _Recorder(e2eqa.metric_max_over_ground_truths)
        e2eqa.metric_max_over_ground_truths = rec
        try:
            em = task.evaluate_em(ds, batch_size=B, max_decode_len=4, **kw)
        finally:
            e2eqa.metric_max_over_ground_truths = rec.fn
        out[f"em_{name}"] = (em, rec.texts)
    out["steps"] = _steps(task, ds, dp, seed=0)
    out["params"] = _whole(task, dp)
    checkpointing.save_checkpoint(spec["ckpt"]["out"], task.state, 2, dp=dp)
    fresh, _ = _task(spec, dp)
    _, it = checkpointing.load_checkpoint(spec["ckpt"]["in"], fresh.state,
                                          dp=dp)
    adam = fresh.state.optimizer.adamw.state_dict()["state"]
    names = checkpointing._moment_names(fresh.state)
    out["restored"] = {
        "iteration": it, "step": fresh.state.step,
        "count": fresh.state.optimizer.count,
        "params": _whole(fresh, dp),
        "adam": {names[i]: all_gather_params(
            {names[i]: adam[i]["exp_avg_sq"]}, dp.tp)[names[i]]
            for i in adam}}
    kw = dict(hidden_dropout=0.1, attention_dropout=0.1)
    dtask, _ = _task(spec, dp, with_transformers(spec["cfg"], kw, kw))
    out["dropout_steps"] = _steps(dtask, ds, dp, seed=1)
    out["dropout_local"] = _local(dtask)
    return out


def case_remat(spec, dp):
    """One step under ``--remat`` with each policy from the same weights:
    the recompute's collectives run on every tp rank alike, and the step
    is the step without remat."""
    from emdr2_tpu_torch.config import with_transformers
    out = {}
    for policy in ("nothing", "dots_no_batch"):
        kw = dict(remat=True, remat_policy=policy)
        task, ds = _task(spec, dp, with_transformers(spec["cfg"], kw, kw))
        out[policy] = (_steps(task, ds, dp, seed=0)[0], _local(task))
    return out


def case_dpr_task(spec, dp):
    """Two DPRTask steps on each replica's slice of the global batches and
    ``validate``; two steps at dropout 0.1 from the same weights."""
    import dataclasses

    from emdr2_tpu_torch.data.tokenizer import (BertWordPieceTokenizer,
                                                toy_vocab)
    from emdr2_tpu_torch.tasks.dense_retriever import DPRDataset, DPRTask
    d = spec["dpr_task"]
    tok = BertWordPieceTokenizer(toy_vocab(d["words"]))
    out = {}
    for name, drop in (("plain", 0.0), ("dropout", 0.1)):
        cfg = d["cfg"]
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, hidden_dropout=drop, attention_dropout=drop))
        kw = dict(query_seq_len=cfg.query_seq_len, ctx_seq_len=cfg.seq_len)
        ranks = dict(rank=dp.rank, world_size=dp.world_size)
        train = DPRDataset(d["path"], tok, hard_negs=1, **kw)
        task = DPRTask(cfg, d["opt"], total_train_iters=10,
                       score_scaling=True, device="cpu", dp=dp)
        task.init_state(0, state_dict=d["params"])
        steps = []
        for batch in list(train.epoch_batches(d["batch"], seed=0,
                                              **ranks))[:2]:
            m = task.train_step(batch)
            steps.append({k: float(v) for k, v in m.items()})
        res = {"steps": steps,
               "local": {k: v.clone()
                         for k, v in task.model.state_dict().items()}}
        if name == "plain":
            evald = DPRDataset(d["path"], tok, evaluate=True,
                               val_av_rank_other_neg=2,
                               val_av_rank_hard_neg=2, **kw)
            res["valid"] = task.validate(evald.epoch_batches(
                d["batch"], seed=0, shuffle=False, **ranks))
            res["params"] = all_gather_params(res["local"], dp.tp)
        out[name] = res
    return out


def case_refresh(spec, dp):
    """A synchronous refresh: each rank embeds its own block of rows with
    the context tower gathered whole over tp, and swaps it in; the search
    after it; then the asynchronous refresher over the same grid."""
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
    start, stop = index.process_row_range()
    swapped = SynchronousRefresher(builder, index, 1).maybe_swap(
        1, task.state.model)
    index2 = ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu", dp=dp)
    refresher = AsyncIndexRefresher(builder, index2, reload_interval=1)
    refresher.start(task.state.model)
    assert refresher.wait_for_result(timeout=120)
    async_swapped = refresher.maybe_swap(1, task.state.model)
    refresher.stop()
    batch = next(ds.epoch_batches(spec["batch"], seed=0, shuffle=False))
    per = spec["batch"] // dp.world_size
    q = task.state.model.embed_query(task._ids(batch.query_bert_ids))
    q = q.float()[dp.rank * per:(dp.rank + 1) * per]
    vals, ids = index.search(q.detach(), k=cfg.index.topk)
    return {"swapped": swapped, "row_range": (start, stop),
            "rows": index.embeddings.clone(), "vals": vals, "ids": ids,
            "async_swapped": async_swapped,
            "async_rows": index2.embeddings.clone()}


CASES = {"vocab": case_vocab, "mips": case_mips, "openqa": case_openqa,
         "remat": case_remat, "dpr_task": case_dpr_task,
         "refresh": case_refresh}


def main() -> int:
    spec = torch.load(sys.argv[1], weights_only=False)
    rank = int(sys.argv[2])
    torch.set_num_threads(spec.get("threads", 1))
    dist_lib.init_process_group(spec["address"], spec["world_size"], rank,
                                "gloo", timeout_s=TIMEOUT_S)
    dp = DataParallel.from_process_group(tp=spec["tp"])
    results = {"ranks": (dp.world.rank, dp.rank, dp.tp.rank)}
    try:
        for name in spec["cases"]:
            t0 = time.perf_counter()
            results[name] = CASES[name](spec, dp)
            results[name + "_seconds"] = time.perf_counter() - t0
        results["bytes"] = {"dp": dict(dp.bytes_moved),
                            "tp": dict(dp.tp.bytes_moved)}
    finally:
        torch.save(results, os.path.join(spec["out"], f"rank{rank}.pt"))
        dist_lib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
