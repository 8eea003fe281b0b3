"""Driver of the data-parallel OPENQA cell (``openqa-dp4``): the program's
``--dp W`` path over NCCL, one process and one card a rank, each rank
running ``E2EQATask.train_step`` on its own questions.

Rank 0 is the harness's process; it starts ranks 1..W-1 as processes of
this file (``python3 benchmark/drivers/openqa_train_dp.py --rank R --spec
PATH``), on cards 1..W-1, and they join one process group at a free local
port. Before each phase (a step of the window, the stage steps of a traced
run, the step after the window, the check) rank 0 tells the others over a
gloo group what comes next, so every rank stops on the same step; a rank
that died is named and refuses the run. A rank whose rank 0 is gone exits.
The faults the CPU tests plant (``run.faults``, names of
``benchmark/tests/tiny_dp.py``'s) are handed to every rank.

Each rank: ``questions_per_step`` questions a step (batch ``b * W + r`` of
the seed's questions), one ``index_rows``-row int8 shard of its own (rows
from the seed's index stream for rank r), searched through
``sharded_mips_topk``'s all-gather and merge over the W shards; the
gradient is all-reduced each step. The corpus and the weights are every
rank's alike. Set-up, the window and the step after it are
``openqa_train.Driver``'s on every rank; rank 0's readings stand for all
(the ranks hold the same state after each all-reduce).

The check, on every rank at once: the plain reference (float32, TF32 off)
searches the union of the W shards exactly (each rank scores every
question against its shard; the k-th score, the scores' spread and the
program's rows' scores are combined over the ranks) for ``retrieval_gap``;
formats each rank's passages again against its stage B arrays
(``format_mismatches``, summed); and follows the check steps and the step
after the window: each rank's loss and gradient of its own batch, with
the dropout masks rank r draws in the program (the attention kernels'
seeds folded by ``r * 0x9E3779B1``, the hidden dropout's rows offset by r
times the rank's rows), weighed by its answer tokens over the global
batch's and summed over the ranks (the program's global loss), then
clipped and AdamW on each rank alike. The numbers compared are
``openqa_train``'s.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmark import world  # noqa: E402
from benchmark.drivers import openqa_train as base  # noqa: E402
from benchmark.program import emdr2_config, tokenizer_ids  # noqa: E402
from benchmark.reference import formatting, search, train  # noqa: E402
from benchmark.reference import model as M  # noqa: E402

STEP, RECORD, RELEASE, CHECK = 1, 2, 3, 4
M32 = 0xFFFFFFFF

numbers, program_readings = base.numbers, base.program_readings


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Driver(base.Driver):

    def __init__(self, run, rank: int = 0):
        super().__init__(run)
        self.W = int(self.traffic["data_parallel"])
        self.rank = rank
        self.procs = []
        if self.dev.type == "cuda":
            self.dev = torch.device("cuda", rank)
        self.shard_seed = world.streams(self.index_seed, self.W)[rank]

    # ------------------------------------------------------- the ranks

    def _start_ranks(self):
        """Rank 0: start ranks 1..W-1, then join the group with them."""
        run = self.run
        port = _free_port()
        spec = {"cell": run.cell["name"], "seed": run.seed,
                "seconds": run.seconds, "trace": run.trace,
                "device": run.device, "config": self.cfg,
                "traffic": self.traffic, "faults": list(run.faults),
                "address": f"tcp://localhost:{port}"}
        path = os.path.join(run.workdir, "ranks.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
            "OMP_NUM_THREADS", "4"))
        for r in range(1, self.W):
            log = open(os.path.join(run.workdir, f"rank{r}.log"), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 str(r), "--spec", path], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        atexit.register(self._stop_ranks)
        self._join(spec["address"])

    def _join(self, address):
        from emdr2_tpu_torch.parallel import DataParallel
        from emdr2_tpu_torch.parallel import distributed as dist_lib
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)
        dist_lib.init_process_group(
            address, self.W, self.rank,
            "nccl" if self.dev.type == "cuda" else "gloo", timeout_s=300,
            device=self.dev)
        self.dp = DataParallel.from_process_group()
        # what comes next, on the host: rank 0 may spend minutes between two
        # phases (reading a trace) while the others wait
        import datetime
        self.ctrl = dist.new_group(backend="gloo",
                                   timeout=datetime.timedelta(hours=1))

    def _dead_ranks(self):
        return [(r + 1, p.returncode) for r, (p, _) in enumerate(self.procs)
                if p.poll() is not None and p.returncode != 0]

    def _announce(self, cmd: int) -> None:
        """Rank 0 tells the others the phase it enters (they are waiting in
        ``rank_main``'s loop and enter it too)."""
        if self.rank == 0:
            self._tell(cmd)

    def _tell(self, cmd: int) -> int:
        """Rank 0 sends ``cmd`` to every rank; the others receive it."""
        if self.rank == 0:
            dead = self._dead_ranks()
            if dead:
                raise RuntimeError(f"ranks ended early (rank, rc): {dead}; "
                                   f"{self._log_tail(dead[0][0])}")
        t = torch.tensor([cmd], dtype=torch.int64)
        dist.broadcast(t, 0, group=self.ctrl)
        return int(t.item())

    def _log_tail(self, r: int) -> str:
        path = os.path.join(self.run.workdir, f"rank{r}.log")
        with open(path) as f:
            return f.read()[-4000:]

    def _stop_ranks(self, timeout: float = 0.0):
        deadline = time.monotonic() + timeout
        for p, log in self.procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        self.procs = []

    # ---------------------------------------------------------- set-up

    def _qa_batch(self):
        from emdr2_tpu_torch.data.qa_dataset import QABatch
        q = world.make_questions(self.cfg, self.traffic, self.question_seed,
                                 self.next_batch * self.W + self.rank)
        self.next_batch += 1
        return QABatch(query_uid=q.uid, query_bert_ids=q.ids,
                       query_t5_ids=q.ids, query_t5_len=q.length,
                       dec_ids=q.dec_ids, labels=q.labels,
                       loss_mask=q.loss_mask,
                       references=[[""] for _ in q.uid])

    def setup(self):
        from emdr2_tpu_torch.data.evidence import EvidenceCorpus
        from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
        from emdr2_tpu_torch.tasks.e2eqa import E2EQATask

        if self.rank == 0:
            self._start_ranks()
        cfg, dev, W = self.cfg, self.dev, self.W
        b = int(self.traffic["questions_per_step"])
        pcfg = emdr2_config(dict(cfg, batch_size=b * W))
        self.make_world()
        evidence = EvidenceCorpus.load(self.corpus.text_prefix,
                                       self.corpus.title_prefix)
        rows = world.make_index_rows(cfg, self.shard_seed, dev)
        n = cfg["index_rows"] * W
        index = ShardedEvidenceIndex(
            pcfg.index, rows, device=dev, dp=self.dp, local=True, n_real=n,
            passage_ids=world.passage_of_row(cfg, np.arange(n)))
        del rows
        self.timer = base.switched_timer(dev) if self.run.trace else None
        task = E2EQATask(pcfg, tokenizer_ids(cfg), evidence, index,
                         total_train_iters=cfg["optimizer"]["train_iters"],
                         device=dev, timer=self.timer, dp=self.dp)
        weights = M.make_params(cfg, self.weight_seed, dev)
        task.init_state(self.run.seed, state_dict=weights)
        del weights
        self.task = task
        state = task.state
        b1 = state.optimizer.cfg.adam_beta1
        self.metrics = []
        with self._recorded() as (searched, built):
            for i in range(self.n_check):
                self.metrics.append(base._floats(
                    task.train_step(self._qa_batch())))
                if i == 0:
                    self.grad_norms = base.part_norms(
                        (n_, m / (1 - b1))
                        for n_, m in self._adam("exp_avg").items())
        p0 = M.make_params(cfg, self.weight_seed, dev)
        with torch.no_grad():
            self.update_norms = base.part_norms(
                (n_, p - p0[n_]) for n_, p in state.model.named_parameters())
        del p0
        self.searched, self.built = searched, built

    # ------------------------------------------------------ the window

    def _step(self):
        return base.Driver.unit(self)

    def unit(self):
        self._announce(STEP)
        return self._step()

    def record(self):
        """``openqa_train``'s readings over the stage steps, which every
        rank runs (rank 0's timer is read)."""
        self._announce(RECORD)
        self.timer.on = True
        for _ in range(int(self.traffic["stage_steps"])):
            self._step()
        self.timer.on = False
        return {"stage_ms": dict(self.timer.ms),
                "flops_per_unit": base.counts.model_flops_per_step(
                    *self._shapes()),
                "attention_per_unit": base.counts.train_step_attention(
                    *self._shapes())}

    def release(self):
        self._announce(RELEASE)
        base.Driver.release(self)

    def check(self):
        self._announce(CHECK)
        try:
            import gc
            gc.collect()
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
            M.strict_float32()
            ref = reference_run(self, M.Numerics("fp32"), self.searched,
                                self.built, last=self.last)
            got = numbers(program_readings(self), ref)
        finally:
            from emdr2_tpu_torch.parallel import distributed as dist_lib
            dist_lib.shutdown()
            if self.rank == 0:
                self._stop_ranks(timeout=120)
        return [(name, got[name], self.run.limits[name]) for name in got]


# ------------------------------------------------------------ the check

def _all_reduce(t, op=dist.ReduceOp.SUM):
    dist.all_reduce(t, op=op)
    return t


def _all_gather(t):
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return out


@contextlib.contextmanager
def _rank_masks(rank: int):
    """``model.py``'s dropout as rank ``rank`` of the program draws it: the
    attention kernels' keep masks from the site's seed plus rank * 0x9E3779B1
    over the rank's own rows, the hidden dropout's (and the materialized
    probabilities') over the global rows, the rank's first row being
    ``rank`` times its rows (``shift["rows"]``, set by the caller before
    each tower or stack)."""
    shift = {"rows": 0}
    hidden, keep = M.hidden_dropout, M.attention_keep
    M.hidden_dropout = (lambda x, rate, seed, row0=0:
                        hidden(x, rate, seed, row0 + shift["rows"]))
    M.attention_keep = (lambda seed, *a, **k:
                        keep((seed + rank * 0x9E3779B1) & M32, *a, **k))
    try:
        yield shift
    finally:
        M.hidden_dropout, M.attention_keep = hidden, keep


def _rank_step_loss(p, x, model, seeds, num, rank, block_rows):
    """``train.step_loss`` of this rank's batch with its masks; returns
    (loss over its answer tokens, its answer tokens)."""
    rc, tc = model["retriever"], model["reader"]
    B, K, Lc = x.context_ids.shape
    Lr = x.reader_ids.shape[-1]
    d_topk, d_enc, d_dec, d_teach = (seeds.fold(i) for i in range(4))
    q_seeds, c_seeds = d_topk.fold(0), d_topk.fold(1)
    blocks = train._blocks
    with _rank_masks(rank) as shift:
        shift["rows"] = rank * B
        q = M.bert_cls(p, "retriever.query_model.", x.query_ids, rc, q_seeds,
                       num)
        ctx_ids = x.context_ids.reshape(B * K, Lc)
        ctx_types = x.context_types.reshape(B * K, Lc)
        shift["rows"] = rank * B * K
        with torch.no_grad():
            c = torch.cat([M.bert_cls(p, "retriever.context_model.",
                                      ctx_ids[s:e], rc, c_seeds, num,
                                      ctx_types[s:e], row0=s)
                           for s, e in blocks(B * K, 2 * block_rows)])
        c.requires_grad_(True)
        scores = torch.einsum("bd,bkd->bk", q, c.view(B, K, -1))
        if model["retriever_score_scaling"]:
            scores = scores / math.sqrt(rc["hidden_size"])
        topk_lp = torch.log_softmax(scores, dim=-1)
        rd_ids = x.reader_ids.reshape(B * K, Lr)
        with torch.no_grad():
            enc = torch.cat([M.t5_encode(p, rd_ids[s:e], tc, d_enc, num,
                                         row0=s)
                             for s, e in blocks(B * K, block_rows)])
        enc.requires_grad_(True)
        shift["rows"] = rank * B
        logits = M.t5_decode(p, x.dec_ids, enc.view(B, K * Lr, -1),
                             x.reader_ids.reshape(B, K * Lr), tc, d_dec, num)
        shift["rows"] = rank * B * K
        t_ids = x.teacher_ids.reshape(B * K, Lr)
        dec_rep = x.dec_ids.repeat_interleave(K, dim=0)
        lab_rep = x.labels.repeat_interleave(K, dim=0)
        gold = []
        with torch.no_grad():
            for s, e in blocks(B * K, block_rows):
                te = M.t5_encode(p, t_ids[s:e], tc, d_teach.fold(0), num,
                                 row0=s)
                lg = M.t5_decode(p, dec_rep[s:e], te, t_ids[s:e], tc,
                                 d_teach.fold(1), num, row0=s)
                gold.append(torch.log_softmax(lg, dim=-1).gather(
                    -1, lab_rep[s:e, :, None].long())[..., 0])
        gold = torch.cat(gold).view(B, K, -1)
        mask = x.loss_mask
        safe = torch.where(mask > 0, x.labels, torch.zeros_like(x.labels))
        n_tok = mask.sum()
        lp = torch.log_softmax(logits, dim=-1).gather(-1,
                                                      safe[..., None].long())
        lm_loss = -(lp[..., 0] * mask).sum() / n_tok
        marginal = torch.logsumexp(topk_lp[:, :, None] + gold, dim=1)
        loss = lm_loss - (marginal * mask).sum() / n_tok
        loss.backward()
        for s, e in blocks(B * K, 2 * block_rows):
            out = M.bert_cls(p, "retriever.context_model.", ctx_ids[s:e], rc,
                             c_seeds, num, ctx_types[s:e], row0=s)
            out.backward(c.grad[s:e])
        for s, e in blocks(B * K, block_rows):
            out = M.t5_encode(p, rd_ids[s:e], tc, d_enc, num, row0=s)
            out.backward(enc.grad[s:e])
    return float(loss.detach()), float(n_tok)


def _stage_a(drv, p, stored, batch_index, chosen, num):
    """(gap, this rank's rows): the reference's exact top k over the union
    of the ranks' shards for every rank's questions, and how far below its
    k-th score the lowest of the program's rows lies, in the union's score
    s.d., widest over the questions."""
    cfg, W, K = drv.cfg, drv.W, drv.cfg["topk"]
    qids = torch.cat([torch.as_tensor(world.make_questions(
        cfg, drv.traffic, drv.question_seed, batch_index * W + r).ids,
        dtype=torch.long, device=drv.dev) for r in range(W)])
    rows = chosen[:, :K].to(drv.dev)
    with torch.no_grad():
        qe = M.bert_cls(p, "retriever.query_model.", qids, cfg["retriever"],
                        None, num)
        scores = search.exact_scores(qe, stored)          # [W*b, N/W]
        kth = torch.cat(_all_gather(torch.topk(scores, K, dim=1).values),
                        dim=1).topk(K, dim=1).values[:, -1]
        moments = _all_reduce(torch.stack(
            [scores.double().sum(1), scores.double().square().sum(1)]))
        n = stored.shape[0] * W
        sd = ((moments[1] - moments[0] ** 2 / n) / (n - 1)).sqrt().float()
        everyone = torch.cat(_all_gather(rows))             # [W*b, K]
        lo = drv.rank * stored.shape[0]
        mine = (everyone >= lo) & (everyone < lo + stored.shape[0])
        local = (everyone - lo).clamp(0, stored.shape[0] - 1)
        got = torch.where(mine, scores.gather(1, local),
                          torch.full_like(local, -float("inf"),
                                          dtype=torch.float32))
        got = _all_reduce(got, dist.ReduceOp.MAX).min(dim=1).values
        gap = ((kth - got) / sd).max()
    return float(gap), rows


def _reference_step(drv, num, p, opt, stored, corpus, step, batch_index,
                    chosen, built):
    cfg, dev = drv.cfg, drv.dev
    ids = world.special_ids(cfg)
    K = cfg["topk"]
    t0 = time.perf_counter()
    q = world.make_questions(cfg, drv.traffic, drv.question_seed,
                             batch_index * drv.W + drv.rank)
    qids = torch.as_tensor(q.ids, dtype=torch.long, device=dev)
    gap, prog = _stage_a(drv, p, stored, batch_index, chosen, num)
    passages = world.passage_of_row(cfg, prog.cpu().numpy())
    arrays = formatting.format_step(
        corpus, q.ids, q.length, q.uid, passages, K, cfg["context_seq_len"],
        cfg["reader_seq_len"], ids["cls"], ids["sep"], ids["pad"])
    mismatches = 0
    for mine, theirs in zip(arrays, (built[1], built[2], built[3],
                                     built[4])):
        mismatches += int((torch.as_tensor(mine) != theirs.long()).sum())
    t = [torch.as_tensor(a, device=dev) for a in arrays]
    x = train.StepInputs(
        qids, t[0], t[1], t[2], t[3],
        torch.as_tensor(q.dec_ids, dtype=torch.long, device=dev),
        torch.as_tensor(q.labels, dtype=torch.long, device=dev),
        torch.as_tensor(q.loss_mask, device=dev))
    loss, n_tok = _rank_step_loss(
        p, x, cfg, M.step_seeds(drv.run.seed, step), num, drv.rank,
        int(drv.traffic.get("reference_block_rows", 16)))
    # the global loss: each rank's share weighed by its answer tokens
    total = _all_reduce(torch.tensor([loss * n_tok, n_tok, mismatches],
                                     dtype=torch.float64, device=dev))
    with torch.no_grad():
        for t_ in p.values():
            if t_.grad is None:
                t_.grad = torch.zeros_like(t_)
            t_.grad.mul_(n_tok / float(total[1]))
            _all_reduce(t_.grad)
    norm, grads = opt.step()
    grad_norms = base.part_norms(grads.items())
    del grads
    seconds = time.perf_counter() - t0
    print(f"rank {drv.rank} reference step {step}: {seconds:.1f} s",
          file=sys.stderr, flush=True)
    return {"retrieval_gap": gap, "format_mismatches": int(total[2]),
            "losses": float(total[0] / total[1]), "grad_norm": norm,
            "rows": prog.cpu(), "seconds": seconds, "grad_norms": grad_norms}


def reference_run(drv, num, chosen, built, last=None):
    """The reference over the check steps and (``last``) the step after the
    window, every rank its own batch, as ``openqa_train.reference_run``
    reads them."""
    cfg, dev = drv.cfg, drv.dev
    p = {n: t.clone().requires_grad_(True) for n, t in
         M.make_params(cfg, drv.weight_seed, dev).items()}
    p0 = {n: t.detach().clone() for n, t in p.items()}
    stored = search.quantize_rows(
        world.make_index_rows(cfg, drv.shard_seed, dev),
        cfg["index_group_size"])
    corpus = formatting.Corpus(drv.corpus.texts, drv.corpus.titles,
                               drv.corpus.group_of)
    opt = train.AdamW(p, cfg["optimizer"])
    out = {"retrieval_gap": 0.0, "format_mismatches": 0, "losses": [],
           "grad_norm": [], "rows": [], "seconds": []}
    for s in range(drv.n_check):
        r = _reference_step(drv, num, p, opt, stored, corpus, s, s,
                            chosen[s], built[s])
        out["retrieval_gap"] = max(out["retrieval_gap"], r["retrieval_gap"])
        out["format_mismatches"] += r["format_mismatches"]
        for k in ("losses", "grad_norm", "rows", "seconds"):
            out[k].append(r[k])
        if s == 0:
            out["grad_norms"] = r["grad_norms"]
    with torch.no_grad():
        out["update_norms"] = base.part_norms((n, p[n] - p0[n]) for n in p)
    out["steps"] = drv.n_check
    if last is not None:
        del p, p0, opt
        saved = last["saved"]
        p = {n: t.to(dev, copy=True).requires_grad_(True)
             for n, t in saved["params"].items()}
        opt = train.AdamW(p, cfg["optimizer"])
        opt.m = {n: t.to(dev, copy=True) for n, t in saved["m"].items()}
        opt.v = {n: t.to(dev, copy=True) for n, t in saved["v"].items()}
        opt.count = saved["count"]
        r = _reference_step(drv, num, p, opt, stored, corpus, saved["step"],
                            saved["batch"], last["searched"][0],
                            last["built"][0])
        with torch.no_grad():
            r["update_norms"] = base.part_norms(
                (n, p[n] - saved["params"][n].to(dev)) for n in p)
        out["last"] = r
    return out


# ---------------------------------------------------------- ranks 1..W-1

def _exit_with_parent(parent: int):
    """End this rank if rank 0's process is gone."""
    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(2.0)
    threading.Thread(target=watch, daemon=True).start()


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--spec", required=True)
    args = ap.parse_args(argv)
    _exit_with_parent(os.getppid())
    from benchmark import harness
    with open(args.spec) as f:
        spec = json.load(f)
    if spec["faults"]:
        # the CPU tests' faults, planted in every rank's process
        from benchmark.tests import tiny_dp
        tiny_dp.plant(spec["faults"])
    run = harness.Run(harness.read_json(ROOT / "BENCHMARK.json"),
                      spec["cell"], spec["seed"], spec["seconds"],
                      spec["trace"], device=spec["device"],
                      overrides={"config": spec["config"],
                                 "traffic": spec["traffic"],
                                 "faults": spec["faults"]})
    try:
        drv = Driver(run, rank=args.rank)
        if drv.dev.type == "cuda":
            from emdr2_tpu_torch.ops import build
            torch.cuda.set_device(drv.dev)
            build.load()
        drv._join(spec["address"])
        drv.setup()
        phases = {STEP: drv.unit, RECORD: drv.record, RELEASE: drv.release}
        while True:
            cmd = drv._tell(0)
            if cmd == CHECK:
                drv.check()
                return 0
            phases[cmd]()
    finally:
        run.close()


if __name__ == "__main__":
    sys.exit(rank_main())
