"""Driver of the OPENQA training cells whose reader is T5 v1.1
(``atlas-large-b4``): ``openqa_train``'s run and check, with the program's
configuration from ``benchmark/program_t5v11.py``, the weights and the
plain reference from ``benchmark/reference/t5v11.py`` and the step's
FLOPs from ``benchmark/counts/t5v11.py``.

Set-up, the window, the step after it and the check are
``openqa_train.Driver``'s: ``check_steps`` steps through
``E2EQATask.train_step`` recorded on their way out of the program, the
window, the stage timer over ``stage_steps`` more steps in a traced run,
one more step from the state saved to the host; then the reference in
float32 searches, formats and follows the check steps and the step after
with the same dropout masks. The compared numbers are ``openqa_train``'s,
over every parameter (the relative-position tables among them).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import world
from benchmark.counts import t5v11 as counts
from benchmark.drivers import openqa_train as base
from benchmark.program import tokenizer_ids
from benchmark.program_t5v11 import emdr2_config
from benchmark.reference import formatting, model, search, t5v11, train

# what the calibration (benchmark/calibrate.py) reads off a driver module
numbers, program_readings = base.numbers, base.program_readings


class Driver(base.Driver):

    def setup(self):
        from emdr2_tpu_torch.data.evidence import EvidenceCorpus
        from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
        from emdr2_tpu_torch.tasks.e2eqa import E2EQATask

        cfg, dev = self.cfg, self.dev
        pcfg = emdr2_config(cfg)
        self.make_world()
        evidence = EvidenceCorpus.load(self.corpus.text_prefix,
                                       self.corpus.title_prefix)
        rows = world.make_index_rows(cfg, self.index_seed, dev)
        index = ShardedEvidenceIndex(
            pcfg.index, rows, device=dev,
            passage_ids=world.passage_of_row(cfg, np.arange(len(rows))))
        del rows
        self.timer = base.switched_timer(dev) if self.run.trace else None
        task = E2EQATask(pcfg, tokenizer_ids(cfg), evidence, index,
                         total_train_iters=cfg["optimizer"]["train_iters"],
                         device=dev, timer=self.timer)
        weights = t5v11.make_params(cfg, self.weight_seed, dev)
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
                        (n, m / (1 - b1))
                        for n, m in self._adam("exp_avg").items())
        p0 = t5v11.make_params(cfg, self.weight_seed, dev)
        with torch.no_grad():
            self.update_norms = base.part_norms(
                (n, p - p0[n]) for n, p in state.model.named_parameters())
        del p0
        self.searched, self.built = searched, built

    def record(self):
        """The traced run's readings: the stage timer over ``stage_steps``
        more steps, and the T5 v1.1 step's model FLOPs."""
        self.timer.on = True
        for _ in range(int(self.traffic["stage_steps"])):
            self.unit()
        self.timer.on = False
        c = self.cfg
        return {"stage_ms": dict(self.timer.ms),
                "flops_per_unit": counts.model_flops_per_step(
                    c["retriever"], c["reader"],
                    self.traffic["questions_per_step"], c["topk"],
                    c["query_seq_len"], c["context_seq_len"],
                    c["reader_seq_len"], c["decoder_seq_len"])}

    def check(self):
        model.strict_float32()
        num = model.Numerics("fp32")
        ref = reference_run(self, num, self.searched, self.built,
                            last=self.last)
        got = numbers(program_readings(self), ref)
        return [(name, got[name], self.run.limits[name]) for name in got]


def reference_run(drv, num, chosen=None, built=None, rows=None, last=None):
    """``openqa_train.reference_run`` with the T5 v1.1 reference: the check
    steps from the seed's weights, then (``last``) the step after the
    window from the state the program saved."""
    cfg, dev = drv.cfg, drv.dev
    p = {n: t.clone().requires_grad_(True) for n, t in
         t5v11.make_params(cfg, drv.weight_seed, dev).items()}
    p0 = {n: t.detach().clone() for n, t in p.items()}
    stored = search.quantize_rows(
        world.make_index_rows(cfg, drv.index_seed, dev),
        cfg["index_group_size"])
    corpus = formatting.Corpus(drv.corpus.texts, drv.corpus.titles,
                               drv.corpus.group_of)
    opt = train.AdamW(p, cfg["optimizer"])
    out = {"retrieval_gap": 0.0, "format_mismatches": 0, "losses": [],
           "grad_norm": [], "rows": [], "seconds": []}
    steps = drv.n_check
    for s in range(steps):
        r = _reference_step(drv, num, p, opt, stored, corpus, s, s,
                            chosen[s] if chosen else None,
                            built[s] if built is not None else None, rows)
        out["retrieval_gap"] = max(out["retrieval_gap"], r["retrieval_gap"])
        out["format_mismatches"] += r["format_mismatches"]
        for k in ("losses", "grad_norm", "rows", "seconds"):
            out[k].append(r[k])
        if s == 0:
            out["grad_norms"] = r["grad_norms"]
    with torch.no_grad():
        out["update_norms"] = base.part_norms((n, p[n] - p0[n]) for n in p)
    out["steps"] = steps
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
                            last["built"][0], rows)
        with torch.no_grad():
            r["update_norms"] = base.part_norms(
                (n, p[n] - saved["params"][n].to(dev)) for n in p)
        out["last"] = r
    return out


def _reference_step(drv, num, p, opt, stored, corpus, step, batch_index,
                    chosen, built, rows):
    """``openqa_train._reference_step`` with the T5 v1.1 reader's loss."""
    cfg, dev = drv.cfg, drv.dev
    ids = world.special_ids(cfg)
    K = cfg["topk"]
    t0 = time.perf_counter()
    q = world.make_questions(cfg, drv.traffic, drv.question_seed, batch_index)
    qids = torch.as_tensor(q.ids, dtype=torch.long, device=dev)
    gap, prog = base.stage_a(p, stored, qids, chosen, cfg, num)
    passages = world.passage_of_row(cfg, prog.cpu().numpy())
    arrays = formatting.format_step(
        corpus, q.ids, q.length, q.uid, passages, K, cfg["context_seq_len"],
        cfg["reader_seq_len"], ids["cls"], ids["sep"], ids["pad"])
    mismatches = 0
    if built is not None:
        for mine, theirs in zip(arrays, (built[1], built[2], built[3],
                                         built[4])):
            mismatches += int((torch.as_tensor(mine) != theirs.long()).sum())
    t = [torch.as_tensor(a, device=dev) for a in arrays]
    x = train.StepInputs(
        qids, t[0], t[1], t[2], t[3],
        torch.as_tensor(q.dec_ids, dtype=torch.long, device=dev),
        torch.as_tensor(q.labels, dtype=torch.long, device=dev),
        torch.as_tensor(q.loss_mask, device=dev))
    loss = t5v11.step_loss(
        p, x, cfg, model.step_seeds(drv.run.seed, step), num, ids["eos"],
        block_rows=int(drv.traffic.get("reference_block_rows", 8)),
        rows=rows)
    norm, grads = opt.step()
    grad_norms = base.part_norms(grads.items())
    del grads
    seconds = time.perf_counter() - t0
    print(f"reference step {step}: {seconds:.1f} s", file=sys.stderr,
          flush=True)
    return {"retrieval_gap": gap, "format_mismatches": mismatches,
            "losses": loss, "grad_norm": norm, "rows": prog.cpu(),
            "seconds": seconds, "grad_norms": grad_norms}


def stand_in(drv, num, rows=None):
    """``openqa_train.stand_in`` with the T5 v1.1 reference."""
    got = reference_run(drv, num, rows=rows)
    if drv.dev.type == "cuda":
        torch.cuda.empty_cache()
    return got, reference_run(drv, model.Numerics("fp32"), got["rows"])


def first_step_gap(drv, rows, num) -> float:
    """Stage A's gap of the first step alone, for the rows ``rows``."""
    cfg, dev = drv.cfg, drv.dev
    p = t5v11.make_params(cfg, drv.weight_seed, dev)
    stored = search.quantize_rows(
        world.make_index_rows(cfg, drv.index_seed, dev),
        cfg["index_group_size"])
    q = world.make_questions(cfg, drv.traffic, drv.question_seed, 0)
    qids = torch.as_tensor(q.ids, dtype=torch.long, device=dev)
    return base.stage_a(p, stored, qids, rows, cfg, num)[0]
