"""Driver of the OPENQA training cells: ``E2EQATask.train_step`` on
batches of questions made from the seed, serially (stage A, B, C, then the
optimizer), each step ending in the loss's readback as the task's loop
reads it.

Set-up builds one task (the corpus in the evidence store's files, the
int8 index of the configured rows, the weights from the seed), and runs
its first ``check_steps`` steps through the same ``train_step``: they warm
up every shape the window uses, and what they produce is what the check
compares. During them the search's rows and the step's device batch are
recorded on the way out of the program, the first gradient is read off
AdamW's first moment after step 1, and the parameters' change after the
last of them. The window then continues training the same task.

After the window (and, in a traced run, the ``stage_steps`` steps that
read the stage timer, which is off in the window: its boundaries
synchronise the stream), the task's state is saved to the host and one
more step runs through the same ``train_step``, recorded alike: its
gradient is read off the change of AdamW's first moment, and its
parameters' change.

The check, with the program's state freed: the plain reference (float32,
TF32 off) searches the same stored rows exactly with its own question
embeddings, formats the program's retrieved passages again, follows the
program's ``check_steps`` steps from the same weights and inputs with the
same dropout masks, and runs the step after the window from the state
the program saved (the window's steps themselves are not followed).
"""

from __future__ import annotations

import contextlib
import math
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import world
from benchmark.counts import flops as counts
from benchmark.program import emdr2_config, tokenizer_ids
from benchmark.reference import formatting, model, search, train


def switched_timer(device):
    """The program's stage timer with a switch, off until ``on`` is set."""
    from emdr2_tpu_torch.utils.timing import StageTimer

    class Switched(StageTimer):
        on = False

        def stage(self, name):
            return (super().stage(name) if self.on
                    else contextlib.nullcontext())

    return Switched(device)


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.config, run.traffic
        self.dev = torch.device(run.device)
        (self.weight_seed, self.index_seed, self.corpus_seed,
         self.question_seed) = run.streams(4)
        self.n_check = int(self.traffic["check_steps"])
        self.next_batch = 0
        self.last = None

    # ------------------------------------------------------------ set-up

    def _qa_batch(self):
        from emdr2_tpu_torch.data.qa_dataset import QABatch
        q = world.make_questions(self.cfg, self.traffic, self.question_seed,
                                 self.next_batch)
        self.next_batch += 1
        return QABatch(query_uid=q.uid, query_bert_ids=q.ids,
                       query_t5_ids=q.ids, query_t5_len=q.length,
                       dec_ids=q.dec_ids, labels=q.labels,
                       loss_mask=q.loss_mask,
                       references=[[""] for _ in q.uid])

    def make_world(self):
        """The corpus files; the rest of the inputs come from the seed when
        they are used."""
        self.corpus = world.make_corpus(self.cfg, self.traffic,
                                        self.corpus_seed, self.run.workdir)

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
        self.timer = switched_timer(dev) if self.run.trace else None
        task = E2EQATask(pcfg, tokenizer_ids(cfg), evidence, index,
                         total_train_iters=cfg["optimizer"]["train_iters"],
                         device=dev, timer=self.timer)
        weights = model.make_params(cfg, self.weight_seed, dev)
        task.init_state(self.run.seed, state_dict=weights)
        del weights
        self.task = task

        state = task.state
        b1 = state.optimizer.cfg.adam_beta1
        self.metrics = []
        with self._recorded() as (searched, built):
            for i in range(self.n_check):
                self.metrics.append(_floats(task.train_step(self._qa_batch())))
                if i == 0:
                    self.grad_norms = part_norms(
                        (n, m / (1 - b1))
                        for n, m in self._adam("exp_avg").items())
        p0 = model.make_params(cfg, self.weight_seed, dev)
        with torch.no_grad():
            self.update_norms = part_norms(
                (n, p - p0[n]) for n, p in state.model.named_parameters())
        del p0
        self.searched, self.built = searched, built

    @contextlib.contextmanager
    def _recorded(self):
        """Records the search's rows and the device batch of each step run
        inside, on their way out of the program."""
        task, index = self.task, self.task.index
        searched, built = [], []

        def search(q, k=None):
            scores, rows = type(index).search(index, q, k)
            searched.append(rows.detach().clone())
            return scores, rows

        def build(batch, retrieved=None):
            out = type(task).build_device_batch(task, batch, retrieved)
            built.append([t.detach().cpu() for t in out])
            return out

        index.search, task.build_device_batch = search, build
        try:
            yield searched, built
        finally:
            del index.search, task.build_device_batch
            searched[:] = [r.cpu() for r in searched]

    def _adam(self, key):
        """AdamW's ``key`` moment by leaf (zeros for a leaf it holds none
        for: one that got no gradient)."""
        state = self.task.state
        adam = state.optimizer.adamw.state
        return {n: adam[p][key] if key in adam.get(p, {})
                else torch.zeros_like(p)
                for n, p in state.model.named_parameters()}

    # ------------------------------------------------------------ the window

    def unit(self):
        m = self.task.train_step(self._qa_batch())
        return 1, math.isfinite(float(m["loss"]))

    def end_to_end(self, units, window_s):
        return {"train_step_ms": 1e3 * window_s / units}

    def _shapes(self):
        c = self.cfg
        return (c["retriever"], c["reader"],
                self.traffic["questions_per_step"], c["topk"],
                c["query_seq_len"], c["context_seq_len"],
                c["reader_seq_len"], c["decoder_seq_len"])

    def record(self):
        """The traced run's readings, after the window: the stage timer
        over ``stage_steps`` more steps of the same task."""
        self.timer.on = True
        for _ in range(int(self.traffic["stage_steps"])):
            self.unit()
        self.timer.on = False
        return {"stage_ms": dict(self.timer.ms),
                "flops_per_unit": counts.model_flops_per_step(*self._shapes()),
                "attention_per_unit": counts.train_step_attention(
                    *self._shapes())}

    def release(self):
        """Saves the task's state to the host, runs one more step through
        the same ``train_step`` (recorded as the check steps are), keeps
        its readings for the check, and frees the program."""
        task = self.task
        state = task.state
        b1 = state.optimizer.cfg.adam_beta1
        with torch.no_grad():
            saved = {"step": state.step, "count": state.optimizer.count,
                     "batch": self.next_batch,
                     "params": {n: _host(p) for n, p
                                in state.model.named_parameters()},
                     "m": {n: _host(t) for n, t
                           in self._adam("exp_avg").items()},
                     "v": {n: _host(t) for n, t
                           in self._adam("exp_avg_sq").items()}}
        with self._recorded() as (searched, built):
            metrics = _floats(task.train_step(self._qa_batch()))
        moved = self._adam("exp_avg")
        with torch.no_grad():
            grads = part_norms(
                (n, (m - b1 * saved["m"][n].to(m.device)) / (1 - b1))
                for n, m in moved.items())
            update = part_norms(
                (n, p - saved["params"][n].to(p.device))
                for n, p in state.model.named_parameters())
        self.last = {"saved": saved, "searched": searched, "built": built,
                     "grad_norm": metrics["grad_norm"], "grad_norms": grads,
                     "update_norms": update}
        self.task = None

    # ------------------------------------------------------------- the check

    def check(self):
        model.strict_float32()
        num = model.Numerics("fp32")
        ref = reference_run(self, num, self.searched, self.built,
                            last=self.last)
        got = numbers(program_readings(self), ref)
        return [(name, got[name], self.run.limits[name]) for name in got]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host that the program's in-place updates leave be."""
    return t.detach().to("cpu", copy=True)


def _floats(m) -> dict:
    return {k: float(m[k]) for k in ("loss", "lm_loss", "retriever_loss",
                                     "grad_norm")}


def reference_run(drv, num, chosen=None, built=None, rows=None, last=None):
    """The reference over the check steps. ``chosen``: the rows retrieved
    at each step by what is judged (the program's), whose stage A gap
    it measures and whose passages it formats and trains on; ``None``:
    its own search's. ``built``: the program's stage B arrays, counted
    against its own. ``rows`` keeps the first ``rows`` questions of each
    step (a planted fault). ``last``: the program's step after the
    window, which the reference then runs from the state saved before
    it, under ``out["last"]``. Returns its readings: losses, global
    norms, the first gradient's and the change's norms by leaf, the rows
    it trained on."""
    cfg, dev = drv.cfg, drv.dev
    p = {n: t.clone().requires_grad_(True) for n, t in
         model.make_params(cfg, drv.weight_seed, dev).items()}
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
        out["update_norms"] = part_norms((n, p[n] - p0[n]) for n in p)
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
            r["update_norms"] = part_norms(
                (n, p[n] - saved["params"][n].to(dev)) for n in p)
        out["last"] = r
    return out


def _reference_step(drv, num, p, opt, stored, corpus, step, batch_index,
                    chosen, built, rows):
    """One step of the reference on batch ``batch_index`` with the dropout
    masks of step ``step``: stage A's gap of ``chosen`` (its own top k
    when None), the passages formatted (counted against ``built``, the
    program's arrays, when given), the loss, its gradient and AdamW."""
    cfg, dev = drv.cfg, drv.dev
    ids = world.special_ids(cfg)
    K = cfg["topk"]
    t0 = time.perf_counter()
    q = world.make_questions(cfg, drv.traffic, drv.question_seed, batch_index)
    qids = torch.as_tensor(q.ids, dtype=torch.long, device=dev)
    gap, prog = stage_a(p, stored, qids, chosen, cfg, num)
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
    loss = train.step_loss(
        p, x, cfg, model.step_seeds(drv.run.seed, step), num, ids["eos"],
        block_rows=int(drv.traffic.get("reference_block_rows", 16)),
        rows=rows)
    norm, grads = opt.step()
    grad_norms = part_norms(grads.items())
    del grads
    seconds = time.perf_counter() - t0
    print(f"reference step {step}: {seconds:.1f} s", file=sys.stderr,
          flush=True)
    return {"retrieval_gap": gap, "format_mismatches": mismatches,
            "losses": loss, "grad_norm": norm, "rows": prog.cpu(),
            "seconds": seconds, "grad_norms": grad_norms}


def stand_in(drv, num, rows=None):
    """(what stands in the program's place, the float32 reference that
    follows its selection) over the check steps: the reference in the
    control's precision ``num``, or keeping ``rows`` questions a step (a
    planted fault). A stand-in has no window, so no step after it."""
    got = reference_run(drv, num, rows=rows)
    if drv.dev.type == "cuda":
        torch.cuda.empty_cache()
    return got, reference_run(drv, model.Numerics("fp32"), got["rows"])


def stage_a(p, stored, qids, chosen, cfg, num):
    """(gap, rows) of one step's search: the reference's exact top k over
    the stored rows with its own question embeddings, and how far below
    its k-th score the lowest of ``chosen`` (the rows judged; its own top
    k when None) lies, in its scores' standard deviations, widest over the
    questions."""
    K = cfg["topk"]
    with torch.no_grad():
        qe = model.bert_cls(p, "retriever.query_model.", qids,
                            cfg["retriever"], None, num)
        scores = search.exact_scores(qe, stored)
        top = torch.topk(scores, K, dim=1)
        rows = chosen[:, :K].to(qids.device) if chosen is not None \
            else top.indices
        got = scores.gather(1, rows).min(dim=1).values
        gap = (top.values[:, -1] - got) / scores.std(dim=1)
    return float(gap.max()), rows


def first_step_gap(drv, rows, num) -> float:
    """Stage A's gap of the first step alone, for the rows ``rows``."""
    cfg, dev = drv.cfg, drv.dev
    p = model.make_params(cfg, drv.weight_seed, dev)
    stored = search.quantize_rows(
        world.make_index_rows(cfg, drv.index_seed, dev),
        cfg["index_group_size"])
    q = world.make_questions(cfg, drv.traffic, drv.question_seed, 0)
    qids = torch.as_tensor(q.ids, dtype=torch.long, device=dev)
    return stage_a(p, stored, qids, rows, cfg, num)[0]


FUSED = {"qkv": 3, "key_value": 2}


def part_norms(named) -> dict:
    """Norms of the published parameters: a fused projection of the port's
    layout ([q | k | v], [k | v] along its last axis) counts as the
    separate projections the architecture states, ``name[i]``."""
    names, tensors = [], []
    for name, t in named:
        n = FUSED.get(name.split(".")[-2], 1)
        chunks = t.chunk(n, dim=-1) if n > 1 else (t,)
        for i, c in enumerate(chunks):
            names.append(f"{name}[{i}]" if n > 1 else name)
            tensors.append(c.float().norm())
    return dict(zip(names, torch.stack(tensors).tolist()))


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference's norm of that leaf and its median leaf's."""
    names = [n for n in reference if keep is None or keep(n)]
    med = statistics.median(reference[n] for n in names)
    return max(abs(program[n] - reference[n]) / max(reference[n], med)
               for n in names)


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared: ``prog`` is what the program (or what stands
    in its place) produced, ``ref`` the reference's run; each is the
    widest over the check steps and the step after the window (where both
    sides have it). The losses are not compared: the control reads as low
    as the program on some seeds and no fault reads ten times the
    program's highest (PERF.md)."""
    steps = ref["steps"]
    out = {
        "retrieval_gap": ref["retrieval_gap"],
        "format_mismatches": ref["format_mismatches"],
        "grad_norm_gap": max(abs(prog["grad_norm"][s] - ref["grad_norm"][s])
                             / ref["grad_norm"][s] for s in range(steps)),
        "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "update_gap": leaf_gap(prog["update_norms"], ref["update_norms"],
                               _moved(ref["grad_norms"])),
    }
    if "last" in prog and "last" in ref:
        P, R = prog["last"], ref["last"]
        for name, value in (
                ("retrieval_gap", R["retrieval_gap"]),
                ("grad_norm_gap",
                 abs(P["grad_norm"] - R["grad_norm"]) / R["grad_norm"]),
                ("grad_gap", leaf_gap(P["grad_norms"], R["grad_norms"])),
                ("update_gap", leaf_gap(P["update_norms"],
                                        R["update_norms"],
                                        _moved(R["grad_norms"])))):
            out[name] = max(out[name], value)
        out["format_mismatches"] += R["format_mismatches"]
    return out


def _moved(grad_norms: dict):
    """The leaves the change is compared on: those whose reference
    gradient is 1e-3 of the median leaf's or more."""
    med = statistics.median(grad_norms.values())
    return lambda n: grad_norms[n] >= 1e-3 * med


def program_readings(drv) -> dict:
    out = {"losses": [m["loss"] for m in drv.metrics],
           "grad_norm": [m["grad_norm"] for m in drv.metrics],
           "grad_norms": drv.grad_norms,
           "update_norms": drv.update_norms}
    if drv.last is not None:
        out["last"] = drv.last
    return out
