"""Driver of the evidence embedder's cells:
``EvidenceIndexBuilder.embed_corpus(row_partition=...)`` through the
context tower, at the builder's batch, with its rows going to the host in
fp16, as a DPR index build and the OPENQA embedder's refresh run it.

Set-up writes the corpus in the evidence store's files, builds the context
tower with the seed's weights and embeds one partition's first two batches
(every batch has the builder's size, so that is every shape). The window
embeds partitions of ``partition_rows`` passages in turn over the corpus,
keeping each partition's rows. The check, after the window: a sample of
``check_rows`` of all the rows the window embedded, drawn from the seed,
against the plain reference's [CLS] states of the same passages, formatted
again from the corpus, in float32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import world
from benchmark.counts import flops as counts
from benchmark.program import emdr2_config, transformer
from benchmark.reference import formatting, model

TOWER = "context_model."


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.config, run.traffic
        self.dev = torch.device(run.device)
        self.weight_seed, self.corpus_seed, self.sample_seed = run.streams(3)
        self.rows = int(self.traffic["partition_rows"])
        self.n_parts = self.cfg["num_passages"] // self.rows
        self.done = 0
        self.outputs = []

    def make_world(self):
        self.corpus = world.make_corpus(self.cfg, self.traffic,
                                        self.corpus_seed, self.run.workdir)

    def setup(self):
        from emdr2_tpu_torch.data.evidence import EvidenceCorpus
        from emdr2_tpu_torch.models.bert import BertEncoder
        from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder

        cfg, dev = self.cfg, self.dev
        ids = world.special_ids(cfg)
        self.make_world()
        evidence = EvidenceCorpus.load(self.corpus.text_prefix,
                                       self.corpus.title_prefix)
        tower = BertEncoder(transformer(cfg["retriever"]), device=dev)
        weights = model.make_params(cfg, self.weight_seed, dev, TOWER)
        tower.load_state_dict({n[len(TOWER):]: t for n, t in weights.items()},
                              strict=True)
        del weights
        self.builder = EvidenceIndexBuilder(
            emdr2_config(cfg), tower.eval(), evidence, ids["cls"],
            ids["sep"], ids["pad"], batch_size=cfg["embed_batch"])
        self.builder.embed_corpus(row_partition=(0, 2 * cfg["embed_batch"]))

    def unit(self):
        part = self.done % self.n_parts
        self.done += 1
        start = part * self.rows
        out = self.builder.embed_corpus(
            row_partition=(start, start + self.rows))
        self.outputs.append((start, out))
        return len(out), True

    def end_to_end(self, units, window_s):
        return {"embed_passages_per_s": units / window_s}

    def record(self):
        c = self.cfg
        batch = c["embed_batch"]
        calls = counts.embed_batch_attention(c["retriever"], batch,
                                             c["context_seq_len"])
        return {"flops_per_unit": counts.embed_flops_per_passage(
                    c["retriever"], c["context_seq_len"]),
                "attention_per_unit": [(f / batch, b / batch, n)
                                       for f, b, n in calls]}

    def release(self):
        self.builder = None

    def check(self):
        model.strict_float32()
        got, want = program_and_reference(self, model.Numerics("fp32"))
        return [("row_gap", row_gap(got, want),
                 self.run.limits["row_gap"])]


def sample(drv):
    """(passage ids, the program's rows) of ``check_rows`` rows drawn from
    the seed among all the window's rows."""
    sizes = [len(o) for _, o in drv.outputs]
    total = sum(sizes)
    n = min(int(drv.traffic["check_rows"]), total)
    picks = np.sort(np.random.default_rng(drv.sample_seed).choice(
        total, size=n, replace=False))
    ends = np.cumsum(sizes)
    docs, rows = [], []
    for i in picks:
        k = int(np.searchsorted(ends, i, side="right"))
        start, out = drv.outputs[k]
        r = int(i - (ends[k] - sizes[k]))
        docs.append(start + r + 1)
        rows.append(out[r])
    return np.asarray(docs), np.stack(rows)


def reference_rows(drv, docs, num, block: int = 64) -> torch.Tensor:
    """The reference's [CLS] states of passages ``docs``."""
    cfg, dev = drv.cfg, drv.dev
    ids = world.special_ids(cfg)
    p = model.make_params(cfg, drv.weight_seed, dev, TOWER)
    corpus = formatting.Corpus(drv.corpus.texts, drv.corpus.titles,
                               drv.corpus.group_of)
    tok, types = formatting.embedder_rows(corpus, docs,
                                          cfg["context_seq_len"], ids["cls"],
                                          ids["sep"], ids["pad"])
    out = []
    with torch.no_grad():
        for s in range(0, len(docs), block):
            out.append(model.bert_cls(
                p, TOWER, torch.as_tensor(tok[s:s + block], device=dev),
                cfg["retriever"], None, num,
                torch.as_tensor(types[s:s + block], device=dev)))
    return torch.cat(out)


def program_and_reference(drv, num):
    docs, got = sample(drv)
    want = reference_rows(drv, docs, num)
    return torch.as_tensor(got, dtype=torch.float32), want.cpu()


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest relative distance of a row from the reference's."""
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


def stand_in_gap(drv, docs, num) -> float:
    """``row_gap`` of the reference in the control's precision ``num``, put
    in the program's place (its rows go to the host in fp16, as the
    program's do), judged by the float32 reference, on passages ``docs``."""
    got = reference_rows(drv, docs, num)
    want = reference_rows(drv, docs, model.Numerics("fp32"))
    return row_gap(got.to(torch.float16).float().cpu(), want.cpu())
