"""Tiny configurations and traffic of the benchmark's cells, for its CPU
tests: the cells' shapes at widths the CPU runs in seconds, float32
compute, dropout on, the flash attention's plain versions."""

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _tower(vocab):
    return {"vocab_size": vocab, "hidden_size": 64, "num_layers": 2,
            "num_heads": 4, "ffn_size": 128, "max_position_embeddings": 128,
            "num_tokentypes": 2, "hidden_dropout": 0.1,
            "attention_dropout": 0.1, "layernorm_epsilon": 1e-05,
            "init_std": 0.02, "gelu": "erf", "compute_dtype": "float32",
            "flash_attention": True, "flash_key_chunk": 48, "remat": False}


def openqa(**changes):
    cfg = json.loads((HERE / "configs" / "emdr2-nq.json").read_text())
    cfg.update(retriever=_tower(512),
               reader=dict(_tower(640), num_tokentypes=0, remat=True),
               embed_dim=64, query_seq_len=16, context_seq_len=32,
               reader_seq_len=48, decoder_seq_len=8, topk=4, index_rows=4096,
               index_group_size=8, index_chunk_rows=256, num_passages=300)
    cfg["optimizer"] = dict(cfg["optimizer"], train_iters=100, lr=1e-3)
    traffic = json.loads((HERE / "workloads" / "openqa-b8.json").read_text())
    # passages shorter than the reader row's least budget (48 less a
    # prefix of at most 19): the program's C++ stage B aborts the process
    # on a hit that fills the budget exactly with neighbours around it
    # (PERF.md, open questions); at the cells' sizes the budget is >= 472
    # tokens and the passages are <= 140
    traffic.update(questions_per_step=2, question_tokens=[3, 10],
                   answer_tokens=[1, 7], passage_tokens=[10, 18],
                   reference_block_rows=3)
    cfg.update(changes)
    return {"config": cfg, "traffic": traffic}


def embed(**changes):
    cfg = json.loads((HERE / "configs" / "dpr-nq.json").read_text())
    cfg.update(retriever=_tower(512), embed_dim=64, query_seq_len=16,
               context_seq_len=32, embed_batch=16, num_passages=256)
    traffic = json.loads((HERE / "workloads" / "evidence-embed.json")
                         .read_text())
    traffic.update(partition_rows=64, passage_tokens=[20, 40], check_rows=24)
    cfg.update(changes)
    return {"config": cfg, "traffic": traffic}


def run(cell: str, overrides: dict, seed: int = 7, seconds: float = 0.0,
        trace: bool = False, fault: str = None):
    """One run of ``cell`` on the CPU (no look for a card) -> the result
    line's object. It runs in a process of its own, where ``fault`` (a
    name of ``FAULTS``) is planted by replacing a function of the program,
    so that nothing of it outlives the run."""
    r = run_raw(cell, overrides, seed, seconds, trace, fault)
    if r.returncode != 0:
        raise RuntimeError(f"tiny run failed ({r.returncode}):\n"
                           f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run_raw(cell: str, overrides: dict, seed: int = 7, seconds: float = 0.0,
            trace: bool = False, fault: str = None):
    """``run``'s process, as it ended: its exit code and both outputs."""
    args = json.dumps({"cell": cell, "overrides": overrides, "seed": seed,
                       "seconds": seconds, "trace": trace, "fault": fault})
    return subprocess.run([sys.executable, "-m", "benchmark.tests.tiny", args],
                          cwd=HERE.parent, capture_output=True, text=True,
                          timeout=900,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))


def _run_here(cell, overrides, seed, seconds, trace, fault):
    from benchmark import harness
    if fault:
        FAULTS[fault]()
    manifest = harness.read_json(HERE.parent / "BENCHMARK.json")
    r = harness.Run(manifest, cell, seed, seconds, trace, device="cpu",
                    overrides=overrides)
    try:
        return harness.execute(r, require_card=False)
    finally:
        r.close()


# ------------------------------------------------- faults planted underneath

def unchanged_state():
    """The optimizer step returns the state as it was."""
    import torch
    from emdr2_tpu_torch.training import step

    def no_update(self):
        for p in self.params:
            p.grad = None
        self.count += 1
        return torch.ones(())

    step.Optimizer.step = no_update


def unchanged_after_setup():
    """Once set-up's two steps are done, the optimizer step returns the
    state as it was (and the gradient's true norm): the window's steps
    and the one after it."""
    import torch
    from emdr2_tpu_torch.training import step
    real = step.Optimizer.step

    @torch.no_grad()
    def stale(self):
        if self.count < 2:
            return real(self)
        norm = torch.stack([p.grad.float().square().sum()
                            for p in self.params
                            if p.grad is not None]).sum().sqrt()
        for p in self.params:
            p.grad = None
        self.count += 1
        return norm

    step.Optimizer.step = stale


def half_batch():
    """The loss is the mean over the first half of the batch."""
    from emdr2_tpu_torch.training import step
    real = step.emdr2_total_loss

    def half(lm_logits, topk_log_probs, gold_log_probs, labels, loss_mask,
             **kw):
        h = labels.shape[0] // 2
        return real(lm_logits[:h], topk_log_probs[:h], gold_log_probs[:h],
                    labels[:h], loss_mask[:h], **kw)

    step.emdr2_total_loss = half


def token_altered():
    """One token of the reader's rows is altered where stage B makes it."""
    from emdr2_tpu_torch.tasks import e2eqa
    real = e2eqa.postprocess_retrieved

    def altered(**kw):
        out = real(**kw)
        out.reader_ids[0, 0, 3] += 1
        return out

    e2eqa.postprocess_retrieved = altered


def row_altered():
    """One retrieved row is altered where the search returns it."""
    from emdr2_tpu_torch.retrieval.index import ShardedEvidenceIndex
    real = ShardedEvidenceIndex.search

    def altered(self, q, k=None):
        scores, rows = real(self, q, k)
        rows = rows.clone()
        rows[0, 0] = (rows[0, 0] + 1777) % self.n_real
        return scores, rows

    ShardedEvidenceIndex.search = altered


def embedding_altered():
    """One embedded row of every batch is altered where it is made."""
    from emdr2_tpu_torch.retrieval import builder
    real = builder.embed_context

    def altered(module, ids, types):
        out = real(module, ids, types).clone()
        out[5] = -out[5]
        return out

    builder.embed_context = altered


def jax_in_check():
    """The driver's check loads a module named ``jax``."""
    import types
    from benchmark import harness
    real = harness.load_module

    def load(path, name):
        module = real(path, name)
        driver = getattr(module, "Driver", None)
        if driver is not None:
            check = driver.check

            def check_and_load(self):
                sys.modules["jax"] = types.ModuleType("jax")
                return check(self)

            driver.check = check_and_load
        return module

    harness.load_module = load


FAULTS = {f.__name__: f for f in (unchanged_state, unchanged_after_setup,
                                  half_batch, token_altered, row_altered,
                                  embedding_altered, jax_in_check)}


if __name__ == "__main__":
    from benchmark import harness
    a = json.loads(sys.argv[1])
    try:
        result = _run_here(a["cell"], a["overrides"], a["seed"],
                           a["seconds"], a["trace"], a["fault"])
    except harness.Refused as e:            # as the harness's main does
        print(f"refused: {e}", file=sys.stderr)
        sys.exit(2)
    print(json.dumps(result))
