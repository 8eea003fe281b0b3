"""The data-parallel cell (``openqa-dp4``) at ``tiny``'s sizes on the CPU:
four ranks over gloo, each a process, and the faults that exist only
across ranks, planted in every rank's process (the rank-0 process plants
its own and names them in ``overrides["faults"]``, which the driver hands
to the ranks it starts)."""

import json
import os
import subprocess
import sys

from benchmark.tests import tiny

HERE = tiny.HERE


def openqa_dp(**changes):
    """``tiny.openqa``'s configuration under the cell's traffic, cut to
    ``tiny``'s sizes: two questions a rank, four ranks."""
    out = tiny.openqa(**changes)
    traffic = json.loads((HERE / "workloads" / "openqa-dp4.json")
                         .read_text())
    traffic.update({k: out["traffic"][k] for k in (
        "questions_per_step", "question_tokens", "answer_tokens",
        "passage_tokens", "reference_block_rows")})
    out["traffic"] = traffic
    return out


def run(overrides: dict, seed: int = 7, seconds: float = 0.0,
        trace: bool = False, fault: str = None):
    """One run of ``openqa-dp4`` on the CPU -> the result line's object;
    ``fault`` (a name of ``FAULTS``) planted in every rank."""
    if fault:
        overrides = dict(overrides, faults=[fault])
    args = json.dumps({"overrides": overrides, "seed": seed,
                       "seconds": seconds, "trace": trace})
    r = subprocess.run([sys.executable, "-m", "benchmark.tests.tiny_dp",
                        args], cwd=HERE.parent, capture_output=True,
                       text=True, timeout=1200,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    if r.returncode != 0:
        raise RuntimeError(f"tiny dp run failed ({r.returncode}):\n"
                           f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def plant(names) -> None:
    for name in names:
        FAULTS[name]()


# ------------------------------------------------- faults planted underneath

def no_all_reduce():
    """The gradient's all-reduce over the ranks is left out: each rank
    steps on its own share of the global loss's gradient."""
    from emdr2_tpu_torch.parallel.mesh import DataParallel

    def kept(self, params, *a, **kw):
        return None

    DataParallel.all_reduce_grads_ = kept


class _Alone:
    """A rank's group of itself alone, its block of the index where it
    is: no collective runs."""

    def __init__(self, rank: int):
        self.rank, self.world_size = rank, 1
        self.world = self

    def all_gather(self, t):
        return t[None]

    def all_gather_rows(self, t):
        return t


class _AloneData(_Alone):
    def __init__(self, rank: int):
        super().__init__(0)
        self.world = _Alone(rank)


def local_topk():
    """The search's exchange between ranks is left out: each rank keeps
    the top k of its own shard for its own questions, without
    ``sharded_mips_topk``'s all-gathers and merge."""
    from emdr2_tpu_torch.retrieval import index
    real = index.sharded_mips_topk

    def alone(local_queries, local_shard, k, dp, **kw):
        rank = getattr(dp, "world", dp).rank
        return real(local_queries, local_shard, k, _AloneData(rank), **kw)

    index.sharded_mips_topk = alone


FAULTS = {f.__name__: f for f in (no_all_reduce, local_topk)}


if __name__ == "__main__":
    from benchmark import harness
    a = json.loads(sys.argv[1])
    plant(a["overrides"].get("faults", ()))
    manifest = harness.read_json(HERE.parent / "BENCHMARK.json")
    r = harness.Run(manifest, "openqa-dp4", a["seed"], a["seconds"],
                    a["trace"], device="cpu", overrides=a["overrides"])
    try:
        result = harness.execute(r, require_card=False)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        sys.exit(2)
    finally:
        r.close()
    print(json.dumps(result))
