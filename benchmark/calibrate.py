"""The readings the limits of ``benchmark/limits/<cell>.json`` are set
from, on the card at the cell's own size, in one process:

- ``program``: the program's sound runs, one a seed: set-up (with the
  cell's check steps), ``--units`` units of work (at least one where the
  check needs a window's output), the release (training: the step after
  the window), then the check's numbers and, for training, those of the
  check steps and of the step after apart, and the leaves that read the
  widest gaps;
- ``control``: the reference in float8 (e4m3, one scale a tensor) put in
  the program's place, judged by the float32 reference;
- ``half_batch`` (training): the float32 reference that keeps the first
  half of each batch and averages over it, judged by the whole batch's;
- ``row_altered`` (training): stage A's gap when the program's first
  retrieved row of the first question is replaced by another row.

    python3 benchmark/calibrate.py --cell openqa-b8 --seeds 1,2,3 \\
        --units 3 --control-seeds 1,2,3 --fault-seeds 1,2,3 \\
        --out readings/openqa-b8.jsonl

One JSON line a reading goes to ``--out`` and to standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    with open(out, "a") as f:
        f.write(line + "\n")


def worst_leaves(prog: dict, ref: dict, n: int = 5, grads=None):
    """The ``n`` leaves of the widest gaps, [name, gap, program, reference];
    with ``grads`` (the reference's first gradient by leaf) only the leaves
    the update's rule keeps."""
    import statistics
    keep = list(ref)
    if grads is not None:
        gmed = statistics.median(grads.values())
        keep = [k for k in ref if grads[k] >= 1e-3 * gmed]
    med = statistics.median(ref[k] for k in keep)
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med), k, prog[k],
                    ref[k]) for k in keep), reverse=True)
    return [[k, g, p, r] for g, k, p, r in gaps[:n]] + [["median", med]]


def main(argv=None):
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    from benchmark.reference import model

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--units", type=int, default=0,
                    help="units of work between set-up and the check "
                         "(training: the steps before the step after them)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    manifest = harness.read_json(ROOT / "BENCHMARK.json")
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    model.strict_float32()

    def driver(seed):
        run = harness.Run(manifest, args.cell, seed, 0.0, False)
        mod = harness.load_module(
            ROOT / "benchmark" / "drivers" / f"{run.traffic['driver']}.py",
            "bench_driver_" + run.traffic["driver"])
        return run, mod, mod.Driver(run)

    training = None
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        run, mod, drv = driver(seed)
        try:
            drv.setup()
            training = hasattr(mod, "reference_run")
            for _ in range(max(args.units, 0 if training else 1)):
                drv.unit()
            drv.release()
            _free()
            model.strict_float32()
            row = {"kind": "program", "seed": seed}
            if training:
                ref = mod.reference_run(drv, model.Numerics("fp32"),
                                        drv.searched, drv.built,
                                        last=drv.last)
                prog = mod.program_readings(drv)
                row["numbers"] = mod.numbers(prog, ref)
                # the check steps' numbers alone, and the step after the
                # units alone
                row["check_steps"] = mod.numbers(
                    {k: v for k, v in prog.items() if k != "last"}, ref)
                row["step_after"] = mod.numbers(
                    dict(prog["last"], grad_norm=[prog["last"]["grad_norm"]]),
                    dict(ref["last"], steps=1,
                         grad_norm=[ref["last"]["grad_norm"]]))
                for part in ("", "last"):
                    p_, r_ = (prog[part], ref[part]) if part else (prog, ref)
                    row["worst_grad" + part] = worst_leaves(
                        p_["grad_norms"], r_["grad_norms"])
                    row["worst_update" + part] = worst_leaves(
                        p_["update_norms"], r_["update_norms"],
                        grads=r_["grad_norms"])
                row["losses"] = [prog["losses"], ref["losses"]]
                row["reference_s"] = ref["seconds"]
                # stage A's gap with one retrieved row replaced
                altered = [r.clone() for r in drv.searched]
                altered[0][0, 0] = (altered[0][0, 0] + 654321) % \
                    run.config["index_rows"]
                row["row_altered_gap"] = mod.first_step_gap(
                    drv, altered[0], model.Numerics("fp32"))
            else:
                got, want = mod.program_and_reference(
                    drv, model.Numerics("fp32"))
                row["numbers"] = {"row_gap": mod.row_gap(got, want)}
            row["seconds"] = time.perf_counter() - t0
            _emit(args.out, row)
        finally:
            run.close()
            del drv
            _free()

    for kind, seed_list in (("control", seeds(args.control_seeds)),
                            ("half_batch", seeds(args.fault_seeds))):
        for seed in seed_list:
            t0 = time.perf_counter()
            run, mod, drv = driver(seed)
            try:
                drv.make_world()
                row = {"kind": kind, "seed": seed}
                if hasattr(mod, "reference_run"):
                    half = run.traffic["questions_per_step"] // 2
                    got, ref = mod.stand_in(
                        drv, model.Numerics("fp8" if kind == "control"
                                            else "fp32"),
                        rows=None if kind == "control" else half)
                    row["numbers"] = mod.numbers(got, ref)
                    row["worst_update"] = worst_leaves(
                        got["update_norms"], ref["update_norms"],
                        grads=ref["grad_norms"])
                else:
                    import numpy as np
                    rng = np.random.default_rng(seed)
                    docs = np.sort(rng.choice(
                        run.config["num_passages"],
                        size=int(run.traffic["check_rows"]),
                        replace=False)) + 1
                    row["numbers"] = {"row_gap": mod.stand_in_gap(
                        drv, docs, model.Numerics("fp8"))}
                row["seconds"] = time.perf_counter() - t0
                _emit(args.out, row)
            finally:
                run.close()
                del drv
                _free()


if __name__ == "__main__":
    main()
