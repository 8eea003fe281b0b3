"""A card's train-throughput frontier: batch x remat layout x index
residency (port of ``emdr2_tpu/tools/bench_train_sweep.py``).

The reference trains EMDR2 at batch 8 a GPU. This tool runs the flagship
train step (``flagship.make_flagship_step``, K=50) at each batch of
``--bs`` under two remat layouts:

    towers  the reader rematerialised, the towers storing their
            activations (the recipe's ``--remat --no-remat-towers``)
    full    every stack rematerialised (the least memory)

each with the card's index shard (``flagship.SHARD_ROWS`` x 768) resident
beside it as training holds it: ``int8`` (rows + group scales), ``bf16``,
or ``none``. The slab is allocated before the train state, as training
brings the index up first. Each row reports ms per step, examples/s and
the model's FLOP share of the card's peak (``flagship``'s
``model_flops_per_step`` and ``PEAK_OPS_PER_S``; null off the table). An
out-of-memory row is data: it carries ``error`` and the message.

Each row runs in a process of its own (an out-of-memory error leaves
nothing behind for the next row) and prints one JSON line; ``--out``
appends each row to a JSON-lines file (no default), and ``--skip-done``
skips the rows it already holds. Runs on the card unless ``--device cpu``:

    python -m emdr2_tpu_torch.tools.bench_train_sweep \\
        --bs 4,5,6,8 --policies towers,full --residency int8,none,bf16 \\
        [--out rows.jsonl --skip-done]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from emdr2_tpu_torch.tools import flagship

MODULE = "emdr2_tpu_torch.tools.bench_train_sweep"


def alloc_residency(kind: str, device):
    """The resident index slab as training holds it: bf16 rows, or int8
    rows + one fp32 scale a group; None for ``none``. The caller keeps the
    tensors referenced while it times."""
    if kind == "none":
        return None
    cfg = flagship.base_config().index
    n, d = flagship.SHARD_ROWS, cfg.embed_dim
    if kind == "bf16":
        return (torch.zeros((n, d), dtype=torch.bfloat16, device=device),)
    if kind == "int8":
        return (torch.zeros((n, d), dtype=torch.int8, device=device),
                torch.ones((n // cfg.group_size,), dtype=torch.float32,
                           device=device))
    raise ValueError(kind)


def run_row(B: int, policy: str, residency: str, iters: int, device
            ) -> dict:
    row = {"B": B, "policy": policy, "residency": residency}
    slab = None
    try:
        # the slab first (training brings the index up before the train
        # state), then the parameters and AdamW, then the step's workspace
        slab = alloc_residency(residency, device)
        t0 = time.perf_counter()
        step_fn, state, batch = flagship.make_flagship_step(
            B, 50, remat_policy="nothing", remat_towers=(policy == "full"),
            device=device)
        row["compile_s"] = round(time.perf_counter() - t0, 1)
        dt = flagship.seconds_per_call(lambda: step_fn(state, batch), iters,
                                       device)
        row["ms_per_step"] = round(dt * 1000, 1)
        row["examples_per_sec_per_chip"] = round(B / dt, 3)
        mflops = flagship.model_flops_per_step(state.model.config, B, 50)
        row["model_flops_util"] = flagship.share_of_peak(
            mflops, dt, flagship.peak_flops(device))
        row["device"] = flagship.device_kind(device)
        del state, batch, step_fn
    except Exception as e:    # an out-of-memory row is data, not a failure
        traceback.print_exc()
        row["error"] = f"{type(e).__name__}: {e}"[:400]
    finally:
        del slab
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bs", default="4,5,6,8")
    p.add_argument("--policies", default="towers,full",
                   help="towers = reader remat + towers stored (the default "
                        "recipe); full = per-layer remat everywhere")
    p.add_argument("--residency", default="int8,none,bf16")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--out", default=None,
                   help="a JSON-lines file each row is appended to (none: "
                        "the rows print to stdout only)")
    p.add_argument("--skip-done", action="store_true",
                   help="skip the rows --out already holds")
    p.add_argument("--row", default=None,
                   help="internal: run ONE row ('B:policy:residency') in "
                        "this process")
    p.add_argument("--device", default="cuda",
                   help="where to run (default the card; 'cpu' to run "
                        "without one)")
    args = p.parse_args(argv)

    if args.row:
        from emdr2_tpu_torch.utils.device import resolve_device
        b, policy, res = args.row.split(":")
        row = run_row(int(b), policy, res, args.iters,
                      resolve_device(args.device))
        flagship.append_row(args.out, row)
        print(json.dumps(row), flush=True)
        return [row]

    done = set()
    if args.skip_done:
        done = {(r["B"], r["policy"], r["residency"])
                for r in flagship.read_rows(args.out)
                if "ms_per_step" in r or "error" in r}
    rows = []
    for policy in args.policies.split(","):
        for B in (int(b) for b in args.bs.split(",")):
            for res in args.residency.split(","):
                key = (B, policy, res)
                if key in done:
                    print(f"skip {key} (done)", file=sys.stderr, flush=True)
                    continue
                print(f"row B={B} policy={policy} residency={res} ...",
                      file=sys.stderr, flush=True)
                child = ["--row", f"{B}:{policy}:{res}", "--iters",
                         str(args.iters), "--device", args.device]
                row, failure = flagship.child_row(
                    MODULE, child + (["--out", args.out] if args.out
                                     else []))
                if row is None:
                    row = {"B": B, "policy": policy, "residency": res,
                           "error": f"row process died {failure}"[:400]}
                    flagship.append_row(args.out, row)
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


if __name__ == "__main__":
    main()
