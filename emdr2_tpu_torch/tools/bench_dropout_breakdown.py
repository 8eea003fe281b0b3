"""The flagship train step's dropout cost, by group of sites (port of
``emdr2_tpu/tools/bench_dropout_breakdown.py``).

The step's dropout masks come from the K0 counter hash
(``ops/hashing.py``): in plain PyTorch at the hidden sites (embeddings,
every residual branch) and inside the flash kernels for attention. This
tool runs the flagship B=4 / K=50 train step
(``flagship.make_flagship_step``) under four rate settings and reports ms
per step for each, so the two groups' costs separate:

    base   hidden=0.1  attention=0.1   (the training default)
    hid0   hidden=0.0  attention=0.1   -> base - hid0 = the hidden sites
    att0   hidden=0.1  attention=0.0   -> base - att0 = attention
    det    hidden=0.0  attention=0.0   (no dropout at all)

Each variant runs in a process of its own (an out-of-memory error leaves
nothing behind for the next one) and prints one JSON row; the row's
``hash`` is ``"k0"``, the port's only mask. ``--out`` appends each row to a
JSON-lines file (no default), and with ``--skip-done`` the variants it
already holds are skipped. Runs on the card unless ``--device cpu``:

    python -m emdr2_tpu_torch.tools.bench_dropout_breakdown [--iters 8] \\
        [--out rows.jsonl --skip-done]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from emdr2_tpu_torch.tools import flagship

MODULE = "emdr2_tpu_torch.tools.bench_dropout_breakdown"
HASH = "k0"
VARIANTS = {
    "base": (0.1, 0.1),
    "hid0": (0.0, 0.1),
    "att0": (0.1, 0.0),
    "det": (0.0, 0.0),
}


def run_variant(name: str, iters: int, device) -> dict:
    """One variant's row: its rates, the seconds to make the step
    (``compile_s``: weights, optimizer, batch; the port compiles nothing
    there) and ``ms_per_step`` after one warm step, or ``error`` with the
    exception that stopped it."""
    hid, att = VARIANTS[name]
    row = {"variant": name, "hidden_dropout": hid, "attention_dropout": att,
           "hash": HASH}
    try:
        t0 = time.perf_counter()
        step_fn, state, batch = flagship.make_flagship_step(
            4, 50, hidden_dropout=hid, attention_dropout=att, device=device)
        row["compile_s"] = round(time.perf_counter() - t0, 1)
        dt = flagship.seconds_per_call(lambda: step_fn(state, batch), iters,
                                       device)
        row["ms_per_step"] = round(dt * 1000, 1)
    except Exception as e:    # an out-of-memory row is data, not a failure
        traceback.print_exc()
        row["error"] = f"{type(e).__name__}: {e}"[:400]
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default="base,hid0,att0,det")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--out", default=None,
                   help="a JSON-lines file each row is appended to (none: "
                        "the rows print to stdout only)")
    p.add_argument("--skip-done", action="store_true",
                   help="skip the variants --out already holds")
    p.add_argument("--variant", default=None,
                   help="internal: run ONE variant in this process")
    p.add_argument("--device", default="cuda",
                   help="where to run (default the card; 'cpu' to run "
                        "without one)")
    args = p.parse_args(argv)

    if args.variant:
        from emdr2_tpu_torch.utils.device import resolve_device
        row = run_variant(args.variant, args.iters,
                          resolve_device(args.device))
        flagship.append_row(args.out, row)
        print(json.dumps(row), flush=True)
        return [row]

    done = set()
    if args.skip_done:
        done = {(r["variant"], r.get("hash")) for r in
                flagship.read_rows(args.out) if "ms_per_step" in r}
    rows = []
    for name in args.variants.split(","):
        if (name, HASH) in done:
            print(f"skip {name}/{HASH} (done)", file=sys.stderr, flush=True)
            continue
        print(f"variant {name} (hash={HASH}) ...", file=sys.stderr,
              flush=True)
        child = ["--variant", name, "--iters", str(args.iters),
                 "--device", args.device]
        row, failure = flagship.child_row(
            MODULE, child + (["--out", args.out] if args.out else []))
        if row is None:
            hid, att = VARIANTS[name]
            row = {"variant": name, "hidden_dropout": hid,
                   "attention_dropout": att, "hash": HASH,
                   "error": f"variant process died {failure}"[:400]}
            flagship.append_row(args.out, row)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
