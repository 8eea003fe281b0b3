"""Where the flagship train step's time goes, pass by pass (port of
``emdr2_tpu/tools/bench_step_breakdown.py``).

Times the step's passes separately at the flagship shape
(``flagship.make_flagship_step``: B x K=50, sequence 512, flash attention,
the reader rematerialised, bf16 compute), with no dropout:

  retriever   the dual-encoder scores' forward and backward
              (``EMDR2Model._topk_log_probs``: query and context towers)
  reader      the student FiD pass's forward and backward (``fid_encode``
              over B*K x 512, the decoder over B x 32 with K*512-key
              cross-attention, the LM head)
  teacher     the stop-gradient one-context teacher, forward only
              (``_teacher_gold_log_probs``)
  optimizer   ``Optimizer.step`` (clip + AdamW) on zero gradients

then the full step (with the recipe's dropout). Each pass prints its
analytic model TFLOPs (``flagship.pass_flops``) and its share of the card's
peak bf16 rate (``flagship.PEAK_OPS_PER_S``; null on a card not in the
table, or the CPU). Host ms over ``--iters`` calls between synchronizes.
Prints one JSON line. Runs on the card unless ``--device cpu``:

    python -m emdr2_tpu_torch.tools.bench_step_breakdown [--batch 4] [--topk 50]
"""

from __future__ import annotations

import argparse
import json

import torch

from emdr2_tpu_torch.tools import flagship


def passes(model, batch):
    """name -> fn() running the pass and returning its value: the sum of
    the retriever's log-probs and the reader's scaled logits (after their
    backward), the teacher's gold log-probs [B, K, Ld]. The gradients go
    to the parameters' ``.grad`` and are dropped before each backward."""
    from emdr2_tpu_torch.data import masks

    def backward(loss):
        model.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach()

    def retriever():
        return backward(torch.sum(model._topk_log_probs(batch)))

    def reader():
        enc_hidden, enc_flat = model.fid_encode(batch.reader_ids)
        m = masks.attention_mask(batch.dec_ids, enc_flat)
        logits = model.reader.decode(batch.dec_ids, enc_hidden, m)
        return backward(torch.sum(logits.float() * 1e-9))

    @torch.no_grad()
    def teacher():
        return model._teacher_gold_log_probs(batch)

    return {"retriever_fwdbwd": retriever, "reader_fwdbwd": reader,
            "teacher_fwd": teacher}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="where to run (default the card; 'cpu' to run "
                        "without one)")
    args = p.parse_args(argv)
    B, K = args.batch, args.topk

    from emdr2_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    step_fn, state, batch = flagship.make_flagship_step(B, K, device=device)
    model, opt = state.model, state.optimizer
    peak = flagship.peak_flops(device)
    fl = flagship.pass_flops(model.config, B, K)

    def opt_update():
        opt.zero_grad()
        opt.step()

    fns = passes(model, batch)
    rows = {}
    for name, fn, flops in (
            ("retriever_fwdbwd", fns["retriever_fwdbwd"], fl["retriever"]),
            ("reader_fwdbwd", fns["reader_fwdbwd"], fl["reader"]),
            ("teacher_fwd", fns["teacher_fwd"], fl["teacher"]),
            ("optimizer", opt_update, 0)):
        dt = flagship.seconds_per_call(fn, args.iters, device)
        rows[name] = {"ms": round(dt * 1000, 1),
                      "model_tflops": round(flops / 1e12, 1),
                      "util_vs_peak": flagship.share_of_peak(flops, dt,
                                                             peak)}
    model.zero_grad(set_to_none=True)

    def full_step():
        step_fn(state, batch)

    dt_full = flagship.seconds_per_call(full_step, args.iters, device)
    rows["full_step"] = {"ms": round(dt_full * 1000, 1)}
    rows["sum_of_parts_ms"] = round(
        sum(v["ms"] for k, v in rows.items() if k != "full_step"), 1)
    out = {"device": flagship.device_kind(device), "B": B, "K": K,
           "breakdown": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
