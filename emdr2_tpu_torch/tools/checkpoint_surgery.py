"""Checkpoint surgery over the port's checkpoints (``iter_*/state.pt`` +
tracker; port of ``emdr2_tpu/tools/checkpoint_surgery.py``): extract a
submodel, strip the optimizer state, prune old checkpoints.

- ``extract --submodel retriever|reader``: a checkpoint holding only the
  parameters under ``<submodel>.`` (and the step), which the partial
  loaders (``load_retriever_params`` / ``load_reader_params``, OPENQA's
  ``--pretrained-dpr-load`` / ``--pretrained-t5-load``) read;
- ``strip-optim``: the same checkpoint without the optimizer's state;
- ``prune --keep N``: keep the newest N ``iter_*`` directories.

Usage:
  python -m emdr2_tpu_torch.tools.checkpoint_surgery extract \\
      --load run/ --submodel retriever --save out_dir/
  python -m emdr2_tpu_torch.tools.checkpoint_surgery strip-optim \\
      --load run/ --save slim/
  python -m emdr2_tpu_torch.tools.checkpoint_surgery prune --load run/ --keep 2
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from emdr2_tpu_torch.training import checkpointing as ck

# what an optimizer-free checkpoint drops
_OPTIM_KEYS = ("optimizer", "count")


def extract(load: str, submodel: str, save: str,
            iteration: Optional[int] = None) -> str:
    """Write a checkpoint holding only the parameters under ``submodel.``,
    under their full keys, at the same iteration."""
    payload, it = ck.read_payload(load, iteration)
    prefix = submodel + "."
    sub = {k: v for k, v in payload["model"].items() if k.startswith(prefix)}
    if not sub:
        raise ValueError(f"{load} iteration {it} has no parameters under "
                         f"{prefix!r}")
    return ck.write_payload(save, it, {"model": sub,
                                       "step": payload.get("step", it)})


def strip_optim(load: str, save: str, iteration: Optional[int] = None) -> str:
    """Write the checkpoint without the optimizer's state."""
    payload, it = ck.read_payload(load, iteration)
    slim = {k: v for k, v in payload.items() if k not in _OPTIM_KEYS}
    return ck.write_payload(save, it, slim)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("extract")
    e.add_argument("--load", required=True)
    e.add_argument("--submodel", choices=["retriever", "reader"],
                   required=True)
    e.add_argument("--save", required=True)
    e.add_argument("--iteration", type=int, default=None)
    s = sub.add_parser("strip-optim")
    s.add_argument("--load", required=True)
    s.add_argument("--save", required=True)
    s.add_argument("--iteration", type=int, default=None)
    r = sub.add_parser("prune")
    r.add_argument("--load", required=True)
    r.add_argument("--keep", type=int, default=2)
    args = p.parse_args(argv)

    if args.cmd == "extract":
        print(extract(args.load, args.submodel, args.save, args.iteration))
    elif args.cmd == "strip-optim":
        print(strip_optim(args.load, args.save, args.iteration))
    else:
        ck.remove_stale_checkpoints(args.load, keep_last=args.keep)
        print(f"pruned {args.load} to last {args.keep}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
