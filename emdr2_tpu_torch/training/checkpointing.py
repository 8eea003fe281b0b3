"""Checkpoint save / load (port of ``emdr2_tpu/training/checkpointing.py``,
PyTorch files in place of orbax).

- layout: ``<dir>/iter_{it:07d}/state.pt`` + the tracker file
  ``latest_checkpointed_iteration.txt``;
- contents: the model's ``state_dict``, AdamW's state (moments and step
  counts), ``Optimizer.count``, ``TrainState.step`` and ``TrainState.seed``
  (the dropout masks derive from seed and step, so a resumed run repeats
  the uninterrupted one);
- ``load_checkpoint`` with ``load_optim=False`` / an iteration override;
- partial loaders ``load_retriever_params`` / ``load_reader_params``, and
  ``load_model_params`` (the parameters alone, e.g. for serving);
- ``remove_stale_checkpoints`` pruning; ``read_payload`` / ``write_payload``
  for the tools that rewrite checkpoints (``tools/checkpoint_surgery.py``,
  ``tools/convert_reference_checkpoint.py``).

The model is any ``nn.Module``: an ``EMDR2Model``, or the RETRIEVER task's
``DPRModel``, which holds its dual encoder under ``retriever`` as the EMDR2
model does, so ``load_retriever_params`` reads both kinds of checkpoint.

Durability: a checkpoint is written into a temporary directory beside its
place, flushed to disk and renamed; the tracker is written only after that,
so a crash mid-write leaves the tracker at the last complete checkpoint.

Async saves: the train step updates parameters and moments in place, so
``save_checkpoint(async_save=True)`` first copies the whole state to host
memory (pinned buffers, reused from save to save, when the state lies on a
CUDA device) and waits for those copies; only then does it return, and the
disk write and the tracker ride a background thread under the next steps.
At most one save is in flight: every save, load and
``finalize_async_saves`` drains the previous one and re-raises its failure.

Tensor parallelism (``dp.tp``): a checkpoint holds the whole parameters and
Adam moments, the file that one process writes from the same state. The
ranks of world rank 0's replica gather each split parameter and its two
moments over tp (``parallel.tensor.all_gather_params``) before rank 0
stages them; every rank loads the whole tensors and keeps its part
(``parallel.tensor.shard_for``). So a checkpoint written at one tp loads
at any other, bit for bit.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from emdr2_tpu_torch.parallel.tensor import (all_gather_params, is_split,
                                             module_tp, shard_for)
from emdr2_tpu_torch.training.step import TrainState

TRACKER = "latest_checkpointed_iteration.txt"
STATE_FILE = "state.pt"

_PENDING: List[threading.Thread] = []
_ERRORS: List[Exception] = []     # failures of background writes
_PINNED: Dict[Tuple, torch.Tensor] = {}   # host staging buffers, by place


def finalize_async_saves() -> None:
    """Block until every staged save is durable and its tracker written;
    re-raise a background write's failure here (the writer thread records
    it rather than dying silently)."""
    while _PENDING:
        _PENDING.pop(0).join()
    if _ERRORS:
        err = _ERRORS.pop(0)
        _ERRORS.clear()
        raise RuntimeError(
            "a background checkpoint save failed; the tracker was not "
            "advanced past the last durable checkpoint") from err


def iter_dir(root: str, iteration: int) -> str:
    return os.path.join(root, f"iter_{iteration:07d}")


def latest_iteration(root: str) -> Optional[int]:
    tracker = os.path.join(root, TRACKER)
    if os.path.exists(tracker):
        with open(tracker) as f:
            return int(f.read().strip())
    return None


# ------------------------------------------------------------------- staging

def _to_host(tree: Any, place: Tuple, copies: List) -> Any:
    """``tree`` with every tensor replaced by a host copy. CUDA tensors are
    copied without blocking into pinned buffers kept per ``place`` (their
    path in the tree); the caller waits for the copies."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "cuda":
            return tree.detach().clone()
        buf = _PINNED.get(place)
        if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
            buf = torch.empty(tree.shape, dtype=tree.dtype, device="cpu",
                              pin_memory=True)
            _PINNED[place] = buf
        buf.copy_(tree.detach(), non_blocking=True)
        copies.append(tree.device)
        return buf
    if isinstance(tree, dict):
        return {k: _to_host(v, place + (k,), copies) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v, place + (i,), copies)
                          for i, v in enumerate(tree))
    return tree


def _moment_names(state: TrainState) -> List[str]:
    """The parameter names of AdamW's state indices (its ``state_dict``
    numbers the parameters of its groups in order)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.adamw.param_groups
            for p in g["params"]]


def _map_moments(opt_state: Dict[str, Any], names: List[str], fn
                 ) -> Dict[str, Any]:
    """AdamW's ``state_dict`` with ``fn(name, tensor)`` applied to each
    parameter's two moments, in index order."""
    out = dict(opt_state)
    out["state"] = {}
    for i in sorted(opt_state["state"]):
        entry = dict(opt_state["state"][i])
        for key in ("exp_avg", "exp_avg_sq"):
            if key in entry:
                entry[key] = fn(names[i], entry[key])
        out["state"][i] = entry
    return out


def _whole_state(state: TrainState, tp) -> Tuple[Dict, Dict]:
    """(model state_dict, AdamW state_dict) with every tp-split tensor
    gathered whole over ``tp`` (a collective: each tp rank calls it)."""
    model = state.model.state_dict()
    opt = state.optimizer.adamw.state_dict()
    if not is_split(tp):
        return model, opt
    model = all_gather_params(model, tp)
    return model, _map_moments(
        opt, _moment_names(state),
        lambda name, t: all_gather_params({name: t}, tp)[name])


def _stage(state: TrainState, tp=None) -> Dict[str, Any]:
    """The whole train state on the host (split tensors gathered over
    ``tp``). The copies are ordered after the optimizer's update on the
    current stream and are complete on return (one event, no device-wide
    synchronize)."""
    copies: List = []
    model, opt = _whole_state(state, tp)
    payload = {
        "model": model,
        "optimizer": opt,
        "count": state.optimizer.count,
        "step": state.step,
        "seed": state.seed,
    }
    payload = _to_host(payload, (), copies)
    for device in set(copies):
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return payload


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(root: str, iteration: int, payload: Dict[str, Any]) -> str:
    """Write one checkpoint durably, then advance the tracker."""
    path = iter_dir(root, iteration)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(path, ignore_errors=True)       # overwrite an older save
    os.replace(tmp, path)
    _fsync_dir(root)
    tracker_tmp = os.path.join(root, f"{TRACKER}.tmp-{os.getpid()}")
    with open(tracker_tmp, "w") as f:
        f.write(str(iteration))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tracker_tmp, os.path.join(root, TRACKER))
    return path


def save_checkpoint(root: str, state: TrainState, iteration: int,
                    async_save: bool = False, dp=None) -> str:
    """Write the full train state, then the tracker.

    ``async_save=True`` returns once the state is staged on the host (the
    caller may go on mutating it); the disk write and the tracker update
    happen in the background. Use it for interval saves; keep exit and
    final saves synchronous so they are durable before return.

    Under data parallelism (``dp``) the replicas are equal, so world rank
    0 alone writes, after the tp ranks of its replica have gathered the
    split tensors with it; every rank then waits at a barrier (after a
    synchronous save the files are on disk when it opens)."""
    root = os.path.abspath(root)
    world = dp.world if dp is not None else None
    tp = dp.tp if dp is not None else None
    if world is not None and world.distributed and world.rank != 0:
        if is_split(tp) and dp.rank == 0:
            _whole_state(state, tp)            # rank 0's replica gathers
        world.barrier()
        return iter_dir(root, iteration)
    path = _save(root, state, iteration, async_save, tp)
    if world is not None and world.distributed:
        world.barrier()
    return path


def _save(root: str, state: TrainState, iteration: int,
          async_save: bool, tp=None) -> str:
    os.makedirs(root, exist_ok=True)
    finalize_async_saves()    # at most one in flight; ordered tracker writes
    payload = _stage(state, tp)
    if not async_save:
        return _write(root, iteration, payload)

    def _finish():
        try:
            _write(root, iteration, payload)
        except Exception as e:    # surfaced by finalize_async_saves
            _ERRORS.append(e)

    t = threading.Thread(target=_finish, daemon=True,
                         name=f"ckpt-write-{iteration}")
    t.start()
    _PENDING.append(t)
    return iter_dir(root, iteration)


# ------------------------------------------------------------------- loading

def read_payload(root: str, iteration: Optional[int] = None,
                 mmap: bool = False) -> Tuple[Dict[str, Any], int]:
    """The saved dict of a checkpoint (``"model"``: the state_dict, and
    what else was saved) and its iteration (default: the tracker's)."""
    root = os.path.abspath(root)
    finalize_async_saves()    # a staged save may be the one to restore
    if iteration is None:
        iteration = latest_iteration(root)
        if iteration is None:
            raise FileNotFoundError(f"no tracker file in {root}")
    path = os.path.join(iter_dir(root, iteration), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=mmap), iteration


def write_payload(root: str, iteration: int, payload: Dict[str, Any]) -> str:
    """Write a saved dict as the checkpoint of ``iteration``, durably, then
    advance the tracker (synchronous)."""
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    finalize_async_saves()
    return _write(root, iteration, payload)


def load_checkpoint(root: str, state: TrainState,
                    iteration: Optional[int] = None,
                    load_optim: bool = True,
                    dp=None) -> Tuple[TrainState, int]:
    """Restore a checkpoint into ``state`` (an initialized TrainState of the
    same configuration; it is updated in place) -> (state, iteration).

    With ``load_optim=False`` only the parameters are restored: the
    optimizer's state, its update count, the step and the seed of ``state``
    (usually fresh) are kept, for fine-tuning from a checkpoint. Under
    data parallelism (``dp``) world rank 0 first drains its background
    write, then every rank reads the same files, so the replicas restore
    bit for bit alike; under ``dp.tp`` each keeps its part of the whole
    tensors."""
    world = dp.world if dp is not None else None
    if world is not None and world.distributed:
        if world.rank == 0:
            finalize_async_saves()
        world.barrier()
    tp = dp.tp if dp is not None else module_tp(state.model)
    payload, iteration = read_payload(root, iteration)
    if load_optim and "optimizer" not in payload:
        raise ValueError(f"{root} iteration {iteration} holds no optimizer "
                         f"state (a stripped or converted checkpoint): load "
                         f"it with load_optim=False")
    state.model.load_state_dict(shard_for(payload["model"], tp), strict=True)
    if load_optim:
        opt = payload["optimizer"]
        if is_split(tp):
            opt = _map_moments(opt, _moment_names(state),
                               lambda name, t: shard_for({name: t}, tp)[name])
        state.optimizer.adamw.load_state_dict(opt)
        state.optimizer.count = int(payload["count"])
        state.step = int(payload["step"])
        state.seed = int(payload["seed"])
    return state, iteration


def _load_submodule(root: str, iteration: Optional[int], prefix: str,
                    module: torch.nn.Module) -> torch.nn.Module:
    """Load only the parameters under ``prefix`` of a checkpoint into
    ``module`` (strictly: every key must be there; a tp-split module takes
    its part). The file is memory mapped, so the rest of it is not
    read."""
    payload, _ = read_payload(root, iteration, mmap=True)
    sub = {k[len(prefix):]: v for k, v in payload["model"].items()
           if k.startswith(prefix)}
    module.load_state_dict(shard_for(sub, module_tp(module)), strict=True)
    return module


def load_model_params(root: str, model: torch.nn.Module,
                      iteration: Optional[int] = None) -> torch.nn.Module:
    """Every parameter of the checkpoint into ``model`` (a module of the
    configuration that saved it); no optimizer state is read."""
    return _load_submodule(root, iteration, "", model)


def load_retriever_params(root: str, retriever: torch.nn.Module,
                          iteration: Optional[int] = None) -> torch.nn.Module:
    """The dual encoder only (the keys under ``retriever.`` of an EMDR2 or a
    DPR checkpoint), into ``retriever`` (``EMDR2Model.retriever``,
    ``DPRModel.retriever``, or a ``DualEncoder``)."""
    return _load_submodule(root, iteration, "retriever.", retriever)


def load_reader_params(root: str, reader: torch.nn.Module,
                       iteration: Optional[int] = None) -> torch.nn.Module:
    """The T5 reader only, into ``reader``."""
    return _load_submodule(root, iteration, "reader.", reader)


def remove_stale_checkpoints(root: str, keep_last: int = 2) -> None:
    """Prune old ``iter_*`` directories, keeping the newest ``keep_last``."""
    if not os.path.isdir(root):
        return
    iters = sorted(
        int(m.group(1))
        for d in os.listdir(root)
        if (m := re.match(r"iter_(\d+)$", d)) and
        os.path.isdir(os.path.join(root, d)))
    for it in iters[:-keep_last] if keep_last > 0 else iters:
        shutil.rmtree(iter_dir(root, it), ignore_errors=True)
