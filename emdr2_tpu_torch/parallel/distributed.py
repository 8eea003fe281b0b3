"""Several processes, one per rank, through ``torch.distributed`` (port of
``emdr2_tpu/parallel/distributed.py``).

The JAX package forms one global device mesh from N processes
(``jax.distributed.initialize``) and lets the compiler insert the
collectives. Here each process is one data-parallel rank with one device,
and the collectives are explicit: ``init_distributed`` makes the process
group, ``DataParallel`` (``parallel/mesh.py``) carries it and the dp and
tp groups made from it, and the helpers below are the only collectives the
port calls: ``all_reduce``, the list form of ``all_gather``, ``broadcast``
and ``broadcast_object_list``.

Backends. NCCL when each rank has a card of its own; gloo on the CPU, and
when ranks share one card (NCCL refuses two ranks on one device). The
choice comes from the device and the ``backend`` argument, never from a
failure: NCCL asked for and missing raises, and a rendezvous that does not
complete within ``timeout_s`` raises.

gloo's transport is host memory: a helper given CUDA tensors under gloo
copies them to the host, runs the collective there and copies the result
back onto the card. The kernels still run on the card; only the bytes of
the collective cross the link.

One process (``num_processes`` of 1 or unset) is the identity: nothing is
initialized and every helper of a one-rank ``DataParallel`` returns its
input.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; ``tcp://`` and ``file://``
    addresses pass through."""
    if address.startswith(("tcp://", "file://")):
        return address
    return f"tcp://{address}"


def init_process_group(address: str, world_size: int, rank: int,
                       backend: str, timeout_s: float = DEFAULT_TIMEOUT_S,
                       device=None) -> None:
    """Join the default process group: rendezvous at ``address``
    (``host:port``, ``tcp://...`` or ``file://...``) with ``world_size``
    ranks, this one ``rank``. Any world size, one included (a one-rank
    NCCL group runs the distributed path on one card). With NCCL the
    rank's ``device`` (``cuda:i``) becomes the current device. Raises if
    NCCL is asked for and not built, or if the rendezvous fails or times
    out."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("the NCCL backend was asked for, but this "
                               "PyTorch has no NCCL; pass backend='gloo' to "
                               "use gloo")
        if device is None or torch.device(device).type != "cuda":
            raise ValueError("the NCCL backend needs the rank's CUDA device")
        dev = torch.device(device)
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(
        backend=backend, init_method=_init_method(address),
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a launch of several processes. A no-op returning False unless
    one is asked for, through the arguments or the environment:
    ``EMDR2_COORDINATOR`` (``host:port``), ``EMDR2_NUM_PROCESSES`` and
    ``EMDR2_PROCESS_ID``, the JAX package's variables. ``backend`` defaults
    to ``default_backend(device)``. Returns True once the group is up."""
    coordinator_address = (coordinator_address
                           or os.environ.get("EMDR2_COORDINATOR"))
    if num_processes is None and "EMDR2_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EMDR2_NUM_PROCESSES"])
    if process_id is None and "EMDR2_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EMDR2_PROCESS_ID"])
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a launch of several processes needs the "
                         "coordinator address and this process's id")
    init_process_group(coordinator_address, num_processes, process_id,
                       backend or default_backend(device), timeout_s,
                       device)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process that owns single-writer side effects (the
    checkpoint, logs): rank 0."""
    return process_index() == 0


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """``obj`` of world rank ``src`` on every rank of ``group`` (default:
    every rank; ``broadcast_object_list``)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
