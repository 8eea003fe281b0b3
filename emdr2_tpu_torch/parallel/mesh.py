"""The data-parallel group and the index's row partition (port of
``emdr2_tpu/parallel/mesh.py``).

The JAX package builds a ``[dp, tp]`` device mesh and expresses every
parallel layout as a sharding against it. The port keeps one axis, ``dp``:
one process per rank, each feeding a contiguous slice of the global batch,
holding a contiguous block of the evidence index's rows, and reducing its
gradients with the others before the optimizer (``training/step.py``).
``DataParallel`` is that group and its collectives; ``DataParallel.local()``
is the one-rank group of a single process, whose collectives return their
input without a call.

The embedder group (``MeshConfig.embed_devices > 0``, the JAX
``build_meshes``' disjoint sub-mesh, the reference's indexer ranks): rank r
trains on card r and the next ``embed_devices`` visible cards re-embed the
evidence, no card doing both. The function ``embed_devices`` hands rank r
its share of them: ``embed_devices / dp`` cards of its own when there are at
least as many embedder cards as ranks, else one card that ``dp /
embed_devices`` ranks share. Each rank's embedder works for that rank
alone (``training/async_refresh.py``) and issues no collective, so the
group needs no process group of its own. Tensor parallelism
(``MeshConfig.tp > 1``) is not ported yet (ROADMAP A3);
``check_mesh_config`` refuses it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from emdr2_tpu_torch.config import MeshConfig
from emdr2_tpu_torch.parallel import distributed as dist_lib

# gradient all-reduce buckets: fixed, in parameter order
GRAD_BUCKET_BYTES = 32 * 2 ** 20


def check_mesh_config(cfg: MeshConfig, world_size: int,
                      n_cards: Optional[int] = None) -> None:
    """Raise unless ``cfg`` is a data-parallel layout over ``world_size``
    processes, with an embedder group that divides over its ranks and,
    given ``n_cards`` (the visible cards; None on the CPU, where every
    device is the host), fits beside the trainers."""
    if cfg.tp != 1:
        raise NotImplementedError(
            f"--tp {cfg.tp}: tensor parallelism (vocab-parallel "
            f"cross-entropy, head-sharded kernels) is not ported yet "
            f"(ROADMAP A3); use --tp 1")
    dp, embed = cfg.dp, cfg.embed_devices
    if embed < 0:
        raise ValueError(f"--embed-devices {embed} must be 0 or more")
    if embed and embed % dp and dp % embed:
        raise ValueError(
            f"--embed-devices {embed} does not divide over --dp {dp}: the "
            f"embedder cards must be a multiple of the ranks (each rank "
            f"takes embed-devices / dp cards) or divide them (dp / "
            f"embed-devices ranks share a card)")
    if embed and n_cards is not None and dp + embed > n_cards:
        raise ValueError(
            f"--dp {dp} --embed-devices {embed} needs dp + embed-devices = "
            f"{dp + embed} visible cards (trainers on cards 0..{dp - 1}, "
            f"embedders after them), {n_cards} visible")
    if cfg.dp != world_size:
        raise ValueError(f"--dp {cfg.dp} needs {cfg.dp} processes, one a "
                         f"rank; this launch has {world_size}")


def embed_devices(cfg: MeshConfig, rank: int,
                  device: torch.device) -> List[torch.device]:
    """Rank ``rank``'s embedder devices beside its trainer ``device``
    (card ``rank``): cards ``dp + rank * E/dp ...`` of its own when E >=
    dp, else card ``dp + rank // (dp/E)``, shared; the trainer's own card
    without an embedder group; on the CPU as many CPU devices (the
    layout's code runs unchanged there). The JAX ``build_meshes`` puts the
    embedder sub-mesh on the devices after the train mesh in the same
    way."""
    dp, embed = cfg.dp, cfg.embed_devices
    if embed == 0:
        return [device]
    if embed >= dp:
        per = embed // dp
        idx = [dp + rank * per + i for i in range(per)]
    else:
        idx = [dp + rank // (dp // embed)]
    if device.type != "cuda":
        return [device] * len(idx)
    return [torch.device("cuda", i) for i in idx]


def row_range(n_padded: int, rank: int, world_size: int) -> Tuple[int, int]:
    """Rank ``rank``'s rows ``[r * n_padded / W, (r + 1) * n_padded / W)``
    of an index of ``n_padded`` rows (a multiple of ``world_size``)."""
    if n_padded % world_size:
        raise ValueError(f"{n_padded} rows do not divide over {world_size} "
                         f"ranks")
    rows = n_padded // world_size
    return rank * rows, (rank + 1) * rows


class DataParallel:
    """A data-parallel group: ``rank`` of ``world_size`` over the default
    process group with ``backend`` (None: one process, no group). Counts
    the bytes each collective sends from this rank (``bytes_moved``, by
    the name of the collective)."""

    def __init__(self, rank: int, world_size: int,
                 backend: Optional[str] = None):
        self.rank = rank
        self.world_size = world_size
        self.backend = backend
        self.bytes_moved: Dict[str, int] = defaultdict(int)

    @classmethod
    def local(cls) -> "DataParallel":
        """One process, one rank: every collective is the identity."""
        return cls(0, 1)

    @classmethod
    def from_process_group(cls) -> "DataParallel":
        """The default group of an initialized ``torch.distributed``."""
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized "
                               "(parallel.distributed.init_process_group)")
        return cls(dist.get_rank(), dist.get_world_size(),
                   dist.get_backend())

    @property
    def distributed(self) -> bool:
        """True when the collectives really run (a process group exists,
        even of one rank)."""
        return self.backend is not None

    def __repr__(self) -> str:
        return (f"DataParallel(rank={self.rank}, world_size="
                f"{self.world_size}, backend={self.backend!r})")

    # ---- transport -------------------------------------------------------

    def _transport_device(self) -> torch.device:
        """Where the backend takes tensors: host memory for gloo (a CUDA
        tensor goes through it, ``parallel/distributed.py``), the rank's
        card for NCCL (a host tensor goes there)."""
        return (torch.device("cuda", torch.cuda.current_device())
                if self.backend == "nccl" else torch.device("cpu"))

    def _count(self, name: str, t: torch.Tensor) -> None:
        self.bytes_moved[name] += t.numel() * t.element_size()

    # ---- collectives -----------------------------------------------------

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if not self.distributed:
            return t
        self._count("all_reduce", t)
        dev = self._transport_device()
        if t.device != dev:
            moved = t.to(dev)
            dist.all_reduce(moved)
            t.copy_(moved)
        else:
            dist.all_reduce(t)
        return t

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """Mean of ``t`` over the ranks, in place; returns ``t``."""
        if not self.distributed:
            return t
        return self.all_reduce_sum_(t).div_(self.world_size)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, out of place."""
        return self.all_reduce_sum_(t.detach().clone())

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[W, *t.shape]: every rank's ``t`` (equal shapes), by rank."""
        if not self.distributed:
            return t[None]
        self._count("all_gather", t)
        src = t.detach().contiguous().to(self._transport_device())
        parts = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        return torch.stack(parts).to(t.device)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[W * n, ...]: every rank's rows ``t`` [n, ...], in rank order."""
        g = self.all_gather(t)
        return g.reshape(-1, *t.shape[1:])

    def broadcast_object(self, obj, src: int = 0):
        if not self.distributed:
            return obj
        return dist_lib.broadcast_object(obj, src=src)

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce of one element, so the order
        with the other collectives is the program's)."""
        if self.distributed:
            self.all_reduce_sum_(torch.zeros(1,
                                             device=self._transport_device()))

    def all_reduce_grads_(self, params: Sequence[torch.nn.Parameter],
                          bucket_bytes: int = GRAD_BUCKET_BYTES) -> None:
        """Replace every ``p.grad`` by its mean over the ranks. The
        gradients are flattened into fixed buckets in parameter order (the
        same on every rank and every step), so the sums repeat bit for
        bit. A parameter without a gradient counts as a zero one."""
        if not self.distributed:
            return
        for bucket in _buckets(params, bucket_bytes):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in bucket]
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.all_reduce_mean_(flat)
            offset = 0
            for p, g in zip(bucket, grads):
                n = g.numel()
                p.grad = flat[offset:offset + n].view_as(g)
                offset += n

    # ---- the index's rows --------------------------------------------------

    def row_range(self, n_padded: int) -> Tuple[int, int]:
        return row_range(n_padded, self.rank, self.world_size)


def _buckets(params: Sequence[torch.nn.Parameter], bucket_bytes: int
             ) -> List[List[torch.nn.Parameter]]:
    """Consecutive runs of parameters of one dtype and device, each closed
    once it holds ``bucket_bytes``."""
    out: List[List[torch.nn.Parameter]] = []
    size = 0
    for p in params:
        nbytes = p.numel() * p.element_size()
        if (not out or size >= bucket_bytes
                or (out[-1][-1].dtype, out[-1][-1].device)
                != (p.dtype, p.device)):
            out.append([])
            size = 0
        out[-1].append(p)
        size += nbytes
    return out
