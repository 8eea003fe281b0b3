"""The ``[dp, tp]`` grid of ranks, its process groups and the index's row
partition (port of ``emdr2_tpu/parallel/mesh.py``).

The JAX package builds a ``[dp, tp]`` device mesh and expresses every
parallel layout as a sharding against it. The port runs one process per
rank of the same grid, row-major: world rank ``dp_idx * tp + tp_idx``.

- ``dp``: each data-parallel rank feeds a contiguous slice of the global
  batch and reduces its gradients with the others before the optimizer
  (``training/step.py``). Its group holds the ranks with the same tp
  index.
- ``tp``: the ranks with the same dp index hold one replica between them,
  its heads, MLP columns and vocabulary split Megatron-style
  (``parallel/tensor.py``, ``models/layers.py``), and feed the same rows.
- the evidence index's rows split over all ``dp * tp`` ranks (the JAX
  ``index_sharding``), the block of rank r being ``row_range(..., r,
  dp * tp)``.

``DataParallel`` is the dp group and its collectives, and carries the two
others: ``.tp`` (a ``Group`` over the rank's tp ranks) and ``.world``
(every rank: the index's blocks, the coordinator's side effects).
``DataParallel.local()`` is the one-rank grid of a single process, whose
collectives return their input without a call. With ``tp = 1`` the dp
group is the default group and ``.world`` is the dp group itself, so every
group and layout is the one of a data-parallel launch.

The embedder group (``MeshConfig.embed_devices > 0``, the JAX
``build_meshes``' disjoint sub-mesh, the reference's indexer ranks): each
rank trains on its card and its host's next visible cards re-embed the
evidence, no card doing both. On each of the launch's hosts
(``distributed.HostLayout``) its ``t = dp * tp / n_hosts`` trainers take
cards ``0 .. t-1`` (card = local rank) and its ``embed_devices / n_hosts``
embedder cards are the ones after them; the function ``embed_devices``
hands a rank its share of its host's: ``e / t`` cards of its own when the
host has at least as many embedder cards as trainers, else one card that
``t / e`` of them share. Each rank's embedder works for that rank alone
(``training/async_refresh.py``), on a thread of the trainer's process, and
issues no collective, so the group needs no process group of its own. On
one host this is the JAX ``build_meshes``' layout (the embedders on the
devices after the ``n_train = dp * tp`` trainers'); across hosts the JAX
function takes the devices after the trainers in global order, which would
put a rank's embedder on another host's card, where its process cannot
drive it.
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
                      n_cards: Optional[int] = None,
                      model=None, layout=None) -> None:
    """Raise unless ``cfg`` is a ``[dp, tp]`` layout over ``world_size``
    processes (``dp * tp`` of them), with an embedder group that divides
    over the hosts of ``layout`` (a ``distributed.HostLayout``; default
    one host that sees ``n_cards`` cards, None on the CPU, where every
    device is the host) and on each over its trainers, and fits beside them
    in each host's visible cards. ``model`` (an ``EMDR2Config``, a
    ``RetrieverConfig`` or a ``TransformerConfig``): ``tp`` must divide the
    heads, the MLP width and the vocabulary of each of its transformers
    (``check_tp_divides``)."""
    dp, tp, embed = cfg.dp, cfg.tp, cfg.embed_devices
    if tp < 1 or dp < 1:
        raise ValueError(f"--dp {dp} --tp {tp}: both must be 1 or more")
    if model is not None:
        check_tp_divides(tp, model)
    n = dp * tp
    if embed < 0:
        raise ValueError(f"--embed-devices {embed} must be 0 or more")
    if layout is None:
        layout = dist_lib.HostLayout.one_host(0, n, n_cards, "this host")
    hosts = layout.n_hosts
    t = max(n // hosts, 1)           # the trainers of a host
    if embed % hosts:
        raise ValueError(
            f"--embed-devices {embed} does not divide over the {hosts} "
            f"hosts: each host's {t} trainer ranks embed on cards of their "
            f"own host, so every host needs embed-devices / {hosts} of them")
    e = embed // hosts
    where = "" if hosts == 1 else (
        f" ({e} a host: {hosts} hosts x {t} trainer ranks)")
    if e and e % t and t % e:
        raise ValueError(
            f"--embed-devices {embed} does not divide over the {t} trainer "
            f"ranks{where or f' (dp {dp} x tp {tp})'}: the embedder cards "
            f"must be a multiple of the ranks (each rank takes embed-devices"
            f" / (dp*tp) cards) or divide them (dp*tp / embed-devices ranks "
            f"share a card)")
    short = [(name, c) for name, c in zip(layout.names, layout.cards)
             if e and c is not None and t + e > c]
    if short and hosts == 1:
        trainers = "dp" if tp == 1 else "dp * tp"
        raise ValueError(
            f"--dp {dp} --tp {tp} --embed-devices {embed} needs {trainers} "
            f"+ embed-devices = {n + embed} visible cards (trainers on cards "
            f"0..{n - 1}, embedders after them), {short[0][1]} visible")
    if short:
        raise ValueError(
            f"--dp {dp} --tp {tp} --embed-devices {embed} over {hosts} hosts "
            f"needs {t} trainer + {e} embedder = {t + e} visible cards on "
            f"each host (trainers on cards 0..{t - 1}, embedders after "
            f"them): " + "; ".join(f"{name} sees {c}" for name, c in short))
    if n != world_size:
        raise ValueError(f"--dp {dp} --tp {tp} needs {n} processes, one a "
                         f"rank; this launch has {world_size}")


def tp_groups_span_hosts(cfg: MeshConfig, layout) -> bool:
    """True when the tp ranks of some replica (world ranks ``dp_idx * tp
    .. dp_idx * tp + tp - 1``) run on more than one host of ``layout``:
    allowed (the JAX mesh allows it), but their per-layer all-reduces then
    cross the network between hosts."""
    return any(len({layout.rank_hosts[d * cfg.tp + t]
                    for t in range(cfg.tp)}) > 1 for d in range(cfg.dp))


def _transformers(model):
    """(name, TransformerConfig) of each transformer in ``model``."""
    if hasattr(model, "retriever"):                    # EMDR2Config
        return [("the towers", model.retriever.encoder),
                ("the reader", model.reader.transformer)]
    if hasattr(model, "encoder"):                      # RetrieverConfig
        return [("the towers", model.encoder)]
    return [("the transformer", model)]


def check_tp_divides(tp: int, model,
                     fields: Sequence[str] = ("num_heads", "ffn_size",
                                              "vocab_size")) -> None:
    """Raise, naming the size, unless ``tp`` divides ``num_heads``,
    ``ffn_size`` and ``vocab_size`` (``fields``) of every transformer of
    ``model``: a layout that does not divide is refused, never run at
    tp = 1 or padded."""
    if tp == 1:
        return
    for name, t in _transformers(model):
        for field in fields:
            size = getattr(t, field)
            if size % tp:
                raise ValueError(
                    f"--tp {tp} does not divide {field} {size} of {name}: "
                    f"tensor parallelism splits the heads, the MLP width "
                    f"and the vocabulary over the tp ranks")


def embed_devices(cfg: MeshConfig, rank: int, device: torch.device,
                  layout=None) -> List[torch.device]:
    """Rank ``rank``'s embedder devices beside its trainer ``device``, on
    its own host of ``layout`` (a ``distributed.HostLayout``; default one
    host, where the local rank is ``rank``). With ``t`` trainers and ``e =
    embed_devices / n_hosts`` embedder cards a host and ``l`` the rank's
    local rank (its trainer card): cards ``t + l * e/t ...`` of its own
    when e >= t, else card ``t + l // (t/e)``, shared; the trainer's own
    card without an embedder group; on the CPU as many CPU devices (the
    layout's code runs unchanged there). On one host this is the JAX
    ``build_meshes``' embedder sub-mesh after the train mesh."""
    n, embed = cfg.dp * cfg.tp, cfg.embed_devices
    if embed == 0:
        return [device]
    if layout is None:
        layout = dist_lib.HostLayout.one_host(rank, n)
    t, local = layout.local_world_size, layout.local_rank
    e = embed // layout.n_hosts
    if e >= t:
        per = e // t
        idx = [t + local * per + i for i in range(per)]
    else:
        idx = [t + local // (t // e)]
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


class Group:
    """Ranks of one process group (``group``; None: the default group)
    and their collectives: ``rank`` of ``world_size``, ``ranks`` the world
    ranks of its members by group rank, ``backend`` None for one process
    (every collective then returns its input without a call). Counts the
    bytes each collective sends from this rank (``bytes_moved``, by the
    name of the collective)."""

    def __init__(self, rank: int, world_size: int,
                 backend: Optional[str] = None, group=None,
                 ranks: Optional[Sequence[int]] = None):
        self.rank = rank
        self.world_size = world_size
        self.backend = backend
        self.group = group
        self.ranks = list(ranks) if ranks is not None else list(
            range(world_size))
        self.bytes_moved: Dict[str, int] = defaultdict(int)

    @classmethod
    def local(cls) -> "Group":
        """One process, one rank: every collective is the identity."""
        return cls(0, 1)

    def __deepcopy__(self, memo):
        return self            # a module's copy shares its process group

    @property
    def distributed(self) -> bool:
        """True when the collectives really run (a process group exists,
        even of one rank)."""
        return self.backend is not None

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(rank={self.rank}, world_size="
                f"{self.world_size}, backend={self.backend!r}, ranks="
                f"{self.ranks})")

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

    def _all_reduce_(self, t: torch.Tensor, op, name: str) -> torch.Tensor:
        if not self.distributed:
            return t
        self._count(name, t)
        dev = self._transport_device()
        if t.device != dev:
            moved = t.to(dev)
            dist.all_reduce(moved, op=op, group=self.group)
            t.copy_(moved)
        else:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        return self._all_reduce_(t, dist.ReduceOp.SUM, "all_reduce")

    def all_reduce_max_(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max of ``t`` over the ranks, in place."""
        return self._all_reduce_(t, dist.ReduceOp.MAX, "all_reduce_max")

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
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(t.device)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[W * n, ...]: every rank's rows ``t`` [n, ...], in rank order."""
        g = self.all_gather(t)
        return g.reshape(-1, *t.shape[1:])

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` of the group's rank ``src`` on every rank."""
        if not self.distributed:
            return obj
        return dist_lib.broadcast_object(obj, src=self.ranks[src],
                                         group=self.group)

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce of one element, so the order
        with the other collectives is the program's)."""
        if self.distributed:
            self.all_reduce_sum_(torch.zeros(1,
                                             device=self._transport_device()))

    # ---- the index's rows --------------------------------------------------

    def row_range(self, n_padded: int) -> Tuple[int, int]:
        return row_range(n_padded, self.rank, self.world_size)


class DataParallel(Group):
    """The data-parallel group of a ``[dp, tp]`` grid (module docstring):
    the ranks with this rank's tp index. ``tp`` is the rank's
    tensor-parallel ``Group``, ``world`` the ``Group`` of every rank (the
    dp group itself when tp = 1)."""

    def __init__(self, rank: int, world_size: int,
                 backend: Optional[str] = None, group=None,
                 ranks: Optional[Sequence[int]] = None,
                 tp: Optional[Group] = None, world: Optional[Group] = None):
        super().__init__(rank, world_size, backend, group, ranks)
        self.tp = tp if tp is not None else Group.local()
        self.world = world if world is not None else self

    @classmethod
    def local(cls) -> "DataParallel":
        """One process, one rank: every collective is the identity."""
        return cls(0, 1)

    @classmethod
    def from_process_group(cls, tp: int = 1) -> "DataParallel":
        """The dp group of an initialized ``torch.distributed`` laid out
        as ``[world / tp, tp]``. Every rank makes every dp and tp group
        (``dist.new_group``, in the same order on all of them); with
        ``tp = 1`` the dp group is the default group and no group is
        made."""
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized "
                               "(parallel.distributed.init_process_group)")
        rank, world, backend = (dist.get_rank(), dist.get_world_size(),
                                dist.get_backend())
        if tp == 1:
            return cls(rank, world, backend)
        if world % tp:
            raise ValueError(f"--tp {tp} does not divide the {world} "
                             f"processes")
        dp = world // tp
        dp_idx, tp_idx = divmod(rank, tp)
        whole = Group(rank, world, backend)
        dp_groups = [[d * tp + t for d in range(dp)] for t in range(tp)]
        tp_groups = [[d * tp + t for t in range(tp)] for d in range(dp)]
        made = {}
        for ranks in dp_groups + tp_groups:
            made[tuple(ranks)] = dist.new_group(ranks)

        def group(ranks, idx):
            if len(ranks) == 1:
                return Group.local()
            return Group(idx, len(ranks), backend, made[tuple(ranks)], ranks)

        tp_group = group(tp_groups[dp_idx], tp_idx)
        mine = dp_groups[tp_idx]
        if len(mine) == 1:
            return cls(0, 1, tp=tp_group, world=whole)
        return cls(dp_idx, dp, backend, made[tuple(mine)], mine,
                   tp=tp_group, world=whole)

    @property
    def is_coordinator(self) -> bool:
        """World rank 0: the rank that writes checkpoints and prints."""
        return self.world.rank == 0

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
