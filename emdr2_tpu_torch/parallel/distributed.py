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

Hosts. The JAX package forms its mesh from one process a host, each owning
all of its host's devices (``jax.distributed.initialize`` reads the pod's
environment). Here a host runs several processes, one a card, and a rank's
card is its index among its host's ranks (``HostLayout.local_rank``), never
its world rank. ``init_distributed`` learns the layout before the process
group exists, since the NCCL group needs the rank's card first:
``host_layout`` answers from torchrun's ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``
and ``GROUP_RANK`` when all are set, else from the host names the ranks
exchange over the rendezvous store; either way the ranks exchange what they
see, so every rank refuses a layout that does not hold (hosts running
unequal numbers of ranks, a ``LOCAL_WORLD_SIZE`` that disagrees with the
ranks that reported its host, a host with fewer cards than ranks) with the
same message, and none waits for the others in a collective. On one
machine with no torchrun environment the layout is one host, and rank r
takes ``cuda:r``.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


# torchrun's variables that place a rank on its host
TORCHRUN_HOST_VARS = ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK")


@dataclasses.dataclass(frozen=True)
class HostLayout:
    """Where a rank runs among the hosts of a launch: its ``host`` (0 ..
    ``n_hosts - 1``, the hosts numbered in the order of their first world
    rank), its ``local_rank`` among that host's ranks (its card) and the
    ``local_world_size`` every host runs. ``rank_hosts`` is the host of each
    world rank, ``names`` each host's name (for messages), ``cards`` the
    cards each host sees (None where no card was asked for)."""

    host: int
    local_rank: int
    local_world_size: int
    n_hosts: int
    rank_hosts: Tuple[int, ...]
    names: Tuple[str, ...]
    cards: Tuple[Optional[int], ...]

    @classmethod
    def one_host(cls, rank: int = 0, world_size: int = 1,
                 cards: Optional[int] = None,
                 name: Optional[str] = None) -> "HostLayout":
        """Every rank on one host: rank r is local rank r."""
        return cls(0, rank, world_size, 1, (0,) * world_size,
                   (name or socket.gethostname(),), (cards,))

    @property
    def name(self) -> str:
        """This rank's host's name."""
        return self.names[self.host]


def _report(env: Mapping[str, str], hostname: str,
            cards: Optional[int]) -> Dict[str, Any]:
    """What a rank tells the others about its host: the host's key
    (torchrun's ``GROUP_RANK`` when its three host variables are set, else
    the host name), its name, its local rank and local world size from the
    environment (or None), and the cards it sees."""
    if all(v in env for v in TORCHRUN_HOST_VARS):
        return {"key": f"group {int(env['GROUP_RANK'])}",
                "name": f"{hostname} (GROUP_RANK {int(env['GROUP_RANK'])})",
                "local_rank": int(env["LOCAL_RANK"]),
                "local_world_size": int(env["LOCAL_WORLD_SIZE"]),
                "cards": cards}
    return {"key": hostname, "name": hostname, "local_rank": None,
            "local_world_size": None, "cards": cards}


def layout_from_reports(reports: Sequence[Mapping[str, Any]],
                        rank: int) -> HostLayout:
    """The ``HostLayout`` of world rank ``rank`` from every rank's report
    (``_report``, by world rank). Raises, naming the hosts, unless every
    host runs the same number of ranks, every ``LOCAL_WORLD_SIZE`` equals
    the ranks that reported its host, and a host's local ranks are 0 ..
    n - 1 once each. Every rank gets the same reports, so every rank
    raises alike."""
    keys: List[str] = []
    for rep in reports:
        if rep["key"] not in keys:
            keys.append(rep["key"])          # in order of their first rank
    rank_hosts = tuple(keys.index(rep["key"]) for rep in reports)
    ranks = [[r for r, h in enumerate(rank_hosts) if h == i]
             for i in range(len(keys))]
    names = tuple(reports[rs[0]]["name"] for rs in ranks)

    def listed(i):
        return f"{names[i]} runs {len(ranks[i])} (ranks {ranks[i]})"

    if len({len(rs) for rs in ranks}) > 1:
        raise ValueError(
            "every host must run the same number of ranks: "
            + "; ".join(listed(i) for i in range(len(keys))))
    for i, rs in enumerate(ranks):
        said = {reports[r]["local_world_size"] for r in rs} - {None}
        if said and said != {len(rs)}:
            raise ValueError(
                f"LOCAL_WORLD_SIZE {sorted(said)} on {names[i]}, but "
                f"{len(rs)} ranks reported that host ({rs})")
        local = [reports[r]["local_rank"] for r in rs]
        if None not in local and sorted(local) != list(range(len(rs))):
            raise ValueError(
                f"LOCAL_RANK {local} of ranks {rs} on {names[i]}: each of "
                f"0..{len(rs) - 1} once")
    host = rank_hosts[rank]
    local_rank = reports[rank]["local_rank"]
    if local_rank is None:
        local_rank = ranks[host].index(rank)
    cards = tuple(reports[rs[0]]["cards"] for rs in ranks)
    return HostLayout(host, local_rank, len(ranks[0]), len(keys),
                      rank_hosts, names, cards)


def host_layout(store=None, rank: Optional[int] = None,
                world_size: Optional[int] = None,
                cards: Optional[int] = None,
                env: Optional[Mapping[str, str]] = None,
                hostname: Optional[str] = None) -> HostLayout:
    """This rank's ``HostLayout``: ``(host, local_rank, local_world_size,
    n_hosts)`` and the host of every rank. With a rendezvous ``store``
    (``torch.distributed.Store``) every rank posts its report (its host's
    key: torchrun's ``GROUP_RANK`` when ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``
    and ``GROUP_RANK`` are all set in ``env``, else ``socket.gethostname()``;
    the cards it sees, ``cards``) and reads all of them
    (``layout_from_reports``). Without one, the layout follows from
    torchrun's variables alone (ranks numbered host by host, as torchrun
    numbers them), or is one host. ``rank`` and ``world_size`` default to
    ``RANK`` and ``WORLD_SIZE`` of ``env`` (default ``os.environ``), else 0
    and 1."""
    env = os.environ if env is None else env
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    report = _report(env, hostname or socket.gethostname(), cards)
    if store is not None and world_size > 1:
        prefix = f"emdr2/hosts/{env.get('TORCHELASTIC_RESTART_COUNT', 0)}/"
        store.set(prefix + str(rank), json.dumps(report))
        reports = [json.loads(store.get(prefix + str(r)))
                   for r in range(world_size)]
        return layout_from_reports(reports, rank)
    if report["local_rank"] is None:
        return HostLayout.one_host(rank, world_size, cards, report["name"])
    lws = report["local_world_size"]
    if world_size % lws:
        raise ValueError(f"WORLD_SIZE {world_size} is not a multiple of "
                         f"LOCAL_WORLD_SIZE {lws}")
    host = int(env["GROUP_RANK"])
    if rank != host * lws + report["local_rank"]:
        raise ValueError(f"RANK {rank} is not GROUP_RANK {host} x "
                         f"LOCAL_WORLD_SIZE {lws} + LOCAL_RANK "
                         f"{report['local_rank']}")
    n_hosts = world_size // lws
    return HostLayout(host, report["local_rank"], lws, n_hosts,
                      tuple(r // lws for r in range(world_size)),
                      tuple(f"GROUP_RANK {h}" for h in range(n_hosts)),
                      (cards,) * n_hosts)


def rank_device(device, layout: HostLayout) -> torch.device:
    """The device a rank runs on: ``cuda:<local_rank>`` for a card not
    named by index, else ``device`` as given. Raises, naming them, if a
    host runs more ranks than it sees cards (checked for every host, so
    every rank raises alike)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    short = [f"{layout.names[h]} sees {c}" for h, c in enumerate(
        layout.cards) if c is not None and c < layout.local_world_size]
    if short:
        raise ValueError(
            f"each host runs {layout.local_world_size} rank(s), one a card,"
            f" but " + "; ".join(short) + " visible card(s)")
    return torch.device("cuda", layout.local_rank)


def rendezvous_store(address: str, rank: int, world_size: int,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """The rendezvous store at ``address`` (``host:port``: a TCP store
    that rank 0 serves, or torchrun's agent's under torchelastic;
    ``file://``: a file store), which the host exchange and the process
    group share."""
    timeout = datetime.timedelta(seconds=timeout_s)
    store, _, _ = next(dist.rendezvous(_init_method(address), rank,
                                       world_size, timeout=timeout))
    store.set_timeout(timeout)
    return store


def init_process_group(address: Optional[str], world_size: int, rank: int,
                       backend: str, timeout_s: float = DEFAULT_TIMEOUT_S,
                       device=None, store=None) -> None:
    """Join the default process group: rendezvous at ``address``
    (``host:port``, ``tcp://...`` or ``file://...``), or through ``store``
    (``rendezvous_store``), with ``world_size`` ranks, this one ``rank``.
    Any world size, one included (a one-rank NCCL group runs the
    distributed path on one card). With NCCL the rank's ``device``
    (``cuda:i``) becomes the current device. Raises if NCCL is asked for
    and not built, or if the rendezvous fails or times out."""
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
    timeout = datetime.timedelta(seconds=timeout_s)
    if store is not None:
        dist.init_process_group(backend=backend, store=store,
                                world_size=world_size, rank=rank,
                                timeout=timeout)
    else:
        dist.init_process_group(
            backend=backend, init_method=_init_method(address),
            world_size=world_size, rank=rank, timeout=timeout)


def _launch_from_env(coordinator_address, num_processes, process_id, env):
    """The launch's address, size and this rank, from the arguments, else
    ``EMDR2_COORDINATOR`` / ``EMDR2_NUM_PROCESSES`` / ``EMDR2_PROCESS_ID``,
    else torchrun's ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK``."""
    if coordinator_address is None:
        coordinator_address = env.get("EMDR2_COORDINATOR")
    if (coordinator_address is None and "MASTER_ADDR" in env
            and "MASTER_PORT" in env):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    for name in ("EMDR2_NUM_PROCESSES", "WORLD_SIZE"):
        if num_processes is None and name in env:
            num_processes = int(env[name])
    for name in ("EMDR2_PROCESS_ID", "RANK"):
        if process_id is None and name in env:
            process_id = int(env[name])
    return coordinator_address, num_processes, process_id


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S
                     ) -> Optional[HostLayout]:
    """Join a launch of several processes. A no-op returning None unless
    one is asked for, through the arguments or the environment:
    ``EMDR2_COORDINATOR`` (``host:port``), ``EMDR2_NUM_PROCESSES`` and
    ``EMDR2_PROCESS_ID``, the JAX package's variables, or torchrun's
    ``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. The
    ranks meet at the rendezvous store, learn the host layout from it
    (``host_layout``), and a rank on a card takes ``rank_device(device,
    layout)`` (its local rank on its host) as its current device before
    the group is made over ``backend`` (default
    ``default_backend(device)``). Returns this rank's ``HostLayout`` once
    the group is up."""
    coordinator_address, num_processes, process_id = _launch_from_env(
        coordinator_address, num_processes, process_id, os.environ)
    if num_processes is None or num_processes <= 1:
        return None
    if coordinator_address is None or process_id is None:
        raise ValueError("a launch of several processes needs the "
                         "coordinator address and this process's id")
    dev = torch.device(device)
    store = rendezvous_store(coordinator_address, process_id, num_processes,
                             timeout_s)
    layout = host_layout(store, process_id, num_processes,
                         cards=(torch.cuda.device_count()
                                if dev.type == "cuda" else None))
    dev = rank_device(dev, layout)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_process_group(None, num_processes, process_id,
                       backend or default_backend(dev), timeout_s, dev,
                       store=store)
    return layout


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
