"""The rank processes of tests/test_torch_multihost.py: they import torch and
the port, never jax.

    python tests/test_torch_multihost_workers.py SPEC

Each rank is one process of an emulated host: the parent sets torchrun's
variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``), and the rank joins
through ``parallel.init_distributed``, as a rank of a launch across hosts
does: the ranks exchange their hosts over the rendezvous store and make one
gloo group on the CPU. ``SPEC`` (a ``torch.save``d dict) names the
tensor-parallel size ``tp`` (the grid ``[world / tp, tp]``), the output
directory, the cases to run in order and their inputs; each case's
results go into ``<out>/rank<RANK>.pt`` as {case: results}.
"""

import os
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from emdr2_tpu_torch.parallel import DataParallel  # noqa: E402
from emdr2_tpu_torch.parallel import distributed as dist_lib  # noqa: E402
from tests.test_torch_parallel_workers import _Recorder, _world  # noqa: E402
from tests.test_torch_parallel_workers import (  # noqa: E402
    case_prefetch as _dp_case_prefetch,
)
from tests.test_torch_tensor_parallel_workers import (_steps,  # noqa: E402
                                                      _task, _whole)

TIMEOUT_S = 120.0


def case_layout(spec, dp, layout):
    """The rank's ``HostLayout``, its card and, for an embedder group of
    one card a rank (``--embed-devices`` = the world), its embedder
    card's index on its host; whether a tp group spans hosts."""
    from emdr2_tpu_torch.config import MeshConfig
    from emdr2_tpu_torch.parallel import (check_mesh_config, embed_devices,
                                          rank_device, tp_groups_span_hosts)
    world = dp.world.world_size
    tp = spec["tp"]
    mesh = MeshConfig(dp=world // tp, tp=tp, embed_devices=world)
    check_mesh_config(mesh, world, layout=layout)
    card = rank_device("cuda", layout)
    return {"host": layout.host, "local_rank": layout.local_rank,
            "local_world_size": layout.local_world_size,
            "n_hosts": layout.n_hosts, "rank_hosts": layout.rank_hosts,
            "card": card.index,
            "embedder": [d.index for d in embed_devices(
                mesh, dp.world.rank, card, layout)],
            "tp_spans_hosts": tp_groups_span_hosts(mesh, layout)}


def case_openqa(spec, dp, layout):
    """``evaluate_em`` greedy and sampling (this rank's seed 5 + world
    rank: rank 0's wins), with the generated texts; then two train steps
    at dropout 0 and the whole parameters after them."""
    from emdr2_tpu_torch.tasks import e2eqa
    B = spec["batch"]
    task, ds = _task(spec, dp)
    out = {}
    for name, kw in (("greedy", {}),
                     ("sample", {"sample": True,
                                 "sample_seed": 5 + dp.world.rank})):
        rec = _Recorder(e2eqa.metric_max_over_ground_truths)
        e2eqa.metric_max_over_ground_truths = rec
        try:
            em = task.evaluate_em(ds, batch_size=B, max_decode_len=4, **kw)
        finally:
            e2eqa.metric_max_over_ground_truths = rec.fn
        out[f"em_{name}"] = (em, rec.texts)
    out["steps"] = _steps(task, ds, dp, seed=0)
    out["params"] = _whole(task, dp)
    return out


def case_refresh(spec, dp, layout):
    """The asynchronous refresh with the host-local embedder group
    (``--embed-devices`` = the world: one embedder device a rank, on its
    own host; CPU devices stand for the cards): the synchronous
    refresher's rows first; then the zero-copy refresher with every
    embedder but rank 0's held back, so at the first boundary rank 0
    alone is ready (no rank may swap), and all are at the second; then
    the host path (``zero_copy=False``) on the same weights. Returns each
    path's block of rows, the swap decisions and the search after each
    swap."""
    from emdr2_tpu_torch.config import MeshConfig
    from emdr2_tpu_torch.parallel import check_mesh_config, embed_devices
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.retrieval.builder import EvidenceIndexBuilder
    from emdr2_tpu_torch.training.async_refresh import (AsyncIndexRefresher,
                                                        SynchronousRefresher)
    cfg = spec["cfg"]
    world = dp.world.world_size
    mesh = MeshConfig(dp=world, embed_devices=world)
    check_mesh_config(mesh, world, layout=layout)
    devices = embed_devices(mesh, dp.world.rank, torch.device("cpu"),
                            layout)
    tok, corpus, ds = _world(spec)
    task, _ = _task(spec, dp)
    model = task.state.model
    builder = EvidenceIndexBuilder(cfg, model, corpus, tok.cls_id,
                                   tok.sep_id, tok.pad_id, batch_size=16,
                                   devices=devices)
    q = torch.as_tensor(spec["queries"])

    def index():
        return ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu",
                                    dp=dp)

    def searched(ix):
        per = q.shape[0] // world
        vals, ids = ix.search(q[dp.rank * per:(dp.rank + 1) * per],
                              k=cfg.index.topk)
        return vals, ids

    sync = index()
    assert SynchronousRefresher(builder, sync, 1).maybe_swap(1, model)
    zc = index()
    refresher = AsyncIndexRefresher(builder, zc, reload_interval=1,
                                    zero_copy=True)
    gate = threading.Event()
    if dp.rank == 0:
        gate.set()
    embed = builder.embed_corpus_device

    def gated(*args, **kw):
        assert gate.wait(TIMEOUT_S)
        return embed(*args, **kw)

    builder.embed_corpus_device = gated
    refresher.start(model)
    if dp.rank == 0:
        assert refresher.wait_for_result(timeout=TIMEOUT_S)
    dp.world.barrier()
    mixed = refresher.maybe_swap(1, model)
    gate.set()
    assert refresher.wait_for_result(timeout=TIMEOUT_S)
    swapped = refresher.maybe_swap(2, model)
    refresher.stop()
    builder.embed_corpus_device = embed
    host = index()
    host_refresher = AsyncIndexRefresher(builder, host, reload_interval=1,
                                         zero_copy=False)
    host_refresher.start(model)
    assert host_refresher.wait_for_result(timeout=TIMEOUT_S)
    host_swapped = host_refresher.maybe_swap(1, model)
    host_refresher.stop()
    return {"devices": [str(d) for d in devices],
            "zero_copy": (refresher.zero_copy, host_refresher.zero_copy),
            "row_range": zc.process_row_range(),
            "mixed": mixed, "swapped": swapped, "host_swapped": host_swapped,
            "sync_rows": sync.embeddings.clone(),
            "zc_rows": zc.embeddings.clone(),
            "host_rows": host.embeddings.clone(),
            "sync_search": searched(sync), "zc_search": searched(zc),
            "host_search": searched(host)}


def case_prefetch(spec, dp, layout):
    """The frozen-retriever run with and without the prefetcher
    (tests/test_torch_parallel_workers.py), at this launch's dp."""
    return _dp_case_prefetch(spec, dp)


CASES = {"layout": case_layout, "openqa": case_openqa,
         "refresh": case_refresh, "prefetch": case_prefetch}


def main() -> int:
    spec = torch.load(sys.argv[1], weights_only=False)
    torch.set_num_threads(spec.get("threads", 1))
    layout = dist_lib.init_distributed(device="cpu", timeout_s=TIMEOUT_S)
    dp = DataParallel.from_process_group(tp=spec["tp"])
    rank = dp.world.rank
    results = {}
    try:
        for name in spec["cases"]:
            t0 = time.perf_counter()
            results[name] = CASES[name](spec, dp, layout)
            results[name + "_seconds"] = time.perf_counter() - t0
    finally:
        torch.save(results, os.path.join(spec["out"], f"rank{rank}.pt"))
        dist_lib.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
