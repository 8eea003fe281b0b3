"""Task command line: ``python -m emdr2_tpu_torch.tasks.run --task
OPENQA|RETRIEVER`` (port of ``emdr2_tpu/tasks/run.py``).

The flags are the JAX CLI's, the surface ``examples/openqa/emdr2_nq.sh`` and
``examples/dense-retriever/dpr_nq.sh`` drive, mapped onto the dataclass
config. ``--device`` (default ``cuda``; ``cpu`` to run without a card)
takes the place of the JAX CLI's platform environment and ``--rng-impl``.

Data and tensor parallelism: one process per rank, launched by hand, N of

    python -m emdr2_tpu_torch.tasks.run ... --num-processes N \
        --process-id I --coordinator-address HOST:PORT [--dp D] \
        [--tp T] [--embed-devices E]

(or the ``EMDR2_COORDINATOR`` / ``EMDR2_NUM_PROCESSES`` /
``EMDR2_PROCESS_ID`` variables), or by ``torchrun`` (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and its ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``GROUP_RANK``), on one host or several. N = D x T:
rank I (``dp_idx * T + tp_idx``) takes the card of its local rank on its
host (``parallel.distributed.host_layout``: from torchrun's variables, or
from the host names the ranks exchange at the rendezvous; on one host
``cuda:I``) and NCCL, or gloo with ``--device cpu``; ``--dp`` defaults to N
/ T. Every host runs N / hosts ranks. Each of the D replicas splits its
heads, MLP width and vocabulary over its T ranks (a T that does not divide
them is refused; a tp group may span hosts, which the start says). The
global batch is ``--batch-size`` x D, as in the JAX CLI. ``--embed-devices
E`` puts the OPENQA refresher's embedders on each host's E / hosts cards
after its trainers' (``parallel.mesh.embed_devices``; E / hosts a multiple
or a divisor of the trainers a host, trainers + embedders of a host within
its visible cards): the reference's 8 trainers beside 8 indexers, on one
host of 16 cards or two of 8. Across hosts the checkpoint and data paths
must be on a filesystem every host sees: before the first collective the
ranks agree that each sees ``--evidence-data-path`` and
``--embedding-path``, and that all or none see a checkpoint at ``--load``,
and all raise, naming the hosts and paths, if not. The kernels' limits
(``ops.fid_attention.kernel_limits``) are checked on the flags before
anything is built.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("emdr2_tpu_torch", description=__doc__)
    p.add_argument("--task", choices=["OPENQA", "RETRIEVER"], required=True)
    p.add_argument("--device", default="cuda",
                   help="where to train and evaluate (default the card; "
                        "'cpu' to run without one)")

    g = p.add_argument_group("model")
    g.add_argument("--hidden-size", type=int, default=768)
    g.add_argument("--num-layers", type=int, default=12)
    g.add_argument("--num-attention-heads", type=int, default=12)
    g.add_argument("--ffn-hidden-size", type=int, default=3072)
    g.add_argument("--seq-length", type=int, default=512,
                   help="reader sequence length")
    g.add_argument("--seq-length-ret", type=int, default=256,
                   help="retriever context length")
    g.add_argument("--seq-length-query", type=int, default=64)
    g.add_argument("--seq-length-dec", type=int, default=32)
    g.add_argument("--remat", action="store_true",
                   help="activation checkpointing in the transformer stacks")
    g.add_argument("--remat-policy", choices=["nothing", "dots_no_batch"],
                   default="nothing",
                   help="what the per-layer checkpoint saves: 'nothing' = "
                        "full recompute (least memory); 'dots_no_batch' = "
                        "save the projection and MLP products, so the "
                        "backward recomputes only attention")
    g.add_argument("--no-remat-towers", action="store_true",
                   help="keep --remat on the reader but store the dual-"
                        "encoder towers' activations (no recompute)")
    g.add_argument("--fid-flash-attention", action="store_true",
                   help="the flash kernels for the encoders' self-attention "
                        "and the FiD decoder's cross-attention")
    g.add_argument("--flash-key-chunk", type=int, default=512)

    g = p.add_argument_group("emdr2")
    g.add_argument("--topk-retrievals", type=int, default=50)
    g.add_argument("--update-retriever", action="store_true", default=True)
    g.add_argument("--no-update-retriever", dest="update_retriever",
                   action="store_false")
    g.add_argument("--retriever-score-scaling", action="store_true",
                   default=True)
    g.add_argument("--ret-kldiv", action="store_true")
    g.add_argument("--allow-trivial-doc", action="store_true", default=True)
    g.add_argument("--async-indexer", action="store_true",
                   help="re-embed the evidence during training and swap "
                        "the index in every --index-reload-interval steps")
    g.add_argument("--index-reload-interval", type=int, default=500)
    g.add_argument("--index-quantize", choices=["none", "int8"],
                   default="none",
                   help="int8: store the MIPS index as int8 rows + per-128-"
                        "row fp32 scales")

    g = p.add_argument_group("training")
    g.add_argument("--batch-size", type=int, default=8,
                   help="questions per step")
    g.add_argument("--epochs", type=int, default=10)
    g.add_argument("--train-iters", type=int, default=None)
    g.add_argument("--lr", type=float, default=2e-5)
    g.add_argument("--min-lr", type=float, default=0.0)
    g.add_argument("--lr-decay-style", default="linear",
                   choices=["linear", "cosine", "exponential", "constant"])
    g.add_argument("--warmup", type=float, default=0.01)
    g.add_argument("--weight-decay", type=float, default=0.1)
    g.add_argument("--clip-grad", type=float, default=1.0)
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--log-interval", type=int, default=20)
    g.add_argument("--save-interval", type=int, default=500)
    g.add_argument("--eval-interval", type=int, default=500)
    g.add_argument("--exit-interval", type=int, default=None)
    g.add_argument("--sync-save", action="store_true",
                   help="block the loop on interval checkpoint saves "
                        "(default: stage to host, write in the background)")
    g.add_argument("--timeout-minutes", type=float, default=None,
                   help="checkpoint and exit cleanly after this wall-clock "
                        "budget")
    g.add_argument("--prefetch-depth", type=int, default=0,
                   help="batches built ahead by a worker thread (0 = off)")
    g.add_argument("--beam-size", type=int, default=1)
    g.add_argument("--sampling", action="store_true",
                   help="multinomial-sampling decode for EM eval instead of "
                        "greedy; only with beam-size 1")
    g.add_argument("--max-decode-len", type=int, default=32)
    g.add_argument("--decode-kv-int8", action="store_true",
                   help="store the cross-K/V slab int8 during EM eval "
                        "decode (the int8 decode-attention kernel)")
    g.add_argument("--eval-batch-size", type=int, default=None,
                   help="batch for the EM-eval decode (default: the train "
                        "batch)")
    g.add_argument("--eval-only", action="store_true",
                   help="skip training: OPENQA runs EM eval on --valid-data "
                        "from --load, RETRIEVER the recall evaluation")
    g.add_argument("--train-hard-neg", type=int, default=1,
                   help="RETRIEVER: hard negatives per question")
    g.add_argument("--val-av-rank-hard-neg", type=int, default=30,
                   help="RETRIEVER: hard negatives per query in the "
                        "average-rank validation")
    g.add_argument("--val-av-rank-other-neg", type=int, default=30)
    g.add_argument("--report-topk-accuracies", type=int, nargs="+",
                   default=[1, 5, 20, 100])
    g.add_argument("--match", default="string", choices=["string", "regex"],
                   help="answer-matching mode for recall evaluation")

    g = p.add_argument_group("data and tensor parallelism")
    g.add_argument("--dp", type=int, default=None,
                   help="data-parallel ranks (default: the process count "
                        "/ --tp)")
    g.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: each replica's heads, MLP "
                        "width and vocabulary split over --tp processes "
                        "(world = dp * tp, card = local rank on its host); "
                        "must divide the heads, the MLP width and the "
                        "vocabulary")
    g.add_argument("--embed-devices", type=int, default=0,
                   help="cards after the trainers' on each host that "
                        "re-embed the evidence for --async-indexer (0: each "
                        "rank's own card), E / hosts a host; a multiple of "
                        "the trainers a host or a divisor of them")
    g.add_argument("--coordinator-address", default=None,
                   help="host:port of the rendezvous (rank 0's)")
    g.add_argument("--num-processes", type=int, default=None,
                   help="the number of processes, one a rank")
    g.add_argument("--process-id", type=int, default=None,
                   help="this process's rank")

    g = p.add_argument_group("data")
    g.add_argument("--vocab-file", required=True)
    g.add_argument("--train-data", nargs="+", default=None)
    g.add_argument("--valid-data", nargs="+", default=None)
    g.add_argument("--evidence-data-path", default=None,
                   help="prefix of the pre-tokenized evidence (expects "
                        "<prefix>_text/_title mmap datasets)")
    g.add_argument("--embedding-path", default=None,
                   help="EmbeddingStore prefix for precomputed evidence "
                        "embeddings (or reference .pkl to ingest)")
    g.add_argument("--save", default=None, help="checkpoint dir")
    g.add_argument("--load", default=None, help="resume checkpoint dir")
    g.add_argument("--qa-file-dev", default=None,
                   help="QA csv for post-train retrieval recall (RETRIEVER)")
    g.add_argument("--qa-file-test", default=None)
    g.add_argument("--pretrained-dpr-load", default=None,
                   help="init the retriever from a checkpoint's retriever "
                        "at iteration 0")
    g.add_argument("--pretrained-t5-load", default=None,
                   help="init the reader from a checkpoint's reader at "
                        "iteration 0")
    return p


def check_kernel_limits(args) -> None:
    """Refuse flags the attention kernels cannot run, before anything is
    built (no fallback to the plain versions on the card)."""
    import torch

    from emdr2_tpu_torch.ops import fid_attention as fa

    if torch.device(args.device).type != "cuda":
        return
    head_dim = args.hidden_size // args.num_attention_heads
    for what, decoder_len in (("the towers", None),
                              ("the reader", args.seq_length_dec)):
        fa.check_kernel_limits(f"--fid-flash-attention, {what}",
                               torch.bfloat16, head_dim, decoder_len,
                               args.fid_flash_attention)


def setup_data_parallel(args):
    """Join the launch (``parallel.init_distributed``, with the device's
    backend: the ranks learn their hosts at the rendezvous) and check the
    ``[dp, tp]`` layout on every host -> the ``DataParallel`` group,
    carrying the tp and world groups (``DataParallel.local()`` for one
    process). ``--dp`` defaults to the processes / ``--tp``; the heads
    and the MLP width must divide by ``--tp`` here, the vocabulary when the
    model is built (its size comes from the tokenizer). Sets
    ``args.device`` to this rank's device (``parallel.rank_device``: the
    card of its local rank on its host), ``args.host_layout`` to its
    ``HostLayout`` and ``args.embedder_devices`` to its embedder's
    (``parallel.embed_devices``: its host's cards after that host's
    trainers', or the rank's own without ``--embed-devices``)."""
    import torch

    from emdr2_tpu_torch.config import MeshConfig
    from emdr2_tpu_torch.parallel import (DataParallel, HostLayout,
                                          check_mesh_config,
                                          check_tp_divides, embed_devices,
                                          init_distributed, rank_device,
                                          tp_groups_span_hosts)
    from emdr2_tpu_torch.utils.device import resolve_device
    dev = resolve_device(args.device)
    check_tp_divides(args.tp, make_config(args),
                     fields=("num_heads", "ffn_size"))
    layout = init_distributed(args.coordinator_address, args.num_processes,
                              args.process_id, device=dev)
    joined = layout is not None
    world = torch.distributed.get_world_size() if joined else 1
    rank = torch.distributed.get_rank() if joined else 0
    cards = torch.cuda.device_count() if dev.type == "cuda" else None
    if not joined:
        layout = HostLayout.one_host(cards=cards)
    dev = rank_device(dev, layout)
    if dev.type == "cuda":
        args.device = str(dev)
    if args.dp is None:
        args.dp = max(world // args.tp, 1)
    mesh = MeshConfig(dp=args.dp, tp=args.tp,
                      embed_devices=args.embed_devices)
    check_mesh_config(mesh, world, layout=layout)
    dp = (DataParallel.from_process_group(tp=args.tp) if joined
          else DataParallel.local())
    if joined and rank == 0:
        span = tp_groups_span_hosts(mesh, layout) if args.tp > 1 else False
        print(f"launch: {world} ranks on {layout.n_hosts} host(s) x "
              f"{layout.local_world_size} (" + ", ".join(layout.names)
              + f"); tp groups span hosts: {'yes' if span else 'no'}",
              flush=True)
    args.host_layout = layout
    args.embedder_devices = embed_devices(mesh, rank, dev, layout)
    return dp


def shared_inputs(args):
    """(flag, path, seen here) of each input every rank reads from the
    filesystem: the evidence (``--evidence-data-path``: its ``_text`` and
    ``_title`` datasets), OPENQA's ``--embedding-path`` (an
    ``EmbeddingStore`` or the reference's ``.pkl``) and a checkpoint at
    ``--load`` (its tracker)."""
    import os

    from emdr2_tpu_torch.data.indexed_dataset import exists
    from emdr2_tpu_torch.retrieval import EmbeddingStore
    from emdr2_tpu_torch.training.checkpointing import latest_iteration
    out = []
    if args.evidence_data_path:
        p = args.evidence_data_path
        out.append(("--evidence-data-path", p,
                    exists(p + "_text") and exists(p + "_title")))
    if args.task == "OPENQA" and args.embedding_path:
        p = args.embedding_path
        out.append(("--embedding-path", p, os.path.exists(p)
                    if p.endswith(".pkl") else EmbeddingStore.exists(p)))
    if args.load:
        out.append(("--load", args.load,
                    latest_iteration(args.load) is not None))
    return out


def check_shared_inputs(args, dp) -> None:
    """Before the first collective of a task: every rank of ``dp.world``
    checks which of its ``shared_inputs`` it sees, and the ranks agree by
    one all-reduce of the flags. Every rank raises alike, naming each
    host that misses a path, unless every rank sees the evidence and the
    embeddings and all or none see a checkpoint at ``--load`` (none: a
    fresh start). Without the check a rank on a host without the shared
    filesystem would raise alone, and the others would fail at their next
    collective without naming the path (over NCCL only after the
    rendezvous timeout)."""
    import torch

    world = dp.world
    inputs = shared_inputs(args)
    if not world.distributed or not inputs:
        return
    seen = torch.tensor([float(ok) for _, _, ok in inputs])
    world.all_reduce_sum_(seen)
    n = world.world_size
    bad = [i for i, (flag, _, _) in enumerate(inputs)
           if not (seen[i] == n or (flag == "--load" and seen[i] == 0))]
    if not bad:
        return
    mine = (args.host_layout.name, world.rank,
            [inputs[i][1:] for i in bad])
    everyone = [None] * n
    torch.distributed.all_gather_object(everyone, mine)
    lines = []
    for j, i in enumerate(bad):
        missing = {}
        for name, rank, seen_here in everyone:
            path, ok = seen_here[j]
            if not ok:
                missing.setdefault((name, path), []).append(rank)
        lines += [f"{inputs[i][0]} {path} is not visible on host {name} "
                  f"(ranks {ranks})" for (name, path), ranks in
                  missing.items()]
    raise FileNotFoundError(
        "; ".join(lines) + ": a launch across hosts reads the checkpoint "
        "and the data from a filesystem every host sees")


def make_config(args):
    from emdr2_tpu_torch import config as C

    enc = C.TransformerConfig(
        hidden_size=args.hidden_size, num_layers=args.num_layers,
        num_heads=args.num_attention_heads, ffn_size=args.ffn_hidden_size,
        num_tokentypes=2,
        remat=args.remat and not args.no_remat_towers,
        remat_policy=args.remat_policy,
        fid_flash_attention=args.fid_flash_attention,
        flash_key_chunk=args.flash_key_chunk)
    t5c = dataclasses.replace(enc, num_tokentypes=0, remat=args.remat)
    return C.EMDR2Config(
        retriever=C.RetrieverConfig(
            encoder=enc, embed_dim=args.hidden_size,
            seq_len=args.seq_length_ret, query_seq_len=args.seq_length_query),
        reader=C.ReaderConfig(
            transformer=t5c, seq_len=args.seq_length,
            decoder_seq_len=args.seq_length_dec),
        index=C.IndexConfig(
            embed_dim=args.hidden_size, topk=args.topk_retrievals,
            allow_trivial_doc=args.allow_trivial_doc,
            quantize=args.index_quantize),
        train=C.TrainConfig(
            batch_size=args.batch_size * (args.dp or 1),
            train_iters=args.train_iters,
            epochs=args.epochs, seed=args.seed,
            log_interval=args.log_interval, save_interval=args.save_interval,
            eval_interval=args.eval_interval, exit_interval=args.exit_interval,
            index_reload_interval=args.index_reload_interval,
            async_save=not args.sync_save,
            optimizer=C.OptimizerConfig(
                lr=args.lr, min_lr=args.min_lr,
                weight_decay=args.weight_decay, clip_grad=args.clip_grad,
                lr_decay_style=args.lr_decay_style, warmup=args.warmup)),
        update_retriever=args.update_retriever,
        retriever_score_scaling=args.retriever_score_scaling,
        use_kl_div_loss=args.ret_kldiv,
    )


def main(argv=None) -> int:
    from emdr2_tpu_torch.parallel import distributed
    args = build_parser().parse_args(argv)
    check_kernel_limits(args)
    dp = setup_data_parallel(args)
    try:
        check_shared_inputs(args, dp)
        if args.task == "RETRIEVER":
            from emdr2_tpu_torch.tasks.retriever_main import run_retriever
            return run_retriever(args, make_config(args), dp=dp)
        from emdr2_tpu_torch.tasks.openqa_main import run_openqa
        return run_openqa(args, make_config(args), dp=dp)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
