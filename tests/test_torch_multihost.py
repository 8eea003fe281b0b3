"""A launch across hosts in the port, against the JAX package: the port of
tests/test_multihost.py.

The JAX package forms one mesh from one process a host
(``jax.distributed.initialize``). The port runs a process a card, and a
rank learns its host at the rendezvous (``parallel.distributed.
host_layout``): its card is its local rank on its host, and its embedder
cards are its own host's (``parallel.mesh.embed_devices``). Here four gloo
processes on the CPU (tests/test_torch_multihost_workers.py, which imports
no jax) are two emulated hosts of two ranks each, placed by torchrun's
variables (``GROUP_RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), first as
``--dp 4``, then as ``--dp 2 --tp 2``. The JAX side is the JAX task on one
process's 4-device mesh (``build_mesh(MeshConfig(dp=4))``) of the
conftest's virtual CPU devices, computed once for both layouts.

Tolerances (those of tests/test_torch_parallel.py): OPENQA step metrics
rtol 2e-4, parameters atol 1e-5 at dropout 0; ``evaluate_em`` the
generated texts row for row and the EM exactly; sampling: rank 0's seed,
the one-process texts. The refresh: zero-copy and host rows against the
synchronous refresher's within fp16 storage rounding (1e-3), the search
values within 2e-2 (the JAX test's), the ids equal.
"""

import copy
import dataclasses
import os
import socket
import subprocess
import sys
import threading

import flax.linen as nn
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import (  # noqa: E402
    ShardedEvidenceIndex as JaxIndex,
)
from emdr2_tpu.tasks import E2EQATask as JaxTask  # noqa: E402
from emdr2_tpu.utils import metrics as jax_metrics  # noqa: E402
from emdr2_tpu_torch.config import MeshConfig  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.parallel import (HostLayout, check_mesh_config,  # noqa: E402
                                      embed_devices, host_layout,
                                      rank_device)
from emdr2_tpu_torch.parallel.distributed import (  # noqa: E402
    layout_from_reports,
)
from emdr2_tpu_torch.training.step import METRICS  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_eval import _noisy  # noqa: E402
from tests.test_torch_models import jax_flash_cfg  # noqa: E402
from tests.test_torch_models import unboxed_numpy  # noqa: E402
from tests.test_torch_parallel import _Recorder  # noqa: E402
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_multihost_workers.py")
HOSTS, PER_HOST = 2, 2
WORLD = HOSTS * PER_HOST
B = 4                         # global batch: 1 row a rank at dp 4
N_EXAMPLES = 8                # 2 evaluation batches
N_QUERIES = 8
WORKER_TIMEOUT_S = 240
LAYOUTS = {"dp4": 1, "dp2tp2": 2}            # name: tp
CASES = {"dp4": ["layout", "openqa", "refresh", "prefetch"],
         "dp2tp2": ["layout", "openqa"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_env(rank, port, hosts=HOSTS, per_host=PER_HOST):
    """torchrun's variables of world rank ``rank`` on emulated hosts of
    ``per_host`` ranks, host by host."""
    return {"RANK": str(rank), "WORLD_SIZE": str(hosts * per_host),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "LOCAL_RANK": str(rank % per_host),
            "LOCAL_WORLD_SIZE": str(per_host),
            "GROUP_RANK": str(rank // per_host)}


def _launch(spec, root):
    out = root / "out"
    out.mkdir()
    torch.save(dict(spec, out=str(out)), root / "spec.pt")
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                         "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK")}
    base["OMP_NUM_THREADS"] = "1"
    return out, [subprocess.Popen(
        [sys.executable, WORKER, str(root / "spec.pt")], cwd=REPO,
        env=dict(base, **host_env(r, port)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]


def _wait(procs, out, timeout):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _texts_by_row(rank_texts, replicas):
    """Each replica's texts (its rows of every batch; a replica's tp ranks
    hold the same) -> global row order."""
    per = B // replicas
    rows = []
    for i in range(-(-N_EXAMPLES // B)):
        for texts in rank_texts:
            rows += texts[i * per:(i + 1) * per]
    return rows


def _one_process_sampling(spec, tok, corpus, ds):
    """The port's sampling ``evaluate_em`` in one process at seed 5 ->
    (EM, texts)."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks import E2EQATask, e2eqa
    cfg = spec["cfg"]
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, spec["emb"],
                                          device="cpu"),
                     total_train_iters=4, device="cpu")
    task.init_state(0, state_dict=spec["params"])
    rec = _Recorder(e2eqa.metric_max_over_ground_truths)
    e2eqa.metric_max_over_ground_truths = rec
    try:
        em = task.evaluate_em(ds, batch_size=B, max_decode_len=4,
                              sample=True, sample_seed=5)
    finally:
        e2eqa.metric_max_over_ground_truths = rec.fn
    return em, rec.texts


def _jax_task(jcfg, tok, corpus, emb):
    """The JAX task on one process's dp=4 mesh, its weights made noisy
    (``_noisy``) -> (task, the noisy weights)."""
    mesh = build_mesh(JaxMeshConfig(dp=WORLD, tp=1))
    jtask = JaxTask(jcfg, mesh, tok, corpus, JaxIndex(mesh, jcfg.index, emb),
                    total_train_iters=4)
    jtask.init_state(jax.random.PRNGKey(0), B)
    boxed = jtask.state.params
    noisy = _noisy(nn.meta.unbox(boxed))
    jtask.state = jtask.state._replace(
        params=jax.tree_util.tree_map(
            lambda old, new: old.replace_boxed(new)
            if isinstance(old, nn.Partitioned) else new,
            boxed, noisy, is_leaf=lambda x: isinstance(x, nn.Partitioned)))
    return jtask, noisy


def _jax_references(jtask, ds):
    """``evaluate_em`` (greedy) with its texts, then two train steps and
    the parameters after them."""
    rec = _Recorder(jax_metrics.metric_max_over_ground_truths)
    jax_metrics.metric_max_over_ground_truths = rec
    try:
        em = jtask.evaluate_em(ds, batch_size=B, max_decode_len=4)
    finally:
        jax_metrics.metric_max_over_ground_truths = rec.fn
    steps = []
    for batch in list(ds.epoch_batches(B, seed=0))[:2]:
        m = jtask.train_step(batch)
        steps.append({k: float(m[k]) for k in METRICS})
    return {"em": (em, rec.texts), "steps": steps,
            "params": params_from_jax(unboxed_numpy(jtask.state.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references (computed once, while both launches run) and
    each layout's four ranks' results."""
    root = tmp_path_factory.mktemp("multihost")
    jcfg, tok, corpus, ds, _ = build_toy_world(root)
    jcfg = jax_flash_cfg(jcfg)
    ds = copy.copy(ds)
    ds.examples = ds.examples[:N_EXAMPLES]
    emb = np.random.RandomState(0).randn(
        len(corpus), jcfg.index.embed_dim).astype(np.float32)
    jtask, noisy = _jax_task(jcfg, tok, corpus, emb)
    cfg = port_config(jcfg)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B))
    words = [f"item{i}" for i in range(len(corpus))] + [
        "red", "blue", "green", "gold", "color", "of", "is", "what", "the"]
    spec = {"cfg": cfg, "params": params_from_jax(unboxed_numpy(noisy)),
            "emb": emb, "batch": B,
            "queries": np.random.RandomState(7).randn(
                N_QUERIES, cfg.index.embed_dim).astype(np.float32),
            "world": {"words": words, "text": str(root / "text"),
                      "title": str(root / "title"),
                      "qa": str(root / "qa.csv"), "n_examples": N_EXAMPLES}}
    launched = {}
    try:
        for name, tp in LAYOUTS.items():
            d = root / name
            d.mkdir()
            launched[name] = _launch(dict(spec, tp=tp, cases=CASES[name]), d)
        ref = _jax_references(jtask, ds)
        ref["sample"] = _one_process_sampling(spec, tok, corpus, ds)
    except BaseException:
        for _, procs in launched.values():
            for p in procs:
                p.kill()
        raise
    got = {name: _wait(procs, out, WORKER_TIMEOUT_S)
           for name, (out, procs) in launched.items()}
    return ref, got


# ------------------------------------------------------------ host layout

def test_host_layout_from_torchruns_environment():
    """torchrun's ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``GROUP_RANK``
    place the rank (ranks numbered host by host); without them and
    without a store, one host; a ``RANK`` that is not ``GROUP_RANK`` x
    ``LOCAL_WORLD_SIZE`` + ``LOCAL_RANK`` is refused."""
    for rank in range(WORLD):
        got = host_layout(env=host_env(rank, 1))
        assert (got.host, got.local_rank, got.local_world_size,
                got.n_hosts) == (rank // 2, rank % 2, 2, 2)
        assert got.rank_hosts == (0, 0, 1, 1)
        assert rank_device("cuda", got) == torch.device("cuda", rank % 2)
    one = host_layout(rank=3, world_size=4, env={})
    assert (one.host, one.local_rank, one.local_world_size,
            one.n_hosts) == (0, 3, 4, 1)
    bad = dict(host_env(1, 1), RANK="2")
    with pytest.raises(ValueError, match="RANK 2 is not GROUP_RANK 0"):
        host_layout(env=bad)
    assert rank_device("cpu", one) == torch.device("cpu")
    assert rank_device("cuda:5", one) == torch.device("cuda", 5)


def _exchange(names, env=None, cards=None):
    """``host_layout`` of every rank through one in-process store, a
    thread a rank reporting host name ``names[r]`` -> layouts (or the
    exception each raised), by rank."""
    store = torch.distributed.HashStore()
    out = [None] * len(names)

    def rank_main(r):
        try:
            out[r] = host_layout(store, r, len(names), cards=cards,
                                 env=(env or (lambda r: {}))(r),
                                 hostname=names[r])
        except ValueError as e:
            out[r] = e

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(len(names))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return out


def test_host_layout_from_the_store_exchange():
    """Without torchrun's variables the ranks exchange host names at the
    rendezvous: on one machine one host, rank r on ``cuda:r`` (the
    mapping of a one-host launch); on two, each host's ranks in world
    order, whatever order the hosts' ranks interleave in."""
    same = _exchange(["box"] * 4, cards=4)
    for r, got in enumerate(same):
        assert (got.host, got.local_rank, got.local_world_size,
                got.n_hosts) == (0, r, 4, 1)
        assert rank_device("cuda", got) == torch.device("cuda", r)
    two = _exchange(["a", "b", "a", "b"], cards=2)
    assert [(g.host, g.local_rank) for g in two] == [(0, 0), (1, 0), (0, 1),
                                                      (1, 1)]
    assert two[0].names == ("a", "b") and two[0].rank_hosts == (0, 1, 0, 1)


@pytest.mark.parametrize("hosts,per_host,embed,want", [
    (1, 8, 8, [[8 + r] for r in range(8)]),
    (2, 4, 8, [[4 + r % 4] for r in range(8)]),
    (2, 4, 4, [[4 + (r % 4) // 2] for r in range(8)]),
    (2, 2, 2, [[2] for _ in range(4)]),
])
def test_embedders_are_the_cards_after_their_own_hosts_trainers(
        hosts, per_host, embed, want):
    """Each host's trainers take its cards 0..t-1 and its embed / hosts
    embedder cards follow them: (1, 8, 8) is the one-host table of
    PR 12; two hosts of 8 cards take ``--dp 8 --embed-devices 8`` as 4 + 4
    a host; the multiple-or-divisor rule holds within a host."""
    world = hosts * per_host
    mesh = MeshConfig(dp=world, embed_devices=embed)
    got = []
    for r in range(world):
        layout = host_layout(env=host_env(r, 1, hosts, per_host))
        layout = dataclasses.replace(
            layout, cards=(per_host + embed // hosts,) * hosts)
        check_mesh_config(mesh, world, layout=layout)
        card = rank_device("cuda", layout)
        assert card.index == r % per_host
        got.append([d.index for d in embed_devices(mesh, r, card, layout)])
        assert all(per_host <= i < per_host + embed // hosts
                   for i in got[-1])
    assert got == want
    if hosts == 2 and per_host == 4 and embed == 8:
        # two hosts of 8 cards: the reference's 8 trainers + 8 indexers
        layout = dataclasses.replace(host_layout(env=host_env(0, 1, 2, 4)),
                                     cards=(8, 8))
        check_mesh_config(MeshConfig(dp=8, embed_devices=8), 8,
                          layout=layout)
        with pytest.raises(ValueError, match="needs dp \\+ embed-devices = "
                                             "16 visible cards.*8 visible"):
            check_mesh_config(MeshConfig(dp=8, embed_devices=8), 8,
                              n_cards=8)


def test_layouts_that_do_not_fit_the_hosts_are_refused():
    """Each refusal names its numbers: hosts running unequal numbers of
    ranks (every rank raises alike), embedder cards that do not divide
    over the hosts or over a host's trainers, a ``LOCAL_WORLD_SIZE`` that
    disagrees with the ranks that reported its host, too few cards."""
    unequal = _exchange(["a", "a", "b"])
    assert all(isinstance(e, ValueError) for e in unequal)
    assert "a runs 2 (ranks [0, 1]); b runs 1 (ranks [2])" in str(unequal[0])
    assert len({str(e) for e in unequal}) == 1
    lying = _exchange(["a"] * 4, env=lambda r: dict(
        host_env(r, 1, 2, 2), GROUP_RANK="0"))
    assert "LOCAL_WORLD_SIZE [2] on a (GROUP_RANK 0), but 4 ranks" in str(
        lying[0])
    two = dataclasses.replace(host_layout(env=host_env(0, 1, 2, 2)),
                              cards=(8, 8))
    with pytest.raises(ValueError, match="--embed-devices 3 does not divide "
                                         "over the 2 hosts"):
        check_mesh_config(MeshConfig(dp=4, embed_devices=3), 4, layout=two)
    with pytest.raises(ValueError, match="--embed-devices 6 does not divide "
                                         "over the 2 trainer ranks \\(3 a "
                                         "host: 2 hosts x 2"):
        check_mesh_config(MeshConfig(dp=4, embed_devices=6), 4, layout=two)
    small = dataclasses.replace(two, cards=(8, 3))
    with pytest.raises(ValueError, match="needs 2 trainer \\+ 2 embedder = 4"
                                         " visible cards on each host.*"
                                         "GROUP_RANK 1 sees 3"):
        check_mesh_config(MeshConfig(dp=4, embed_devices=4), 4, layout=small)
    with pytest.raises(ValueError, match="each host runs 2 rank\\(s\\), one "
                                         "a card, but GROUP_RANK 1 sees 1"):
        rank_device("cuda", dataclasses.replace(two, cards=(2, 1)))
    reports = [{"key": "a", "name": "a", "local_rank": 0,
                "local_world_size": 2, "cards": 2}] * 2
    with pytest.raises(ValueError, match="LOCAL_RANK \\[0, 0\\]"):
        layout_from_reports(reports, 0)
    assert HostLayout.one_host(2, 4).rank_hosts == (0, 0, 0, 0)


# ----------------------------------------------------- the emulated hosts

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_join_by_host(runs, layout):
    """Every rank learned its host from torchrun's variables at the
    rendezvous: host r // 2, local rank r % 2 (its card), its embedder the
    card after its host's two trainers; neither layout's tp groups span
    hosts (world rank dp_idx * tp + tp_idx, two ranks a host)."""
    _, got = runs
    for r, res in enumerate(got[layout]):
        lay = res["layout"]
        assert (lay["host"], lay["local_rank"], lay["local_world_size"],
                lay["n_hosts"]) == (r // 2, r % 2, 2, 2)
        assert lay["rank_hosts"] == (0, 0, 1, 1)
        assert lay["card"] == r % 2 and lay["embedder"] == [2 + r % 2]
        assert lay["tp_spans_hosts"] is False


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_two_openqa_steps_match_jax_on_a_dp4_mesh(runs, layout):
    ref, got = runs
    for res in got[layout]:
        for i, (g, w) in enumerate(zip(res["openqa"]["steps"], ref["steps"])):
            for key in METRICS:
                np.testing.assert_allclose(g[key], w[key], rtol=2e-4,
                                           atol=1e-6,
                                           err_msg=f"{key} step {i}")
        params = res["openqa"]["params"]
        for key, p in ref["params"].items():
            np.testing.assert_allclose(params[key].numpy(), p.numpy(),
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_evaluate_em_matches_jax(runs, layout):
    """The generated texts row for row and the EM of the JAX mesh; a
    replica's tp ranks generate the same texts."""
    ref, got = runs
    want_em, want_texts = ref["em"]
    tp = LAYOUTS[layout]
    ranks = got[layout]
    assert all(res["openqa"]["em_greedy"][0] == want_em for res in ranks)
    assert want_em[1] == N_EXAMPLES
    for d in range(WORLD // tp):
        replica = [ranks[d * tp + t]["openqa"]["em_greedy"][1]
                   for t in range(tp)]
        assert all(texts == replica[0] for texts in replica)
    texts = _texts_by_row([ranks[d * tp]["openqa"]["em_greedy"][1]
                           for d in range(WORLD // tp)], WORLD // tp)
    assert texts == want_texts


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sampling_takes_rank_0s_seed(runs, layout):
    """Each rank passes its own seed (5 + world rank); rank 0's is used, so
    the tokens are those of one process at seed 5."""
    ref, got = runs
    want_em, want_texts = ref["sample"]
    tp = LAYOUTS[layout]
    ranks = got[layout]
    texts = _texts_by_row([ranks[d * tp]["openqa"]["em_sample"][1]
                           for d in range(WORLD // tp)], WORLD // tp)
    assert texts == want_texts
    assert all(res["openqa"]["em_sample"][0] == want_em for res in ranks)


def test_async_refresh_on_host_local_embedders(runs):
    """Each rank's embedder is its own host's (a CPU device stands for
    card 2 + local rank); with rank 0's block alone ready no rank swaps,
    with all ready all do; the zero-copy swap holds the synchronous
    refresher's rows (fp16 host rows there: 1e-3) and searches alike."""
    _, got = runs
    for res in got["dp4"]:
        f = res["refresh"]
        assert f["devices"] == ["cpu"] and f["zero_copy"] == (True, False)
        assert f["mixed"] is False and f["swapped"] is True
        np.testing.assert_allclose(f["zc_rows"].float().numpy(),
                                   f["sync_rows"].float().numpy(), atol=1e-3)
        assert torch.equal(f["zc_search"][1], f["sync_search"][1])
        np.testing.assert_allclose(f["zc_search"][0].numpy(),
                                   f["sync_search"][0].numpy(), atol=2e-2)
    blocks = [res["refresh"]["row_range"] for res in got["dp4"]]
    assert [b[0] for b in blocks[1:]] == [b[1] for b in blocks[:-1]]


def test_zero_copy_swap_equals_the_host_path(runs):
    """The same weights through the host path (fp16 rows in host RAM,
    uploaded at the swap): the rows and the searches of the zero-copy
    swap, on every rank."""
    _, got = runs
    for res in got["dp4"]:
        f = res["refresh"]
        assert f["host_swapped"] is True
        np.testing.assert_allclose(f["host_rows"].float().numpy(),
                                   f["zc_rows"].float().numpy(), atol=1e-3)
        assert torch.equal(f["host_search"][1], f["zc_search"][1])
        np.testing.assert_allclose(f["host_search"][0].numpy(),
                                   f["zc_search"][0].numpy(), atol=2e-2)


def test_prefetch_across_hosts_equals_the_plain_run(runs):
    """With the query tower frozen, three iterations at dp 4 under the
    prefetcher of a data-parallel rank log what the plain run logs, bit
    for bit, on all four ranks alike."""
    _, got = runs
    for res in got["dp4"]:
        plain, prefetched = res["prefetch"][0], res["prefetch"][1]
        assert len(plain) == len(prefetched) == 3
        assert plain == prefetched
    assert all(res["prefetch"] == got["dp4"][0]["prefetch"]
               for res in got["dp4"])


def test_torchrun_agents_place_the_ranks_by_host(tmp_path):
    """Two ``torchrun`` agents (``torch.distributed.run --nnodes 2``, two
    ranks each), as a launch on two hosts starts them: the ranks meet at
    the agents' store and take the layout of the emulated hosts above."""
    out = tmp_path / "out"
    out.mkdir()
    torch.save({"tp": 1, "cases": ["layout"], "out": str(out)},
               tmp_path / "spec.pt")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    agents = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
         "--node-rank", str(node), "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(port), WORKER,
         str(tmp_path / "spec.pt")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for node in (0, 1)]
    logs = []
    try:
        for p in agents:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in agents:
            if p.poll() is None:
                p.kill()
                p.wait()
    for node, (p, log) in enumerate(zip(agents, logs)):
        assert p.returncode == 0, f"agent {node}:\n{log[-4000:]}"
    for r in range(WORLD):
        lay = torch.load(out / f"rank{r}.pt", weights_only=False)["layout"]
        assert (lay["host"], lay["local_rank"], lay["n_hosts"],
                lay["card"], lay["embedder"]) == (r // 2, r % 2, 2, r % 2,
                                                  [2 + r % 2])


# ------------------------------------------- a host without the shared files

@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """Vocabulary, evidence, embedding store and QA csv of a toy world."""
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    from emdr2_tpu_torch.tools.build_evidence import build
    from emdr2_tpu_torch.tools.create_doc_index import main as create_index
    d = tmp_path_factory.mktemp("multihost_cli")
    words = [f"item{i}" for i in range(8)] + ["red", "color", "of", "is",
                                              "what", "the"]
    (d / "vocab.txt").write_text("\n".join(toy_vocab(words)) + "\n")
    (d / "evidence.tsv").write_text("\n".join(
        ["id\ttext\ttitle"] + [f"{i + 1}\tthe color of item{i} is red\t"
                               f"item{i}" for i in range(8)]) + "\n")
    (d / "qa.csv").write_text("".join(
        f"what is the color of item{i}\t['red']\n" for i in range(8)))
    assert build(str(d / "evidence.tsv"), str(d / "wiki"),
                 str(d / "vocab.txt"), workers=1) == 8
    assert create_index(["--evidence-data-path", str(d / "wiki"),
                         "--vocab-file", str(d / "vocab.txt"),
                         "--embedding-path", str(d / "emb"),
                         "--batch-size", "8"] + CLI_MODEL) == 0
    return d


CLI_MODEL = ["--hidden-size", "32", "--num-layers", "1",
             "--num-attention-heads", "2", "--ffn-hidden-size", "64",
             "--seq-length-ret", "24", "--seq-length-query", "16",
             "--device", "cpu"]


def test_a_host_missing_a_shared_path_stops_every_rank(cli_data):
    """Two emulated hosts of one rank each run ``tasks.run``; host 1 is
    given an evidence path it cannot see (a host without the shared
    filesystem). Both ranks raise before the first collective of the
    task, naming host 1 and the path. Without the check rank 1 raises
    alone, and rank 0 fails at its first collective without the path
    (gloo: the peer closed its connection; NCCL would wait for the 300 s
    rendezvous timeout)."""
    d = cli_data
    port = _free_port()
    missing = str(d / "not_mounted" / "wiki")
    procs = []
    for r in range(2):
        args = ["--task", "OPENQA", "--vocab-file", str(d / "vocab.txt"),
                "--train-data", str(d / "qa.csv"),
                "--evidence-data-path", str(d / "wiki") if r == 0
                else missing,
                "--embedding-path", str(d / "emb"),
                "--batch-size", "1", "--train-iters", "1",
                "--topk-retrievals", "2", "--seq-length", "48",
                "--seq-length-dec", "8"] + CLI_MODEL
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   **host_env(r, port, hosts=2, per_host=1))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "emdr2_tpu_torch.tasks.run"] + args,
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode != 0, f"rank {r}:\n{log[-3000:]}"
        assert "FileNotFoundError" in log, log[-3000:]
        assert (f"--evidence-data-path {missing} is not visible on host "
                in log), log[-3000:]
        assert "(GROUP_RANK 1) (ranks [1])" in log, log[-3000:]
