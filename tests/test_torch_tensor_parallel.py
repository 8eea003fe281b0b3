"""Tensor parallelism of the port against the JAX package on ``(1, 2)`` and
``(2, 2)`` meshes.

Two layouts of gloo processes on the CPU (tests/test_torch_tensor_parallel_
workers.py, which imports no jax): ``--tp 2`` (2 ranks) and ``--dp 2 --tp
2`` (4 ranks, world rank ``dp_idx * 2 + tp_idx``). Each replica feeds its
contiguous slice of every global batch; its two tp ranks hold the halves
of its heads, MLP columns and vocabulary. The JAX side is the JAX task on
a ``(1, 2)`` / ``(2, 2)`` mesh of the conftest's virtual CPU devices, its
kernels shard_mapped over rows and heads, as tests/test_tp_sharding.py
runs them. Inputs come from seeded numpy; the JAX weights reach every rank
whole through ``convert.params_from_jax`` and each rank keeps its part.

Tolerances (those of the data-parallel tests): OPENQA step metrics rtol
2e-4 and the gathered parameters 1e-5 at dropout 0 (the JAX side's dropout
seeds come from flax rngs); at dropout 0.1 the whole parameters bit-equal
on the tp ranks and the replicas bit-equal across dp; the vocab-parallel
CE 1e-5 and its logits gradient 1e-6, the gold head 2e-5; the search's ids
equal and values 1e-6; ``evaluate_em`` the texts row for row; checkpoints
bit for bit across tp. The three dropout rules are held bit for bit
against the JAX masks in this process.
"""

import copy
import dataclasses
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import IndexConfig as JaxIndexConfig  # noqa: E402
from emdr2_tpu.config import MeshConfig  # noqa: E402
from emdr2_tpu.parallel import build_mesh  # noqa: E402
from emdr2_tpu.retrieval import (  # noqa: E402
    ShardedEvidenceIndex as JaxIndex,
)
from emdr2_tpu.tasks import E2EQATask as JaxTask  # noqa: E402
from emdr2_tpu.utils import metrics as jax_metrics  # noqa: E402
from emdr2_tpu_torch.config import IndexConfig  # noqa: E402
from emdr2_tpu_torch.convert import (gather_params, params_from_jax,  # noqa: E402
                                     shard_params)
from emdr2_tpu_torch.training.step import METRICS  # noqa: E402
from tests.helpers import build_toy_world  # noqa: E402
from tests.test_torch_eval import _noisy  # noqa: E402
from tests.test_torch_models import jax_flash_cfg  # noqa: E402
from tests.test_torch_models import unboxed_numpy  # noqa: E402
from tests.test_torch_parallel import (_Recorder, _dpr_inputs,  # noqa: E402
                                       _jax_dpr_task, _one_hot_value_slab,
                                       _one_process_refresh)
from tests.test_torch_serving import port_config  # noqa: E402

torch.set_num_threads(2)

TP = 2
B = 4                         # global batch: 2 rows a replica at dp 2
N_EXAMPLES = 8
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_torch_tensor_parallel_workers.py")
WORKER_TIMEOUT_S = 400
N_ROWS, NQ, K = 40_000, 4, 10  # the search: > chunk_rows a block
LAYOUTS = {"tp2": (1, 2), "dp2tp2": (2, 2)}
CASES = {"tp2": ["vocab", "openqa", "dpr_task", "refresh", "remat"],
         "dp2tp2": ["mips", "openqa"]}


def _launch(spec, root, world):
    out = root / "out"
    out.mkdir()
    spec = dict(spec, world_size=world, out=str(out),
                address=f"file://{root / 'store'}")
    torch.save(spec, root / "spec.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(root / "spec.pt"),
                              str(r)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=env)
            for r in range(world)]


def _wait(procs, out, timeout):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def _jax_task(jcfg, mesh, tok, corpus, emb, noisy):
    jtask = JaxTask(jcfg, mesh, tok, corpus, JaxIndex(mesh, jcfg.index, emb),
                    total_train_iters=4)
    jtask.init_state(jax.random.PRNGKey(0), B)
    boxed = jtask.state.params
    jtask.state = jtask.state._replace(
        params=jax.tree_util.tree_map(
            lambda old, new: old.replace_boxed(jnp.asarray(new))
            if isinstance(old, nn.Partitioned) else jnp.asarray(new),
            boxed, noisy, is_leaf=lambda x: isinstance(x, nn.Partitioned)))
    return jtask


def _jax_steps(jtask, ds):
    steps = []
    for batch in list(ds.epoch_batches(B, seed=0))[:2]:
        m = jtask.train_step(batch)
        steps.append({k: float(m[k]) for k in METRICS})
    return steps, params_from_jax(unboxed_numpy(jtask.state.params))


def _jax_vocab(mesh):
    """The JAX vocab-parallel CE and its logits gradient, and the
    teacher's gold head on a mesh-bound T5."""
    from emdr2_tpu.data import masks
    from emdr2_tpu.models.t5 import T5Model as JaxT5
    from emdr2_tpu.training.losses import vocab_parallel_cross_entropy
    from emdr2_tpu_torch.config import tiny_config
    rng = np.random.RandomState(11)
    Bv, L, V = 4, 4, 640
    logits = rng.randn(Bv, L, V).astype(np.float32)
    labels = rng.randint(0, V, (Bv, L)).astype(np.int32)
    mask = (rng.rand(Bv, L) > 0.3).astype(np.float32)

    def ce(lg):
        nll = vocab_parallel_cross_entropy(lg, jnp.asarray(labels), mesh)
        return jnp.sum(nll * mask) / jnp.sum(mask)

    loss, grad = jax.value_and_grad(ce)(jnp.asarray(logits))
    vocab = {"logits": logits, "labels": labels, "mask": mask,
             "loss": float(loss), "grad": np.asarray(grad)}

    import emdr2_tpu.config as jc
    t5c = dataclasses.replace(jc.tiny_config().reader.transformer,
                              fid_flash_attention=False, mesh=mesh)
    model = JaxT5(t5c)
    rows = 4
    enc = jnp.asarray(rng.randint(2, 500, (rows, 6)), jnp.int32)
    dec = jnp.asarray(rng.randint(1, 500, (rows, L)), jnp.int32)
    glabels = jnp.asarray(rng.randint(0, t5c.vocab_size, (rows, L)),
                          jnp.int32)
    params = model.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)}, enc, dec)
    hidden = model.apply(params, enc, method=JaxT5.encode)
    m = masks.attention_mask(dec, enc)
    gold = model.apply(params, dec, hidden, m, glabels,
                       method=JaxT5.decode_gold_log_probs)
    pcfg = dataclasses.replace(tiny_config().reader.transformer,
                               fid_flash_attention=False)
    gold_in = {"cfg": pcfg,
               "params": params_from_jax(unboxed_numpy(params["params"])),
               "dec": np.asarray(dec), "hidden": np.asarray(hidden),
               "mask": np.asarray(m), "labels": np.asarray(glabels),
               "want": np.asarray(gold)}
    return vocab, gold_in


def _one_process_checkpoint(spec, tok, corpus, ds, path):
    """A checkpoint written by one process (tp = 1) after one step: what
    the ranks restore at tp = 2; -> (params, exp_avg_sq by name)."""
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import checkpointing
    cfg = spec["cfg"]
    task = E2EQATask(cfg, tok, corpus,
                     ShardedEvidenceIndex(cfg.index, spec["emb"],
                                          device="cpu"),
                     total_train_iters=4, device="cpu")
    task.init_state(0, state_dict=spec["params"])
    task.train_step(next(ds.epoch_batches(B, seed=3)))
    checkpointing.save_checkpoint(path, task.state, 1)
    adam = task.state.optimizer.adamw.state_dict()["state"]
    names = checkpointing._moment_names(task.state)
    return ({k: v.clone() for k, v in task.state.model.state_dict().items()},
            {names[i]: adam[i]["exp_avg_sq"].clone() for i in adam})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references on the (1, 2) and (2, 2) meshes and each layout's
    ranks' results."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    jcfg, tok, corpus, ds, _ = build_toy_world(root)
    jcfg = jax_flash_cfg(jcfg)
    ds = copy.copy(ds)
    ds.examples = ds.examples[:N_EXAMPLES]
    emb = np.random.RandomState(0).randn(
        len(corpus), jcfg.index.embed_dim).astype(np.float32)
    meshes = {name: build_mesh(MeshConfig(dp=dp, tp=tp))
              for name, (dp, tp) in LAYOUTS.items()}
    probe = JaxTask(jcfg, meshes["tp2"], tok, corpus,
                    JaxIndex(meshes["tp2"], jcfg.index, emb),
                    total_train_iters=4)
    probe.init_state(jax.random.PRNGKey(0), B)
    noisy = jax.tree_util.tree_map(
        np.asarray, _noisy(nn.meta.unbox(probe.state.params)))
    del probe
    cfg = port_config(jcfg)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B))
    rs = np.random.RandomState(7)
    mips = {"queries": rs.randn(NQ, 64).astype(np.float32),
            "rows": rs.randn(N_ROWS, 64).astype(np.float32), "k": K,
            "index_cfg": IndexConfig(embed_dim=64, dtype=torch.float32)}
    words = [f"item{i}" for i in range(len(corpus))] + [
        "red", "blue", "green", "gold", "color", "of", "is", "what", "the"]
    vocab, gold = _jax_vocab(meshes["tp2"])
    dpr_task = _dpr_inputs(root)
    dpr_ref = _jax_dpr_task(dpr_task, meshes["tp2"])
    base = {"cfg": cfg, "params": params_from_jax(noisy), "emb": emb,
            "batch": B, "mips": mips, "tp": TP, "vocab": vocab,
            "gold": gold, "dpr_task": dpr_task,
            "world": {"words": words, "text": str(root / "text"),
                      "title": str(root / "title"),
                      "qa": str(root / "qa.csv"), "n_examples": N_EXAMPLES}}
    ckpt_in = str(root / "ckpt_tp1")
    one = _one_process_checkpoint(base, tok, corpus, ds, ckpt_in)
    procs, ref = {}, {"one_process_ckpt": one, "vocab": vocab, "gold": gold,
                      "dpr_task": dpr_ref}
    try:
        for name, (dp, tp) in LAYOUTS.items():
            lroot = root / name
            lroot.mkdir()
            spec = dict(base, cases=CASES[name],
                        ckpt={"in": ckpt_in, "out": str(lroot / "ckpt")})
            procs[name] = (_launch(spec, lroot, dp * tp), lroot)
        for name, mesh in meshes.items():
            jtask = _jax_task(jcfg, mesh, tok, corpus, emb, noisy)
            if name == "tp2":
                for mode, kw in (("greedy", {}), ("int8",
                                                  {"kv_quant": "int8"})):
                    rec = _Recorder(jax_metrics.metric_max_over_ground_truths)
                    jax_metrics.metric_max_over_ground_truths = rec
                    try:
                        em = jtask.evaluate_em(ds, batch_size=B,
                                               max_decode_len=4, **kw)
                    finally:
                        jax_metrics.metric_max_over_ground_truths = rec.fn
                    ref[f"em_{mode}"] = (em, rec.texts)
            else:
                for quant in ("none", "int8"):
                    icfg = JaxIndexConfig(embed_dim=64, dtype=jnp.float32,
                                          quantize=quant)
                    index = JaxIndex(mesh, icfg, mips["rows"])
                    vals, ids = index.search(jnp.asarray(mips["queries"]),
                                             k=K)
                    ref[f"mips_{quant}"] = (np.asarray(vals), np.asarray(ids))
            ref[name] = _jax_steps(jtask, ds)
        ref["refresh"] = _one_process_refresh(base, tok, corpus, ds)
    except BaseException:
        for ps, _ in procs.values():
            for p in ps:
                p.kill()
        raise
    got = {name: _wait(ps, lroot / "out", WORKER_TIMEOUT_S)
           for name, (ps, lroot) in procs.items()}
    return ref, got, {name: str(lroot / "ckpt")
                      for name, (_, lroot) in procs.items()}


def _split_names(params):
    from emdr2_tpu_torch.parallel.tensor import split_of
    return {k for k in params if split_of(k) is not None}


# -------------------------------------------------------------- parameters

def test_shard_params_equals_the_jax_shards_on_a_4x2_mesh():
    """``shard_params(full, t, 2)`` is, for every parameter, the shard that
    the JAX ``param_shardings`` place on tp index t of a (4, 2) mesh (read
    from its addressable shards); ``gather_params`` of the parts is
    ``full``."""
    import __graft_entry__ as ge

    from emdr2_tpu.config import tiny_config as jax_tiny_config
    from emdr2_tpu.models import EMDR2Model as JaxModel
    from emdr2_tpu.parallel.mesh import bind_mesh, param_shardings
    mesh = build_mesh(MeshConfig(dp=4, tp=2))
    cfg = bind_mesh(jax_flash_cfg(jax_tiny_config()), mesh)
    model = JaxModel(cfg)
    batch = ge._random_batch(cfg, B=8, rng=np.random.RandomState(0))
    abstract = jax.eval_shape(lambda r: model.init({"params": r}, batch),
                              jax.random.PRNGKey(0))
    shardings = param_shardings(mesh, abstract)["params"]
    params = jax.jit(lambda r: nn.meta.unbox(
        model.init({"params": r}, batch)["params"]))(jax.random.PRNGKey(0))
    full = params_from_jax(unboxed_numpy(params))
    placed = jax.device_put(params, shardings)
    tp_of = {d.id: int(np.argwhere(mesh.devices == d)[0][1])
             for d in mesh.devices.flat}

    def shard_tree(t):
        return jax.tree_util.tree_map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if tp_of[s.device.id] == t), placed)

    parts = []
    for t in range(TP):
        want = params_from_jax(shard_tree(t))
        got = shard_params(full, t, TP)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        parts.append(got)
    split = _split_names(full)
    assert {k.rsplit(".", 2)[-2] for k in split if "layer_0" in k} >= {
        "qkv", "query", "key_value", "out", "wi", "wo"}
    assert all(parts[0][k].shape != full[k].shape for k in split)
    again = gather_params(parts, TP)
    assert all(torch.equal(again[k], full[k]) for k in full)


def test_a_split_model_holds_the_parts_of_the_unsplit_one():
    """The fused qkv kernel's part is head-blocked: rank t's [q | k | v]
    columns are those of its heads (a contiguous cut of the flat n*H axis
    would hand rank 0 all of q and half of k)."""
    from emdr2_tpu_torch.parallel.tensor import split_of
    full = torch.arange(4 * 3 * 8, dtype=torch.float32).reshape(4, 24)
    t1 = split_of("reader.encoder.layer_0.self_attention.qkv.kernel").take(
        full, 1, 2)
    want = full.view(4, 3, 8)[:, :, 4:].reshape(4, 12)
    assert torch.equal(t1, want)
    assert not torch.equal(t1, full[:, 12:])


# ---------------------------------------------------------- dropout rules

def _mesh22():
    return build_mesh(MeshConfig(dp=2, tp=2))


def test_k1_folds_the_seed_by_dp_and_tp_rank():
    """K0 in K1 on rank (d, t): local (batch * head) indices with seed +
    d * 0x9E3779B1 + t * 0x85EBCA77, bit for bit the masks of
    ``flash_self_attention_sharded`` on a (2, 2) mesh; without the tp term
    rank t = 1 draws other masks."""
    from emdr2_tpu.ops.fid_attention import flash_self_attention_sharded
    from emdr2_tpu_torch.ops.fid_attention import flash_self_attention
    from emdr2_tpu_torch.ops.hashing import shard_seed
    from emdr2_tpu_torch.parallel.tensor import Split
    Bk, L, nh, hd, rate, seed = 4, 16, 4, 16, 0.3, 0x12345678
    H = nh * hd
    slab = _one_hot_value_slab(Bk, L, nh, hd)
    bias = np.zeros((Bk, L), np.float32)
    want = np.asarray(flash_self_attention_sharded(
        jnp.asarray(slab.reshape(Bk, L, 3, H)), jnp.asarray(bias),
        jnp.uint32(seed), nh, _mesh22(), dropout_rate=rate)) != 0
    per, cols = Bk // 2, H // TP
    for d in range(2):
        rows = slice(d * per, (d + 1) * per)
        for t in range(TP):
            local = Split(2, 3).take(torch.as_tensor(slab[rows]), t, TP)
            got = flash_self_attention(local, torch.as_tensor(bias[rows]),
                                       nh // TP, shard_seed(seed, d, t),
                                       rate).numpy() != 0
            np.testing.assert_array_equal(
                got, want[rows][..., t * cols:(t + 1) * cols])
    local = Split(2, 3).take(torch.as_tensor(slab[per:]), 1, TP)
    no_tp = flash_self_attention(local, torch.as_tensor(bias[per:]),
                                 nh // TP, shard_seed(seed, 1), rate)
    assert not np.array_equal(no_tp.numpy() != 0, want[per:][..., cols:])
    assert 0.5 < want.mean() < 0.9


def test_k2_folds_the_seed_by_dp_and_tp_rank():
    """K0 in K2: rank (d, t)'s cross-attention masks over its heads are
    those of ``flash_cross_attention_sharded`` on a (2, 2) mesh (zero
    queries and keys, value j of each head the unit vector e_j, so the
    output is non-zero exactly where a key is kept)."""
    from emdr2_tpu.ops.fid_attention import flash_cross_attention_sharded
    from emdr2_tpu_torch.ops.fid_attention import flash_cross_attention
    from emdr2_tpu_torch.ops.hashing import shard_seed
    from emdr2_tpu_torch.parallel.tensor import Split
    Bk, Lq, Lk, nh, hd, rate, seed = 4, 8, 16, 4, 16, 0.3, 0x2468ACE1
    H = nh * hd
    q = np.zeros((Bk, Lq, H), np.float32)
    kv = np.zeros((Bk, Lk, 2, H), np.float32)
    for h in range(nh):
        for j in range(Lk):
            kv[:, j, 1, h * hd + j] = 1.0
    bias = np.zeros((Bk, Lk), np.float32)
    want = np.asarray(flash_cross_attention_sharded(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bias),
        jnp.uint32(seed), nh, _mesh22(), 16, dropout_rate=rate)) != 0
    per, cols = Bk // 2, H // TP
    slab = kv.reshape(Bk, Lk, 2 * H)
    for d in range(2):
        rows = slice(d * per, (d + 1) * per)
        for t in range(TP):
            ql = Split(2).take(torch.as_tensor(q[rows]), t, TP)
            kvl = Split(2, 2).take(torch.as_tensor(slab[rows]), t, TP)
            got = flash_cross_attention(ql, kvl, torch.as_tensor(bias[rows]),
                                        nh // TP, 16, shard_seed(seed, d, t),
                                        rate).numpy() != 0
            np.testing.assert_array_equal(
                got, want[rows][..., t * cols:(t + 1) * cols])
    ql = Split(2).take(torch.as_tensor(q[per:]), 1, TP)
    kvl = Split(2, 2).take(torch.as_tensor(slab[per:]), 1, TP)
    no_tp = flash_cross_attention(ql, kvl, torch.as_tensor(bias[per:]),
                                  nh // TP, 16, shard_seed(seed, 1), rate)
    assert not np.array_equal(no_tp.numpy() != 0, want[per:][..., cols:])


def _packed_dropout_seed(key):
    """The uint32 seed ``PackedDropout`` folds from the key it draws at the
    top of an apply."""
    from emdr2_tpu.ops.hashing import MIX_PRIMES

    class KeyProbe(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("dropout")

    kd = KeyProbe().apply({}, rngs={"dropout": key})
    if jnp.issubdtype(kd.dtype, jax.dtypes.prng_key):
        kd = jax.random.key_data(kd)
    words = [int(w) for w in np.asarray(kd, np.uint32).reshape(-1)]
    seed = words[0]
    for w in words[1:]:
        seed = ((seed * MIX_PRIMES[0]) & 0xFFFFFFFF) ^ w
    return seed


def test_materialized_attention_dropout_hashes_global_heads():
    """``_attend`` on rank (d, t) drops the probabilities [B/2, nh/2, Lq,
    Lk] at global coordinates: its rows offset by d * B/2 and its heads by
    t * nh/2, bit for bit the mask of ``PackedDropout`` jitted over a
    (2, 2) mesh with heads on tp; without the head offset rank t = 1 would
    repeat rank 0's heads."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from emdr2_tpu.models.layers import PackedDropout
    from emdr2_tpu_torch.models.layers import _attend
    Bk, nh, Lq, Lk, rate = 4, 4, 8, 16, 0.3
    key = jax.random.PRNGKey(5)
    seed = _packed_dropout_seed(key)
    x = jax.device_put(jnp.ones((Bk, nh, Lq, Lk), jnp.float32),
                       NamedSharding(_mesh22(), P("dp", "tp")))
    want = np.asarray(jax.jit(lambda x: PackedDropout(rate).apply(
        {}, x, deterministic=False, rngs={"dropout": key}))(x)) != 0
    per, hp = Bk // 2, nh // TP
    qk = torch.zeros(per, hp, Lq, 16)
    v = torch.zeros(per, hp, Lk, 16)
    for j in range(Lk):
        v[:, :, j, j] = 1.0

    def mask(d, t):
        return _attend(qk, qk[:, :, :1].expand(per, hp, Lk, 16), v, None,
                       torch.float32, rate, seed, d, t).numpy() != 0

    for d in range(2):
        for t in range(TP):
            np.testing.assert_array_equal(
                mask(d, t), want[d * per:(d + 1) * per, t * hp:(t + 1) * hp])
    assert not np.array_equal(mask(1, 0), want[per:, hp:])


def test_hidden_dropout_is_one_mask_on_the_tp_ranks():
    """Hidden dropout on the replicated [B, L, D] activations: the dp row
    offset and no tp term, so both tp ranks of a replica draw the mask of
    ``PackedDropout`` over the global rows; the attention kernels' seed of
    the same site does differ by tp rank."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from emdr2_tpu.models.layers import PackedDropout
    from emdr2_tpu_torch.ops.hashing import DropoutSeeds, packed_dropout
    Bk, L, H, rate = 4, 8, 16, 0.3
    key = jax.random.PRNGKey(3)
    seed = _packed_dropout_seed(key)
    x = jax.device_put(jnp.ones((Bk, L, H), jnp.float32),
                       NamedSharding(_mesh22(), P("dp")))
    want = np.asarray(jax.jit(lambda x: PackedDropout(rate).apply(
        {}, x, deterministic=False, rngs={"dropout": key}))(x)) != 0
    per = Bk // 2
    ones = torch.ones(per, L, H)
    for d in range(2):
        masks = []
        for t in range(TP):
            drop = DropoutSeeds(7, shard=d, tp_shard=t)
            masks.append(packed_dropout(ones, rate, seed,
                                        drop.row_offset(per)).numpy() != 0)
        np.testing.assert_array_equal(masks[0], want[d * per:(d + 1) * per])
        np.testing.assert_array_equal(masks[1], masks[0])
    a, b = (DropoutSeeds(7, 1, t) for t in range(TP))
    assert a.site(0) == b.site(0) and a.row_offset(2) == b.row_offset(2)
    assert a.kernel_seed(0) != b.kernel_seed(0)


# ----------------------------------------------------------- vocab-parallel

def test_vocab_parallel_reader_ce_matches_jax(runs):
    """The vocab-parallel CE over each rank's columns and its logits
    gradient match JAX ``vocab_parallel_cross_entropy`` on a (1, 2) mesh;
    each rank's gradient is its columns of the whole gradient."""
    ref, got, _ = runs
    want = ref["vocab"]
    V = want["logits"].shape[-1]
    cols = V // TP
    for t, res in enumerate(got["tp2"]):
        v = res["vocab"]
        np.testing.assert_allclose(v["loss"], want["loss"], atol=1e-5)
        np.testing.assert_allclose(v["grad"].numpy(),
                                   want["grad"][..., t * cols:(t + 1) * cols],
                                   atol=1e-6)


def test_vocab_parallel_gold_head_matches_jax(runs):
    """The teacher's gold head of a T5 split over tp (each rank's online
    logsumexp over its V/tp rows, combined by a max and a sum over tp)
    matches the JAX ``_vocab_parallel_gold_log_probs`` path."""
    ref, got, _ = runs
    for res in got["tp2"]:
        np.testing.assert_allclose(res["vocab"]["gold"].numpy(),
                                   ref["gold"]["want"], atol=2e-5)


# ------------------------------------------------------------------- steps

@pytest.mark.parametrize("layout", ["tp2", "dp2tp2"])
def test_two_openqa_steps_match_jax(runs, layout):
    """Two OPENQA steps at dropout 0 against the JAX task on the (1, 2) /
    (2, 2) mesh: the metrics, and the parameters gathered whole over
    tp."""
    ref, got, _ = runs
    want_steps, want_params = ref[layout]
    for res in got[layout]:
        for i, (g, w) in enumerate(zip(res["openqa"]["steps"], want_steps)):
            for key in METRICS:
                np.testing.assert_allclose(g[key], w[key], rtol=2e-4,
                                           atol=1e-6,
                                           err_msg=f"{key} step {i}")
        params = res["openqa"]["params"]
        for key, p in want_params.items():
            np.testing.assert_allclose(params[key].numpy(), p.numpy(),
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("layout", ["tp2", "dp2tp2"])
def test_whole_parameters_bit_equal_under_dropout(runs, layout):
    """At dropout 0.1: the parameters every tp rank holds whole are
    bit-equal on the tp ranks of a replica, and each rank's parameters
    bit-equal to those of its counterpart in the other replica."""
    _, got, _ = runs
    split = _split_names(got[layout][0]["openqa"]["dropout_local"])
    ranks = {res["ranks"]: res["openqa"] for res in got[layout]}
    for (w, d, t), res in ranks.items():
        local = res["dropout_local"]
        partner = next(r for (w2, d2, t2), r in ranks.items()
                       if d2 == d and t2 != t)["dropout_local"]
        for k in local:
            if k not in split:
                assert torch.equal(local[k], partner[k]), k
        for (w2, d2, t2), other in ranks.items():
            if t2 == t and d2 != d:
                assert all(torch.equal(local[k], other["dropout_local"][k])
                           for k in local)
        assert all(np.isfinite(v) for s in res["dropout_steps"]
                   for v in s.values())
    steps = [res["dropout_steps"] for res in ranks.values()]
    assert all(s == steps[0] for s in steps)


def test_remat_layouts_repeat_the_plain_step_under_tp(runs):
    """``--remat`` under both policies at tp 2: the recompute issues its
    collectives on every rank alike, and the step equals the step without
    remat (the same parameters, the metrics within rtol 2e-4)."""
    _, got, _ = runs
    for res in got["tp2"]:
        plain = res["openqa"]["steps"][0]
        for policy in ("nothing", "dots_no_batch"):
            m, _ = res["remat"][policy]
            for key in METRICS:
                np.testing.assert_allclose(m[key], plain[key], rtol=2e-4,
                                           atol=1e-6, err_msg=policy)
    a, b = (res["remat"]["dots_no_batch"][1] for res in got["tp2"])
    split = _split_names(a)
    assert all(torch.equal(a[k], b[k]) for k in a if k not in split)


def test_dpr_steps_match_jax_at_tp2(runs):
    """DPRTask at tp 2 against the JAX task on the (1, 2) mesh: two steps'
    metrics, the gathered parameters, ``validate``; at dropout 0.1 the
    whole parameters bit-equal on both tp ranks."""
    ref, got, _ = runs
    want = ref["dpr_task"]
    for res in got["tp2"]:
        d = res["dpr_task"]["plain"]
        for g, w in zip(d["steps"], want["steps"]):
            np.testing.assert_allclose(g["loss"], w["loss"], atol=1e-5)
            assert g["correct_prediction_count"] == \
                w["correct_prediction_count"]
        for k, v in want["params"].items():
            np.testing.assert_allclose(d["params"][k].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=k)
        for k in want["valid"]:
            np.testing.assert_allclose(d["valid"][k], want["valid"][k],
                                       atol=1e-9, err_msg=k)
    a, b = (res["dpr_task"]["dropout"]["local"] for res in got["tp2"])
    split = _split_names(a)
    assert all(torch.equal(a[k], b[k]) for k in a if k not in split)
    assert any(not torch.equal(a[k], b[k]) for k in split)


# -------------------------------------- search, evaluation, checkpoints

@pytest.mark.parametrize("quant", ["none", "int8"])
def test_search_over_dp_x_tp_blocks_matches_jax(runs, quant):
    """The index's rows over the 4 ranks of the (2, 2) grid, by world
    rank; each replica's queries gathered over dp only: the JAX index on a
    (2, 2) mesh gives the same ids (values 1e-6)."""
    ref, got, _ = runs
    want_vals, want_ids = ref[f"mips_{quant}"]
    b = NQ // 2
    blocks = {}
    for res in got["dp2tp2"]:
        world, d, _ = res["ranks"]
        vals, ids, (start, stop), held = res["mips"][quant]
        assert held == stop - start < N_ROWS // 3
        blocks[world] = (start, stop)
        np.testing.assert_array_equal(ids.numpy(),
                                      want_ids[d * b:(d + 1) * b])
        np.testing.assert_allclose(vals.numpy(), want_vals[d * b:(d + 1) * b],
                                   atol=1e-6, rtol=1e-6)
    size = blocks[0][1]
    assert [blocks[w] for w in range(4)] == [
        (w * size, (w + 1) * size) for w in range(4)]


@pytest.mark.parametrize("mode", ["greedy", "int8"])
def test_evaluate_em_at_tp2_gives_jax_texts(runs, mode):
    """``evaluate_em`` at tp 2 (the step's logits gathered over tp; under
    int8 the K5 path on each rank's heads) generates the JAX texts row for
    row, on both tp ranks."""
    ref, got, _ = runs
    want_em, want_texts = ref[f"em_{mode}"]
    for res in got["tp2"]:
        em, texts = res["openqa"][f"em_{mode}"]
        assert texts == want_texts
        assert em == want_em


def test_checkpoints_cross_tp_bit_for_bit(runs, tmp_path):
    """A checkpoint written at tp 2 is the file one process writes: it
    restores at tp 1 to the ranks' gathered parameters bit for bit; and a
    checkpoint written at tp 1 restores at tp 2 (parameters and Adam
    moments, gathered) bit for bit."""
    from emdr2_tpu_torch.data.tokenizer import (BertWordPieceTokenizer,
                                                toy_vocab)
    from emdr2_tpu_torch.retrieval import ShardedEvidenceIndex
    from emdr2_tpu_torch.tasks import E2EQATask
    from emdr2_tpu_torch.training import checkpointing
    ref, got, ckpts = runs
    params, moments = ref["one_process_ckpt"]
    for res in got["tp2"] + got["dp2tp2"]:
        r = res["openqa"]["restored"]
        assert (r["iteration"], r["step"], r["count"]) == (1, 1, 1)
        assert all(torch.equal(r["params"][k], params[k]) for k in params)
        assert all(torch.equal(r["adam"][k], moments[k]) for k in moments)
    spec = torch.load(os.path.join(os.path.dirname(ckpts["tp2"]), "spec.pt"),
                      weights_only=False)
    for layout in ("tp2", "dp2tp2"):
        cfg = spec["cfg"]
        task = E2EQATask(cfg, BertWordPieceTokenizer(
            toy_vocab(spec["world"]["words"]), vocab_extra_ids=10), None,
            ShardedEvidenceIndex(cfg.index, spec["emb"], device="cpu"),
            total_train_iters=4, device="cpu")
        task.init_state(0, state_dict=spec["params"])
        _, it = checkpointing.load_checkpoint(ckpts[layout], task.state)
        assert it == 2 and task.state.step == 2
        want = got[layout][0]["openqa"]["params"]
        restored = task.state.model.state_dict()
        assert all(torch.equal(restored[k], want[k]) for k in want)


def test_refresh_at_tp2_embeds_each_ranks_rows(runs):
    """At tp 2 each rank embeds its own block of rows with the context
    tower gathered whole (no collective inside the embed) and swaps it in:
    the rows and the search after the swap are the one-process refresh's
    (rows and scores: fp32 products of another process, rtol 1e-5); the
    asynchronous refresher, handed the tower at ``start``, swaps in the
    same rows (fp16 host rows: 1e-3)."""
    ref, got, _ = runs
    rows, vals, ids = ref["refresh"]
    per = B
    for res in got["tp2"]:
        f = res["refresh"]
        start, stop = f["row_range"]
        assert f["swapped"] and stop - start < rows.shape[0]
        real = min(stop, rows.shape[0]) - start
        np.testing.assert_allclose(f["rows"][:real].numpy(),
                                   rows[start:start + real].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(f["ids"], ids[:per])
        np.testing.assert_allclose(f["vals"].numpy(), vals[:per].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert f["async_swapped"]
        np.testing.assert_allclose(f["async_rows"].numpy(),
                                   f["rows"].numpy(), atol=1e-3)
    starts = sorted(res["refresh"]["row_range"][0] for res in got["tp2"])
    assert starts[0] == 0 and starts[1] > 0


def test_the_tp_collectives_stay_in_their_groups(runs):
    """At dp 2 x tp 2 the reader's all-reduces run over the tp group and
    the gradient mean over the dp group: both move bytes on every rank."""
    _, got, _ = runs
    for res in got["dp2tp2"]:
        assert res["bytes"]["tp"].get("all_reduce", 0) > 0
        assert res["bytes"]["dp"].get("all_reduce", 0) > 0


# ------------------------------------------------------------ command line

def _cli_args(d, extra):
    from tests.test_torch_parallel import CLI_MODEL, CLI_TASK, _cli_data
    return (["--task", "OPENQA", "--save", str(d / "run"), "--epochs", "1",
             "--log-interval", "1", "--save-interval", "1",
             "--eval-interval", "100",
             "--coordinator-address", f"file://{d / 'store'}"]
            + extra + _cli_data(d) + CLI_TASK + CLI_MODEL)


def _run_ranks(args, world, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "emdr2_tpu_torch.tasks.run"] + args
        + ["--num-processes", str(world), "--process-id", str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=cwd)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return logs


@pytest.mark.parametrize("flags,world,iters", [
    (["--tp", "2"], 2, 4), (["--dp", "2", "--tp", "2"], 4, 2)])
def test_cli_runs_tensor_parallel(tmp_path, flags, world, iters):
    """``tasks.run --tp 2`` in two processes (one replica: a global batch
    of 4, 4 iterations over 16 questions) and ``--dp 2 --tp 2`` in four
    (a global batch of 8, 2 iterations), with checkpoints and the EM
    evaluation; world rank 0 alone prints and writes the checkpoint, which
    holds the whole parameters."""
    from emdr2_tpu_torch.training.checkpointing import (latest_iteration,
                                                        read_payload)
    d = _cli_world(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    logs = _run_ranks(_cli_args(d, flags), world, root)
    assert f"iteration        {iters}/{iters}" in logs[0]
    assert f"final ({iters} iters) | valid EM" in logs[0]
    assert "over 16" in logs[0]
    assert all("iteration" not in log for log in logs[1:])
    assert latest_iteration(str(d / "run")) == iters
    payload, _ = read_payload(str(d / "run"))
    qkv = payload["model"][
        "retriever.query_model.encoder.layer_0.self_attention.qkv.kernel"]
    assert tuple(qkv.shape) == (32, 96)


def _cli_world(d):
    """The data of ``test_torch_parallel.py``'s command-line world: 16
    passages, their embedding store (built at tp 1), 16 questions."""
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    from emdr2_tpu_torch.tools.build_evidence import build
    from emdr2_tpu_torch.tools.create_doc_index import main as build_index
    from tests.test_torch_parallel import CLI_MODEL
    words = [f"item{i}" for i in range(16)] + [
        "red", "blue", "color", "of", "is", "what", "the"]
    (d / "vocab.txt").write_text("\n".join(toy_vocab(words)) + "\n")
    colors = ["red", "blue"]
    rows = ["id\ttext\ttitle"] + [
        f"{i + 1}\tthe color of item{i} is {colors[i % 2]}\titem{i // 2}"
        for i in range(16)]
    (d / "evidence.tsv").write_text("\n".join(rows) + "\n")
    (d / "qa.csv").write_text("\n".join(
        f"what is the color of item{i}\t['{colors[i % 2]}']"
        for i in range(16)) + "\n")
    assert build(str(d / "evidence.tsv"), str(d / "wiki"),
                 str(d / "vocab.txt"), workers=1) == 16
    assert build_index(["--evidence-data-path", str(d / "wiki"),
                        "--vocab-file", str(d / "vocab.txt"),
                        "--embedding-path", str(d / "emb"),
                        "--batch-size", "8"] + CLI_MODEL) == 0
    return d


def test_retriever_cli_runs_at_tp2(tmp_path):
    """``tasks.run --task RETRIEVER --tp 2`` in two processes: training,
    validation, the post-train index (each rank's block, embedded with the
    gathered tower) and its recall; rank 0 alone prints and writes the
    checkpoint and the embedding store."""
    from emdr2_tpu_torch.data.tokenizer import toy_vocab
    from emdr2_tpu_torch.retrieval import EmbeddingStore
    from emdr2_tpu_torch.tools.build_evidence import build
    from emdr2_tpu_torch.training.checkpointing import latest_iteration
    from tests.test_torch_dpr import make_dpr_json, vocab_words
    from tests.test_torch_parallel import CLI_MODEL
    d = tmp_path
    (d / "vocab.txt").write_text("\n".join(toy_vocab(vocab_words())) + "\n")
    make_dpr_json(d / "train.json")
    make_dpr_json(d / "valid.json", n=7, offset=16)
    (d / "evidence.tsv").write_text("\n".join(
        ["id\ttext\ttitle"] + [f"{i + 1}\titem{i} is thing{i}\titem{i}"
                               for i in range(24)]) + "\n")
    assert build(str(d / "evidence.tsv"), str(d / "wiki"),
                 str(d / "vocab.txt"), workers=1) == 24
    (d / "dev.csv").write_text("".join(
        f"what is item{i}\t['thing{i}']\n" for i in range(8)))
    args = ["--task", "RETRIEVER", "--vocab-file", str(d / "vocab.txt"),
            "--train-data", str(d / "train.json"),
            "--valid-data", str(d / "valid.json"),
            "--evidence-data-path", str(d / "wiki"),
            "--qa-file-dev", str(d / "dev.csv"),
            "--embedding-path", str(d / "emb"), "--save", str(d / "dpr"),
            "--batch-size", "4", "--tp", "2", "--train-iters", "3",
            "--epochs", "1", "--log-interval", "1", "--save-interval", "2",
            "--val-av-rank-other-neg", "1", "--val-av-rank-hard-neg", "1",
            "--report-topk-accuracies", "1", "5", "10",
            "--coordinator-address", f"file://{d / 'store'}"] + CLI_MODEL[
                :CLI_MODEL.index("--fid-flash-attention")] + [
                "--device", "cpu"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    logs = _run_ranks(args, 2, root)
    assert "iteration        3/3" in logs[0] and "epoch 0" in logs[0]
    assert "DEV retrieval" in logs[0] and "recall@10" in logs[0]
    assert "iteration" not in logs[1] and "DEV" not in logs[1]
    assert latest_iteration(str(d / "dpr")) == 3
    assert len(EmbeddingStore.load(str(d / "emb")).ids) == 24


def test_layouts_that_do_not_divide_are_refused():
    """``check_mesh_config`` takes a tp that divides the heads, the MLP
    width and the vocabulary of both towers and the reader, and refuses
    any other naming which; the trainers of a [dp, tp] grid take cards
    0 .. dp*tp - 1 and the embedders the cards after them."""
    from emdr2_tpu_torch.config import MeshConfig as Mesh
    from emdr2_tpu_torch.config import tiny_config
    from emdr2_tpu_torch.parallel import check_mesh_config, embed_devices
    cfg = tiny_config()
    check_mesh_config(Mesh(dp=2, tp=2), 4, model=cfg)
    for tp, field in ((3, "num_heads 4"), (8, "num_heads 4")):
        with pytest.raises(ValueError, match=f"does not divide {field}"):
            check_mesh_config(Mesh(dp=1, tp=tp), tp, model=cfg)
    wide = dataclasses.replace(cfg.reader.transformer, num_heads=6,
                               ffn_size=125)
    with pytest.raises(ValueError, match="ffn_size 125 of the reader"):
        check_mesh_config(Mesh(dp=1, tp=2), 2, model=cfg.replace(
            reader=dataclasses.replace(cfg.reader, transformer=wide)))
    odd = dataclasses.replace(cfg.retriever.encoder, vocab_size=513)
    with pytest.raises(ValueError, match="vocab_size 513 of the towers"):
        check_mesh_config(Mesh(dp=1, tp=2), 2, model=cfg.replace(
            retriever=dataclasses.replace(cfg.retriever, encoder=odd)))
    with pytest.raises(ValueError, match="needs 4 processes"):
        check_mesh_config(Mesh(dp=2, tp=2), 2)
    mesh = Mesh(dp=1, tp=2, embed_devices=2)
    check_mesh_config(mesh, 2, n_cards=4)
    assert [[d.index for d in embed_devices(mesh, r, torch.device(
        "cuda", r))] for r in range(2)] == [[2], [3]]
    with pytest.raises(ValueError, match="dp \\* tp \\+ embed-devices = 5"):
        check_mesh_config(Mesh(dp=2, tp=2, embed_devices=1), 4, n_cards=4)
