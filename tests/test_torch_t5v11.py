"""T5 v1.1's block in the PyTorch port (``config.t5_v11``: RMSNorm, gated
GELU, no biases, bucketed relative-position bias, unscaled scores, an
untied head), against the benchmark's plain reference
(``benchmark/reference/t5v11.py``, float32, no code of the port) on seeded
random weights at a tiny size, on the CPU, where the flash kernels run
their plain versions.

Sizes: encoder rows of 48 tokens with 16 buckets and a max distance of 24,
so offsets past the exact range (4 a side) take the logarithmic buckets;
decoder rows of 8 (causal, exact below 8). Tolerance: float32 on both
sides, differing in summation order only: 1e-4 of the largest magnitude.
The JAX package has no such block; the default block's JAX parity tests
are the other files' and run unchanged.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.program_t5v11 import emdr2_config  # noqa: E402
from benchmark.reference import model as M  # noqa: E402
from benchmark.reference import t5v11 as R  # noqa: E402
from emdr2_tpu_torch.config import (TransformerConfig, t5_base,  # noqa: E402
                                    t5_v11, tiny_config)
from emdr2_tpu_torch.data import masks  # noqa: E402
from emdr2_tpu_torch.models.emdr2 import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.models.layers import (  # noqa: E402
    relative_position_bucket)
from emdr2_tpu_torch.models.t5 import T5Model  # noqa: E402
from emdr2_tpu_torch.ops import fid_attention as fa  # noqa: E402
from emdr2_tpu_torch.ops.hashing import DropoutSeeds  # noqa: E402
from emdr2_tpu_torch.parallel.mesh import Group  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4


def _tower():
    return {"vocab_size": 512, "hidden_size": 64, "num_layers": 2,
            "num_heads": 4, "ffn_size": 128, "max_position_embeddings": 128,
            "num_tokentypes": 2, "hidden_dropout": 0.1,
            "attention_dropout": 0.1, "layernorm_epsilon": 1e-05,
            "init_std": 0.02, "gelu": "erf", "compute_dtype": "float32",
            "flash_attention": True, "flash_key_chunk": 48, "remat": False}


def tiny_cfg():
    """atlas-large-nq's file at tiny widths (float32, flash on)."""
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "atlas-large-nq.json").read_text())
    cfg.update(retriever=_tower(),
               reader=dict(cfg["reader"], d_model=64, d_ff=96, d_kv=16,
                           num_heads=4, num_layers=2, num_decoder_layers=2,
                           vocab_size=640, compute_dtype="float32",
                           flash_key_chunk=48,
                           relative_attention_num_buckets=16,
                           relative_attention_max_distance=24),
               embed_dim=64, query_seq_len=16, context_seq_len=32,
               reader_seq_len=48, decoder_seq_len=8, topk=4, index_rows=4096,
               index_group_size=8, index_chunk_rows=256, num_passages=300)
    cfg["optimizer"] = dict(cfg["optimizer"], train_iters=100, lr=1e-3)
    return cfg


def _close(got, want, tol=TOL):
    ref = want.detach().float().abs().max().item() or 1.0
    err = (got.detach().float() - want.detach().float()).abs().max().item()
    assert err <= tol * ref, (err, ref)


@pytest.fixture(scope="module")
def pair():
    """(file config, the port's model with the reference's weights,
    those weights)."""
    cfg = tiny_cfg()
    model = EMDR2Model(emdr2_config(cfg), device="cpu")
    weights = R.make_params(cfg, 5, "cpu")
    model.load_state_dict(weights, strict=True)
    M.strict_float32()
    return cfg, model, weights


def _reader_ids(seed, rows=3, L=48, real=40, vocab=600):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, vocab, (rows, L), generator=g)
    ids[:, real:] = 0
    ids[-1, real // 2:] = 0
    return ids


# ------------------------------------------------------------- the buckets

def _hf_bucket(relative_position, bidirectional=True, num_buckets=32,
               max_distance=128):
    """HF's ``T5Attention._relative_position_bucket``, as written there."""
    relative_buckets = 0
    if bidirectional:
        num_buckets //= 2
        relative_buckets += (relative_position > 0).to(torch.long) \
            * num_buckets
        relative_position = torch.abs(relative_position)
    else:
        relative_position = -torch.min(relative_position,
                                       torch.zeros_like(relative_position))
    max_exact = num_buckets // 2
    is_small = relative_position < max_exact
    relative_position_if_large = max_exact + (
        torch.log(relative_position.float() / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.long)
    relative_position_if_large = torch.min(
        relative_position_if_large,
        torch.full_like(relative_position_if_large, num_buckets - 1))
    relative_buckets += torch.where(is_small, relative_position,
                                    relative_position_if_large)
    return relative_buckets


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (16, 24)])
def test_buckets_are_hf_t5s(bidirectional, buckets, distance):
    offsets = torch.arange(-600, 601)
    want = _hf_bucket(offsets, bidirectional, buckets, distance)
    got = relative_position_bucket(offsets, bidirectional, buckets, distance)
    assert torch.equal(got, want)
    assert torch.equal(R.relative_bucket(offsets, bidirectional, buckets,
                                         distance), want)
    assert int(got.max()) == buckets - 1 and int(got.min()) == 0


# ------------------------------------------------ the kernels' plain twins

def _materialized(qkv, bias, nh, scale, rel):
    """softmax(q k^T * scale + rel + bias) v by autograd, heads first."""
    B, L, H3 = qkv.shape
    hd = H3 // 3 // nh
    h = qkv.view(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
    s = h[0] @ h[1].transpose(-1, -2) * scale
    s = s + fa.rel_bias_full(rel, L, L) + bias[:, None, None, :]
    o = torch.softmax(s, dim=-1) @ h[2]
    return o.permute(0, 2, 1, 3).reshape(B, L, -1)


@pytest.mark.parametrize("L", [48, 130])
def test_self_attention_twin_with_relative_bias_and_scale(L):
    g = torch.Generator().manual_seed(L)
    B, nh = 3, 4
    qkv = (0.5 * torch.randn(B, L, 3 * nh * 16, generator=g))
    rel = torch.randn(nh, 2 * L - 1, generator=g)
    bias = torch.zeros(B, L)
    bias[-1, L // 3:] = -1e9
    dout = torch.randn(B, L, nh * 16, generator=g)
    x, r = qkv.clone().requires_grad_(True), rel.clone().requires_grad_(True)
    got = fa.flash_self_attention(x, bias, nh, None, 0.0, 1.0, r)
    got.backward(dout)
    x2, r2 = qkv.clone().requires_grad_(True), rel.clone().requires_grad_(True)
    want = _materialized(x2, bias, nh, 1.0, r2)
    want.backward(dout)
    _close(got, want)
    _close(x.grad, x2.grad)
    _close(r.grad, r2.grad)


def test_cross_attention_twin_with_scale():
    g = torch.Generator().manual_seed(3)
    B, Lq, Lk, nh, chunk = 2, 8, 96, 4, 48
    q = 0.5 * torch.randn(B, Lq, nh * 16, generator=g)
    kv = 0.5 * torch.randn(B, Lk, 2 * nh * 16, generator=g)
    bias = torch.zeros(B, Lk)
    bias[:, 70:] = -1e9
    dout = torch.randn(B, Lq, nh * 16, generator=g)
    a, b = q.clone().requires_grad_(True), kv.clone().requires_grad_(True)
    got = fa.flash_cross_attention(a, b, bias, nh, chunk, None, 0.0, 1.0)
    got.backward(dout)
    a2, b2 = q.clone().requires_grad_(True), kv.clone().requires_grad_(True)
    qh = a2.view(B, Lq, nh, 16).transpose(1, 2)
    kh, vh = (t.view(B, Lk, nh, 16).transpose(1, 2)
              for t in b2.chunk(2, dim=-1))
    s = qh @ kh.transpose(-1, -2) + bias[:, None, None, :]
    want = (torch.softmax(s, -1) @ vh).transpose(1, 2).reshape(B, Lq, -1)
    want.backward(dout)
    _close(got, want)
    _close(a.grad, a2.grad)
    _close(b.grad, b2.grad)


def test_counts_of_the_relative_calls_are_the_yardsticks():
    from benchmark.counts import relpos
    assert fa._rel_counts(200, 512, 16, 64, True, False) == \
        relpos.rel_self_attention_fwd(200, 512, 16, 64, True)
    assert fa._rel_counts(200, 512, 16, 64, False, False) == \
        relpos.rel_self_attention_fwd(200, 512, 16, 64, False)
    assert fa._rel_counts(200, 512, 16, 64, True, True) == \
        relpos.rel_self_attention_bwd(200, 512, 16, 64)


# ------------------------------------------------- the model and the step

@pytest.mark.parametrize("dropout", [False, True])
def test_encoder_fid_logits_and_teacher_match_reference(pair, dropout):
    cfg, model, w = pair
    t = cfg["reader"]
    num = M.Numerics("fp32")
    drop = DropoutSeeds(1234) if dropout else None
    seeds = M.Seeds(1234) if dropout else None
    ids = _reader_ids(1)
    with torch.no_grad():
        enc = model.reader.encode(ids, drop)
        _close(enc, R.t5_encode(w, ids, t, seeds, num))
        dec = torch.randint(1, 600, (1, 8), generator=torch.Generator()
                            .manual_seed(2))
        dec[:, 6:] = 0
        flat = ids.reshape(1, -1)
        enc_flat = enc.reshape(1, -1, enc.shape[-1])
        logits = model.reader.decode(dec, enc_flat,
                                     masks.attention_mask(dec, flat), drop)
        _close(logits, R.t5_decode(w, dec, enc_flat, flat, t, seeds, num))
        # the teacher's head: the online logsumexp over 4 vocab chunks
        rep = dec.repeat(3, 1)
        labels = torch.randint(1, 600, rep.shape, generator=torch.Generator()
                               .manual_seed(4))
        gold = model.reader.decode_gold_log_probs(
            rep, enc, masks.attention_mask(rep, ids), labels, drop)
        rlog = R.t5_decode(w, rep, R.t5_encode(w, ids, t, seeds, num), ids,
                           t, seeds, num)
        _close(gold, torch.log_softmax(rlog, -1).gather(
            -1, labels[..., None])[..., 0])


def test_reader_gradients_match_reference_both_tables(pair):
    """Every reader leaf's gradient of a random projection of the FiD
    logits, elementwise: the encoder's table through K1's plain twin, the
    decoder's through the materialized causal bias."""
    cfg, model, w = pair
    num = M.Numerics("fp32")
    ids = _reader_ids(6)
    dec = torch.randint(1, 600, (1, 8), generator=torch.Generator()
                        .manual_seed(7))
    proj = torch.randn(1, 8, 640, generator=torch.Generator().manual_seed(8))
    model.zero_grad(set_to_none=True)
    drop = DropoutSeeds(99)
    enc = model.reader.encode(ids, drop.fold(0))
    flat = ids.reshape(1, -1)
    logits = model.reader.decode(dec, enc.reshape(1, -1, enc.shape[-1]),
                                 masks.attention_mask(dec, flat),
                                 drop.fold(1))
    (logits * proj).sum().backward()
    p = {n: t.clone().requires_grad_(True) for n, t in w.items()
         if n.startswith("reader.")}
    seeds = M.Seeds(99)
    renc = R.t5_encode(p, ids, cfg["reader"], seeds.fold(0), num)
    rlog = R.t5_decode(p, dec, renc.reshape(1, -1, renc.shape[-1]), flat,
                       cfg["reader"], seeds.fold(1), num)
    (rlog * proj).sum().backward()
    grads = dict(model.named_parameters())
    for name in ("reader.encoder.relative_attention_bias",
                 "reader.decoder.relative_attention_bias"):
        assert grads[name].grad.abs().max() > 0, name
    for name, t in p.items():
        _close(grads[name].grad, t.grad, 2 * TOL)


def test_train_step_matches_reference():
    """Two ``E2EQATask.train_step``s through the benchmark's driver of the
    T5 v1.1 cell, at tiny size: each step's loss and global gradient norm,
    every leaf's first gradient (the relative-position tables among them)
    and its change after both, against the plain reference following the
    same searches and dropout masks."""
    manifest = harness.read_json(ROOT / "BENCHMARK.json")
    traffic = json.loads((ROOT / "benchmark" / "workloads" /
                          "atlas-large-b4.json").read_text())
    traffic.update(questions_per_step=2, question_tokens=[3, 10],
                   answer_tokens=[1, 7], passage_tokens=[10, 18],
                   reference_block_rows=3)
    run = harness.Run(manifest, "atlas-large-b4", 2 ** 31 + 17, 0.0, False,
                      device="cpu", overrides={"config": tiny_cfg(),
                                               "traffic": traffic})
    try:
        mod = harness.load_module(
            ROOT / "benchmark" / "drivers" / "openqa_train_t5v11.py",
            "t5v11_driver_test")
        drv = mod.Driver(run)
        drv.setup()
        M.strict_float32()
        ref = mod.reference_run(drv, M.Numerics("fp32"), drv.searched,
                                drv.built)
    finally:
        run.close()
    assert ref["format_mismatches"] == 0 and ref["retrieval_gap"] == 0.0
    for s, m in enumerate(drv.metrics):
        assert m["loss"] == pytest.approx(ref["losses"][s], rel=TOL)
        assert m["grad_norm"] == pytest.approx(ref["grad_norm"][s], rel=TOL)
    tables = [n for n in ref["grad_norms"] if "relative_attention_bias" in n]
    assert len(tables) == 2
    for name in tables:
        assert drv.grad_norms[name] == pytest.approx(ref["grad_norms"][name],
                                                     rel=1e-4), name
    # every leaf, over the larger of its norm and the median leaf's (the
    # keys' biases under softmax get gradients of rounding size)
    assert mod.base.leaf_gap(drv.grad_norms, ref["grad_norms"]) < 1e-4
    # AdamW's change over the leaves the harness compares it on (those
    # whose gradient is not of rounding size, which Adam would scale up)
    assert mod.base.leaf_gap(drv.update_norms, ref["update_norms"],
                             mod.base._moved(ref["grad_norms"])) < 1e-4


# ---------------------------------------------------------- the refusals

def test_generation_is_refused_on_the_relative_block(pair):
    _, model, _ = pair
    with pytest.raises(NotImplementedError, match="generation"):
        model.decode_step(torch.ones(1, 1, dtype=torch.long),
                          torch.ones(1, 4, dtype=torch.long), [], None)


def test_tensor_parallelism_is_refused_on_the_t5v11_block():
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        T5Model(t5_v11(vocab_size=640, hidden_size=64, num_layers=1,
                       num_heads=4, ffn_size=96), device="cpu",
                tp=Group(0, 2))


def test_the_general_kernel_is_refused_for_the_relative_bias():
    cfg = emdr2_config(dict(tiny_cfg(), reader=dict(
        tiny_cfg()["reader"], flash_key_chunk=16)))
    with pytest.raises(ValueError, match="K1 only"):
        EMDR2Model(cfg, device="cpu")


# -------------------------------------------------------- the default block

def test_default_block_builds_what_it_built(pair):
    """The default ``TransformerConfig`` is the Megatron block: the same
    leaves as the benchmark's Megatron reference names, no relative table,
    no untied head, and the reader's outputs of that reference on its
    weights; the kernels' default scale is hd^-0.5, exactly."""
    assert TransformerConfig().block == t5_base().block == "megatron"
    assert t5_v11().block == "t5_v11"
    with pytest.raises(ValueError, match="block"):
        TransformerConfig(block="rmsnorm")
    cfg = tiny_config()
    model = EMDR2Model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    spec = {
        "retriever": dict(_tower(), hidden_dropout=0.0,
                          attention_dropout=0.0),
        "reader": dict(_tower(), vocab_size=640, num_tokentypes=0,
                       hidden_dropout=0.0, attention_dropout=0.0)}
    names = {n for n, _, _ in M.param_specs(spec)}
    assert {n for n, _ in model.named_parameters()} == names
    w = M.make_params(spec, 3, "cpu")
    model.load_state_dict(w, strict=True)
    ids = _reader_ids(9)
    with torch.no_grad():
        enc = model.reader.encode(ids)
    _close(enc, M.t5_encode(w, ids, spec["reader"], None, M.Numerics("fp32")))
    g = torch.Generator().manual_seed(1)
    qkv, bias = torch.randn(2, 48, 3 * 64, generator=g), torch.zeros(2, 48)
    assert torch.equal(fa.flash_self_attention(qkv, bias, 4),
                       fa.flash_self_attention(qkv, bias, 4, scale=0.25))
