"""The port's measurement tools (``emdr2_tpu_torch/tools/bench_*.py``) on
the CPU at ``tiny_config()`` widths (``flagship.base_config`` patched,
``flagship.SHARD_ROWS`` cut to 4,096 rows), against the JAX package's:

- ``tools/flagship.py``'s FLOP formulas equal ``bench.py``'s exactly. The
  JAX side runs in a subprocess (``JAX_PLATFORMS=cpu``): importing
  ``bench.py`` switches jax's default PRNG for every later JAX test of the
  process, and no ``emdr2_tpu.tools.bench_*`` module (they import it) is
  imported here either.
- Each tool's ``main(argv)`` with ``--device cpu`` prints rows whose JSON
  keys are the JAX tool's (each key is also read, quoted, from the JAX
  tool's source). The tools that run rows in processes of their own run
  them in this process here (``flagship.child_row`` replaced).
- An out-of-memory row is recorded, a dead row process too, and
  ``--skip-done`` resumes from ``--out``.
- The rescore tool's recall equals the JAX ``mips_topk``'s on the same
  numpy inputs (the Pallas scan in interpret mode).
- The step breakdown's three pass values (fp32, no dropout) equal the JAX
  model methods' on the same converted weights within 1e-5.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu_torch.config import tiny_config  # noqa: E402
from emdr2_tpu_torch.tools import flagship  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bench_mips_rescore", "bench_kernel_sweep", "bench_step_breakdown",
         "bench_dropout_breakdown", "bench_train_sweep", "bench_pipeline")


def _in_process_child(module, args):
    """``flagship.child_row`` in this process: the row process's main with
    its stdout captured, its last line parsed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(module).main(args)
    return json.loads(buf.getvalue().strip().splitlines()[-1]), ""


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    from emdr2_tpu_torch.tools import bench_pipeline
    monkeypatch.setattr(flagship, "base_config", tiny_config)
    monkeypatch.setattr(flagship, "SHARD_ROWS", 4096)
    monkeypatch.setattr(flagship, "child_row", _in_process_child)
    monkeypatch.setattr(bench_pipeline, "CACHE", tmp_path / "cache")
    return tmp_path


def _run(main, argv):
    """(main's result, the JSON lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv + ["--device", "cpu"])
    return result, [json.loads(ln) for ln in buf.getvalue().splitlines()
                    if ln.startswith("{")]


# ---- the FLOP formulas against bench.py's --------------------------------

_BENCH_SIDE = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, ".")
import bench
from emdr2_tpu.config import EMDR2Config, tiny_config
out = {}
for name, cfg in (("flagship", EMDR2Config()), ("tiny", tiny_config())):
    enc, t5 = cfg.retriever.encoder, cfg.reader.transformer
    for B in (1, 4, 8):
        for K in (2, 50):
            out[f"{name} step {B} {K}"] = bench.model_flops_per_step(cfg, B, K)
    for S in (cfg.retriever.query_seq_len, cfg.retriever.seq_len,
              cfg.reader.seq_len, cfg.reader.decoder_seq_len):
        for H, F in ((enc.hidden_size, enc.ffn_size),
                     (t5.hidden_size, t5.ffn_size)):
            out[f"{name} self {S} {H} {F}"] = bench.layer_self_flops(S, H, F)
    Ld, Lr = cfg.reader.decoder_seq_len, cfg.reader.seq_len
    for Lk in (Lr, 2 * Lr, 50 * Lr):
        out[f"{name} dec {Ld} {Lk}"] = bench.decoder_stack_flops(
            Ld, Lk, t5.hidden_size, t5.ffn_size, t5.num_layers)
print(json.dumps(out))
"""


def test_flop_formulas_equal_bench_py():
    """``layer_self_flops``, ``decoder_stack_flops`` and
    ``model_flops_per_step`` equal ``bench.py``'s on ``EMDR2Config()`` and
    ``tiny_config()`` at B in {1, 4, 8}, K in {2, 50}; ``pass_flops`` sums
    to the step's."""
    from emdr2_tpu_torch.config import EMDR2Config
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _BENCH_SIDE], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    got = {}
    for name, cfg in (("flagship", EMDR2Config()), ("tiny", tiny_config())):
        enc, t5 = cfg.retriever.encoder, cfg.reader.transformer
        for B in (1, 4, 8):
            for K in (2, 50):
                step = flagship.model_flops_per_step(cfg, B, K)
                got[f"{name} step {B} {K}"] = step
                assert sum(flagship.pass_flops(cfg, B, K).values()) == step
        for S in (cfg.retriever.query_seq_len, cfg.retriever.seq_len,
                  cfg.reader.seq_len, cfg.reader.decoder_seq_len):
            for H, F in ((enc.hidden_size, enc.ffn_size),
                         (t5.hidden_size, t5.ffn_size)):
                got[f"{name} self {S} {H} {F}"] = \
                    flagship.layer_self_flops(S, H, F)
        Ld, Lr = cfg.reader.decoder_seq_len, cfg.reader.seq_len
        for Lk in (Lr, 2 * Lr, 50 * Lr):
            got[f"{name} dec {Ld} {Lk}"] = flagship.decoder_stack_flops(
                Ld, Lk, t5.hidden_size, t5.ffn_size, t5.num_layers)
    assert got == want
    # a B=8 flagship step, the figure PERF.md states
    assert round(got["flagship step 8 50"] / 1e12, 1) == 237.5


def test_peak_table_has_only_the_card():
    assert set(flagship.PEAK_OPS_PER_S) == {"NVIDIA H100 80GB HBM3"}
    assert flagship.peak_flops(torch.device("cpu")) is None
    assert flagship.share_of_peak(1e12, 1.0, None) is None


def test_a_kernels_bound_is_the_slower_of_its_bytes_and_its_operations(
        monkeypatch):
    """``bound_ms``: max(bytes / the memory rate, operations / the peak of
    their type) on a card in both tables, nothing elsewhere."""
    assert set(flagship.MEMORY_BYTES_PER_S) == set(flagship.PEAK_OPS_PER_S)
    assert flagship.bound_ms(1e9, 1e12, torch.device("cpu")) == (None, None)
    monkeypatch.setattr(flagship, "device_kind",
                        lambda device: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(flagship, "peak_flops",
                        lambda device, op_type="bf16":
                        flagship.PEAK_OPS_PER_S["NVIDIA H100 80GB HBM3"][
                            op_type])
    card = torch.device("cuda", 0)
    ms, by = flagship.bound_ms(3.35e9, 0, card)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = flagship.bound_ms(1.0, 1979e9, card, "int8")
    assert by == "operations" and abs(ms - 1.0) < 1e-12


def test_the_smokes_recorder_keeps_each_launchs_work_and_puts_it_back():
    """``chip_smoke.recorded_launches`` stands in for the attention kernels'
    launch functions while its block runs: each call is kept with its bytes
    (each input read once, each output written once) and its operations;
    attributes pass through to the function (its counters); after the
    block the functions are the module's own again. On the CPU route no
    launch is counted."""
    import chip_smoke
    from emdr2_tpu_torch.ops import fid_attention as fa
    B, L, nh, H = 2, 16, 2, 128
    qkv = torch.randn(B, L, 3 * H, requires_grad=True)
    bias = torch.zeros(B, L)
    backward, launches = fa.flash_self_attention_backward, \
        fa.flash_self_attention_backward.launches
    calls = []
    with chip_smoke.recorded_launches(calls):
        assert fa.flash_self_attention_backward is not backward
        fa.flash_self_attention_backward.launches = launches + 7
        assert backward.launches == launches + 7
        backward.launches = launches
        fa.flash_self_attention(qkv, bias, nh, 5, 0.1).sum().backward()
    assert fa.flash_self_attention_backward is backward
    # fp32: qkv, the bias and out forward; qkv, the bias, out, dout and
    # dqkv backward (the CPU route keeps no statistics)
    assert calls == [
        ("flash_self_attention", 0, B * L * (3 * H + 1 + H) * 4,
         4 * B * L * L * H, "bf16"),
        ("flash_self_attention_backward", 0,
         B * L * (3 * H + 1 + H + H + 3 * H) * 4, 2.5 * 4 * B * L * L * H,
         "bf16")]


# ---- each tool's JSON keys are the JAX tool's ----------------------------

def _jax_source(tool):
    with open(os.path.join(REPO, "emdr2_tpu", "tools", tool + ".py")) as f:
        return f.read()


def _keys_of(tool, keys):
    """``keys``, each checked to appear quoted in the JAX tool's source."""
    src = _jax_source(tool)
    for k in keys:
        assert re.search(r"[\"']" + re.escape(k) + r"[\"']", src), (tool, k)
    return set(keys)


def _check_rescore(tiny):
    from emdr2_tpu_torch.tools import bench_mips_rescore as t
    _, rows = _run(t.main, ["--iters", "1", "--nq", "8"])
    want = _keys_of(t.__name__.rsplit(".", 1)[1], (
        "k", "window_select", "recall_vs_exact_fp32_over_stored",
        "qps_per_chip", "n_rows"))
    assert [(r["k"], r["window_select"]) for r in rows] == [
        (20, "blocked"), (20, "exact_topk"), (51, "blocked"),
        (51, "exact_topk")]
    assert all(set(r) == want for r in rows)


def _check_kernel_sweep(tiny):
    from emdr2_tpu_torch.tools import bench_kernel_sweep as t
    # chunk 1600 does not divide 2 x 512 keys (skipped, as in JAX); -256
    # does, and the kernel's check refuses it: a row with the error
    _, rows = _run(t.main, ["--iters", "1", "--batch", "1", "--topk", "2",
                            "--chunks", "256", "512", "1600", "-256"])
    name = "bench_kernel_sweep"
    assert [r.get("key_chunk") for r in rows] == [256, 512, -256, None]
    assert set(rows[0]) == set(rows[1]) == _keys_of(
        name, ("kernel", "key_chunk", "fwd_bwd_ms"))
    assert set(rows[2]) == _keys_of(name, ("kernel", "key_chunk", "error"))
    assert "key_chunk" in rows[2]["error"]
    assert set(rows[3]) == _keys_of(name, ("kernel", "shape", "fwd_bwd_ms"))
    assert rows[3]["shape"] == "2x512x12h"


def _check_step_breakdown(tiny):
    from emdr2_tpu_torch.tools import bench_step_breakdown as t
    out, rows = _run(t.main, ["--iters", "1", "--batch", "2", "--topk",
                              "2"])
    name = "bench_step_breakdown"
    assert rows == [out]
    assert set(out) == _keys_of(name, ("device", "B", "K", "breakdown"))
    parts = ("retriever_fwdbwd", "reader_fwdbwd", "teacher_fwd", "optimizer")
    assert set(out["breakdown"]) == _keys_of(
        name, parts + ("full_step", "sum_of_parts_ms"))
    for p in parts:
        assert set(out["breakdown"][p]) == _keys_of(
            name, ("ms", "model_tflops", "util_vs_peak"))
        assert out["breakdown"][p]["util_vs_peak"] is None   # no card
    assert set(out["breakdown"]["full_step"]) == {"ms"}
    assert out["device"] == "cpu"


def _check_dropout(tiny):
    from emdr2_tpu_torch.tools import bench_dropout_breakdown as t
    _, rows = _run(t.main, ["--iters", "1"])
    assert [r["variant"] for r in rows] == ["base", "hid0", "att0", "det"]
    want = _keys_of("bench_dropout_breakdown", (
        "variant", "hidden_dropout", "attention_dropout", "hash",
        "compile_s", "ms_per_step"))
    assert all(set(r) == want and r["hash"] == "k0" for r in rows)
    assert [(r["hidden_dropout"], r["attention_dropout"]) for r in rows] == [
        (0.1, 0.1), (0.0, 0.1), (0.1, 0.0), (0.0, 0.0)]


def _check_train_sweep(tiny):
    from emdr2_tpu_torch.tools import bench_train_sweep as t
    _, rows = _run(t.main, ["--bs", "2", "--policies", "towers,full",
                            "--residency", "int8,none,bf16", "--iters", "1"])
    assert [(r["policy"], r["residency"]) for r in rows] == [
        (p, r) for p in ("towers", "full") for r in ("int8", "none", "bf16")]
    want = _keys_of("bench_train_sweep", (
        "B", "policy", "residency", "compile_s", "ms_per_step",
        "examples_per_sec_per_chip", "model_flops_util", "device"))
    assert all(set(r) == want and r["model_flops_util"] is None
               for r in rows)


def _check_pipeline(tiny):
    from emdr2_tpu_torch.tools import bench_pipeline as t
    name = "bench_pipeline"
    common = ["--iters", "1", "--batch", "2", "--topk", "4", "--n-docs",
              "2048"]
    out, rows = _run(t.main, common + ["--decode"])
    assert rows == [out]
    assert set(out) == _keys_of(name, (
        "n_docs", "batch", "topk", "stage_a_retrieve_ms",
        "stage_b_postprocess_ms", "world_setup_s", "decode"))
    assert set(out["decode"]) == _keys_of(name, (
        "decode_ms_per_batch", "questions_per_sec_per_chip",
        "beam5_ms_per_batch", "beam5_vs_greedy"))
    out, _ = _run(t.main, common + ["--overlap", "--refresh", "--embed",
                                    "--embed-batch", "64"])
    assert set(out) == _keys_of(name, (
        "n_docs", "batch", "topk", "world_setup_s", "overlap", "refresh",
        "embed"))
    assert set(out["overlap"]) == _keys_of(name, (
        "step_ms", "serial_iter_ms", "overlap_iter_ms",
        "overlap_overhead_ms"))
    assert set(out["refresh"]) == _keys_of(name, (
        "rows", "update_host_ms", "swap_device_ms"))
    assert set(out["embed"]) == _keys_of(name, (
        "batch_size", "n_docs", "mesh_devices", "passages_per_sec_per_chip",
        "ms_per_batch", "shard_1p31M_refresh_s", "full_21M_8chip_refresh_s"))
    out, _ = _run(t.main, common + ["--decode-sweep"])
    assert set(out) == _keys_of(name, ("topk", "decode_sweep"))
    assert list(out["decode_sweep"]) == [
        "B4", "B4_kvint8", "B8_bf16params", "B8_bf16params_kvint8",
        "B16_bf16params_kvint8", "B32_bf16params_kvint8"]
    for row in out["decode_sweep"].values():
        assert set(row) == _keys_of(name, (
            "decode_ms_per_batch", "questions_per_sec_per_chip",
            "encode_ms", "token_loop_ms", "encode_model_tflops",
            "encode_mfu"))


_CHECKS = {"bench_mips_rescore": _check_rescore,
           "bench_kernel_sweep": _check_kernel_sweep,
           "bench_step_breakdown": _check_step_breakdown,
           "bench_dropout_breakdown": _check_dropout,
           "bench_train_sweep": _check_train_sweep,
           "bench_pipeline": _check_pipeline}


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_rows_have_the_jax_tools_keys(tiny, tool):
    _CHECKS[tool](tiny)


# ---- out-of-memory rows, dead row processes, --skip-done -----------------

def test_train_sweep_records_out_of_memory_and_resumes(tiny, monkeypatch):
    from emdr2_tpu_torch.tools import bench_train_sweep as t
    make = flagship.make_flagship_step

    def oom_above_two(B, *a, **kw):
        if B > 2:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return make(B, *a, **kw)
    monkeypatch.setattr(flagship, "make_flagship_step", oom_above_two)
    out = str(tiny / "sweep.jsonl")
    argv = ["--policies", "full", "--residency", "none", "--iters", "1",
            "--out", out]
    _, rows = _run(t.main, argv + ["--bs", "2,3"])
    assert "ms_per_step" in rows[0]
    assert rows[1]["error"].startswith("OutOfMemoryError: CUDA out of memory")
    assert flagship.read_rows(out) == rows

    # a row process that dies leaves an error row; --skip-done skips the
    # rows --out holds (done or failed) and runs the rest
    def died(module, args):
        return None, "rc=-9: ['Killed']"
    monkeypatch.setattr(flagship, "child_row", died)
    _, more = _run(t.main, argv + ["--bs", "2,3,4", "--skip-done"])
    assert [r["B"] for r in more] == [4]
    assert more[0]["error"] == "row process died rc=-9: ['Killed']"
    assert flagship.read_rows(out) == rows + more


def test_dropout_breakdown_skip_done_resumes(tiny):
    from emdr2_tpu_torch.tools import bench_dropout_breakdown as t
    out = str(tiny / "dropout.jsonl")
    _, first = _run(t.main, ["--variants", "base", "--iters", "1", "--out",
                             out])
    _, second = _run(t.main, ["--variants", "base,det", "--iters", "1",
                              "--out", out, "--skip-done"])
    assert [r["variant"] for r in second] == ["det"]
    assert [r["variant"] for r in flagship.read_rows(out)] == ["base", "det"]
    # without --skip-done every variant runs again; without --out nothing
    # is written
    _, third = _run(t.main, ["--variants", "base", "--iters", "1"])
    assert [r["variant"] for r in third] == ["base"]
    assert len(flagship.read_rows(out)) == 2


# ---- against the JAX functions -------------------------------------------

def test_rescore_recall_equals_jax_mips_topk(tiny):
    """The tool's recall of the default window at k 20 and 51 equals the
    JAX ``mips_topk``'s on the same numpy rows, scales and queries, against
    an exact float64 search over the stored rows."""
    import jax.numpy as jnp

    from emdr2_tpu.ops import mips as jax_mips
    from emdr2_tpu_torch.tools import bench_mips_rescore as t
    nq = 32
    result, _ = _run(t.main, ["--iters", "1", "--nq", str(nq)])
    icfg = tiny_config().index
    q, q8, scales = (x.numpy() for x in result[0]["inputs"])
    stored = q8.astype(np.float64) * np.repeat(
        scales.astype(np.float64), icfg.group_size)[:, None]
    exact = q.astype(np.float64) @ stored.T
    for r in result:
        if r["row"]["window_select"] != "blocked":
            continue
        k = r["row"]["k"]
        ref = np.argsort(-exact, axis=1, kind="stable")[:, :k]
        _, ids = jax_mips.mips_topk(
            jnp.asarray(q), jnp.asarray(q8), k, chunk_rows=icfg.chunk_rows,
            group_size=icfg.group_size,
            cands_per_group=icfg.cands_per_group,
            shard_scales=jnp.asarray(scales), query_tile=8, interpret=True)
        jax_recall = t.recall(np.asarray(ids), ref)
        assert r["row"]["recall_vs_exact_fp32_over_stored"] == round(
            jax_recall, 6), k


def test_step_breakdown_passes_equal_jax_methods(tiny):
    """The retriever's, reader's and teacher's pass values at fp32 tiny
    size, no dropout, equal the JAX model methods' (the tool's passes) on
    the same converted weights and the tool's batch, within 1e-5."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from emdr2_tpu.config import tiny_config as jax_tiny_config
    from emdr2_tpu.data import masks as jax_masks
    from emdr2_tpu.models import EMDR2Batch as JaxBatch
    from emdr2_tpu.models import EMDR2Model as JaxModel
    from emdr2_tpu_torch.convert import params_from_jax
    from emdr2_tpu_torch.tools import bench_step_breakdown as t

    _, state, batch = flagship.make_flagship_step(2, 2, device="cpu")
    jcfg = jax_tiny_config()
    flash = {"fid_flash_attention": True}
    jcfg = jcfg.replace(
        retriever=dataclasses.replace(jcfg.retriever, encoder=dataclasses.replace(
            jcfg.retriever.encoder, **flash)),
        reader=dataclasses.replace(jcfg.reader, transformer=dataclasses.replace(
            jcfg.reader.transformer, **flash)),
        index=dataclasses.replace(jcfg.index, topk=2))
    jbatch = JaxBatch(*[jnp.asarray(x.numpy()) for x in batch])
    jmodel = JaxModel(jcfg)
    params = nn.meta.unbox(jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(2)}, jbatch)["params"])
    state.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)

    @jax.jit
    def jax_passes(p):
        v = {"params": p}
        ret = jnp.sum(jmodel.apply(v, jbatch, method=JaxModel._topk_log_probs,
                                   deterministic=True))
        hidden, flat = jmodel.apply(v, jbatch.reader_ids, True,
                                    method=JaxModel._fid_encode)
        m = jax_masks.attention_mask(jbatch.dec_ids, flat)
        logits = jmodel.apply(v, method=lambda s: s.reader.decode(
            jbatch.dec_ids, hidden, m, True))
        reader = jnp.sum(logits.astype(jnp.float32) * 1e-9)
        teacher = jmodel.apply(v, jbatch, True,
                               method=JaxModel._teacher_gold_log_probs)
        return {"retriever_fwdbwd": ret, "reader_fwdbwd": reader,
                "teacher_fwd": teacher}

    want = jax_passes(params)
    got = {name: fn() for name, fn in t.passes(state.model, batch).items()}
    assert set(got) == set(want)
    # the reader's value is 1e-9 x the sum of its B x Ld x V logits: each
    # logit held to 1e-5
    n_logits = 2 * tiny_config().reader.decoder_seq_len * \
        tiny_config().reader.transformer.vocab_size
    atol = {"reader_fwdbwd": 1e-5 * n_logits * 1e-9}
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=atol.get(name, 1e-5),
                                   err_msg=name)
    assert got["teacher_fwd"].shape == (2, 2, tiny_config().reader
                                        .decoder_seq_len)
