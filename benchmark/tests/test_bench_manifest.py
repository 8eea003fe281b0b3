"""``BENCHMARK.json`` against the benchmark's files and the contract's
rules of form; the trace arithmetic on a synthetic trace; a run without a
card; the import guard."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cell", [c["name"] for c in MANIFEST["workloads"]])
def test_cell_resolves_by_name(cell):
    entry = next(c for c in MANIFEST["workloads"] if c["name"] == cell)
    config = next(c for c in MANIFEST["configs"]
                  if c["name"] == entry["config"])
    assert (ROOT / config["file"]).is_file()
    data = json.loads((ROOT / config["file"]).read_text())
    assert set(config["reduced"]) <= set(data)
    assert data["reduced"] == config["reduced"]
    for key in ("source", "deployment", "reduced", "assumed"):
        assert key in data
    traffic = json.loads((HERE / "workloads" / f"{entry['traffic']}.json")
                         .read_text())
    assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (HERE / "limits" / f"{cell}.json").is_file()
    for m in harness.metric_entries(MANIFEST, cell):
        assert (HERE / "layer_metrics" / f"{m['name']}.py").is_file()
    assert entry["chips"] in (1, 4)


def test_names_units_and_lines():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                    assert "\t" not in e[key]
    assert len(set(names)) == len(names)
    for c in MANIFEST["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
    for c in MANIFEST["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in (c["name"] for c in MANIFEST["workloads"]):
        reported = {m["name"] for m in harness.metric_entries_e2e(MANIFEST,
                                                                  cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.metric_entries(MANIFEST, cell)


def test_each_layer_metric_moves_what_its_cells_report():
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m.get("workloads"), m["name"]      # each lists its cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            reported = {e["name"] for e in
                        harness.metric_entries_e2e(MANIFEST, cell)}
            assert m["moves"] in reported, (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_are_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


# ---------------------------------------------------------------- the trace

def test_device_timeline_merges_and_clips():
    kernels = [("a", 10, 20), ("b", 15, 30), ("c", 50, 60), ("d", 95, 130)]
    busy, gaps = harness.device_timeline(kernels, 0, 100)
    assert busy == pytest.approx((20 + 10 + 5) / 1e6)
    assert gaps == [(0, 10), (30, 50), (60, 95)]


def test_idle_gaps_take_the_host_call_or_the_next_operation():
    kernels = [("k1", 10, 30), ("k2", 50, 60), ("k3", 80, 90)]
    calls = [("cudaLaunchKernel", 5, 9), ("cudaStreamSynchronize", 30, 45)]
    gaps = harness.device_timeline(kernels, 0, 100)[1]
    assert gaps == [(0, 10), (30, 50), (60, 80), (90, 100)]
    out = dict(harness.label_gaps(gaps, kernels, calls))
    assert out == pytest.approx({"host, then k1": 10e-6,
                                 "cudaStreamSynchronize": 20e-6,
                                 "host, then k3": 20e-6,
                                 "host, then the window's end": 10e-6})


def test_readers_on_a_synthetic_record():
    from benchmark.counts import flops
    from benchmark.layer_metrics import _common
    peak = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    calls = [(1e12, 1e6, 2)]                 # bound by operations
    rec = {"units": 4, "window_s": 2.0, "traced_s": 2.0, "busy_s": 1.5,
           "kernel_s": {"void flash_fwd_kernel<...>": 0.1, "gemm": 1.0},
           "peak_bytes": 3 * 2 ** 30, "peak": peak,
           "flops_per_unit": 98.9e12, "attention_per_unit": calls,
           "stage_ms": {"retrieve": [10.0, 14.0]}}
    assert _common.mfu(rec) == pytest.approx(20.0)
    assert _common.idle_share(rec) == pytest.approx(25.0)
    assert _common.peak_gib(rec) == pytest.approx(3.0)
    assert _common.stage_mean_ms(rec, "retrieve") == pytest.approx(12.0)
    assert _common.stage_mean_ms(rec, "optimizer") is None
    want = 100 * 4 * 2 * (1e12 / peak["bf16"]) / 0.1
    assert _common.roofline(rec, "attn_roofline.embed") == pytest.approx(want)
    rec["kernel_s"] = {"gemm": 1.0}
    assert _common.roofline(rec, "attn_roofline.embed") is None
    rec["peak"] = None
    assert _common.mfu(rec) is None


def test_attention_bound_of_the_fid_encoder():
    """K1's forward at the reader's [400, 512] is bound by its bytes: the
    kernel table's 1,259.1 MB, 0.3759 ms. Its backward moves the table's
    2,537.1 MB; the table's 805.3 GFLOP count the recompute of q k^T,
    the yardstick's four products (644.2 GFLOP) do not, so it is bound by
    its bytes, 0.7573 ms."""
    from benchmark.counts import flops
    peak = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    f, b = flops.self_attention_fwd(400, 512, 768, 12, False)
    assert flops.bound(b, f, peak) == (pytest.approx(0.3759e-3, rel=1e-3),
                                       "bytes")
    f, b = flops.self_attention_bwd(400, 512, 768, 12)
    assert flops.bound(b, f, peak) == (pytest.approx(0.7573e-3, rel=1e-3),
                                       "bytes")


# ------------------------------------------------------- refusals and guard

def test_a_run_without_a_card_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "evidence-embed", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "evidence-embed", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imports(HERE / path):
        assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)
        if path.startswith("reference/"):
            assert name.split(".")[0] != "emdr2_tpu_torch", (path, name)
            assert not name.startswith("benchmark.") or name.startswith(
                "benchmark.reference"), (path, name)


def test_the_guard_names_forbidden_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "emdr2_tpu_torch_extra", object())
    assert harness.forbidden_modules() == ["jaxlib"]


# --------------------------------------------------------- the yardstick

def test_frozen_flops_equal_the_ports_today():
    """The frozen copy of the FLOP formulas gives the port's
    ``tools/flagship.py`` counts at the cells' shapes (B=8, K=50)."""
    from emdr2_tpu_torch.config import EMDR2Config
    from emdr2_tpu_torch.tools import flagship
    from benchmark.counts import flops
    cfg = json.loads((HERE / "configs" / "emdr2-nq.json").read_text())
    want = flagship.model_flops_per_step(EMDR2Config(), 8, 50)
    got = flops.model_flops_per_step(cfg["retriever"], cfg["reader"], 8, 50,
                                     64, 256, 512, 32)
    assert got == want == sum(flagship.pass_flops(EMDR2Config(), 8,
                                                  50).values())
    assert got == pytest.approx(237.47e12, rel=1e-4)
    dpr = json.loads((HERE / "configs" / "dpr-nq.json").read_text())
    assert flops.embed_flops_per_passage(dpr["retriever"], 256) == \
        12 * flagship.layer_self_flops(256, 768, 3072)
    assert flops.PEAKS["NVIDIA H100 80GB HBM3"]["bf16"] == \
        flagship.PEAK_OPS_PER_S["NVIDIA H100 80GB HBM3"]["bf16"]
