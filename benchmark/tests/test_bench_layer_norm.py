"""The layer-norm readers on synthetic records: counts per step of a
training cell and per passage of the embedder's cell, the roofline share
from the counted bytes and the kernels' device time, and nothing to read
from a program without the kernels."""

import importlib.util
import sys
import types
from pathlib import Path

import pytest

from benchmark.counts import flops

HERE = Path(__file__).resolve().parent.parent
MODULE = "emdr2_tpu_torch.ops.layer_norm"
KERNEL = ("void (anonymous namespace)::layer_norm_fwd_kernel"
          "<__nv_bfloat16, 3, true>(...)")
BWD_KERNEL = ("void (anonymous namespace)::layer_norm_bwd_kernel"
              "<__nv_bfloat16, 3, true>(...)")


def _reader(name):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _train_record():
    return {"units": 14, "traffic": {"driver": "openqa_train",
                                     "check_steps": 2, "stage_steps": 4},
            "config": {"embed_batch": 128},
            "peak": flops.PEAKS["NVIDIA H100 80GB HBM3"],
            "kernel_s": {KERNEL: 0.3, BWD_KERNEL: 0.2, "gemm": 3.0,
                         "dropout_add_kernel": 1.0}}


def _embed_record():
    return {"units": 49152, "traffic": {"driver": "evidence_embed",
                                        "partition_rows": 16384},
            "config": {"embed_batch": 128},
            "peak": flops.PEAKS["NVIDIA H100 80GB HBM3"],
            "kernel_s": {KERNEL: 0.25, "gemm": 3.0}}


def _fake(monkeypatch, fwd_launches, fwd_bytes, bwd_bytes):
    fwd = lambda: None                                        # noqa: E731
    bwd = lambda: None                                        # noqa: E731
    fwd.launches, fwd.bytes = fwd_launches, fwd_bytes
    bwd.launches, bwd.bytes = 0, bwd_bytes
    monkeypatch.setitem(sys.modules, MODULE, types.SimpleNamespace(
        layer_norm=fwd, layer_norm_backward=bwd))


def test_training_readers_count_per_step_and_take_the_kernels_time(
        monkeypatch):
    _fake(monkeypatch, 20 * 259, 20 * 8e10, 20 * 5e10)
    rec = _train_record()
    assert _reader("layer_norm_launches.train")(rec) == pytest.approx(259)
    want = 100 * 14 * 1.3e11 / 3.35e12 / 0.5
    assert _reader("layer_norm_roofline.train")(rec) == pytest.approx(want)
    rec["kernel_s"] = {"gemm": 3.0}
    assert _reader("layer_norm_roofline.train")(rec) is None


def test_embed_reader_counts_per_passage_with_the_warm_up_batches(
        monkeypatch):
    """The counters also cover the set-up's two batches of 128 passages;
    the embedder runs no backward."""
    per_passage = 2.5e7
    _fake(monkeypatch, 0, (49152 + 256) * per_passage, 0)
    rec = _embed_record()
    want = 100 * 49152 * per_passage / 3.35e12 / 0.25
    assert _reader("layer_norm_roofline.embed")(rec) == pytest.approx(want)


def test_a_program_without_the_kernels_gives_nothing(monkeypatch):
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    for rec in (_train_record(), _embed_record()):
        assert _reader("layer_norm_launches.train")(rec) is None
        assert _reader("layer_norm_roofline.train")(rec) is None
        assert _reader("layer_norm_roofline.embed")(rec) is None
