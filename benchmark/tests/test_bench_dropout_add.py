"""The dropout-add readers on a synthetic record: counts per step over
the run's steps, the roofline share from the counted bytes, and nothing to
read from a program without the kernel."""

import importlib.util
import sys
import types
from pathlib import Path

import pytest

from benchmark.counts import flops

HERE = Path(__file__).resolve().parent.parent
MODULE = "emdr2_tpu_torch.ops.dropout_add"


def _reader(name):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _record():
    return {"units": 14, "traffic": {"check_steps": 2, "stage_steps": 4},
            "peak": flops.PEAKS["NVIDIA H100 80GB HBM3"],
            "kernel_s": {"void (anonymous namespace)::dropout_add_vec_kernel"
                         "<__nv_bfloat16, true>(...)": 0.5, "gemm": 3.0}}


def test_readers_count_per_step_and_take_the_kernels_time(monkeypatch):
    fwd = lambda: None                                        # noqa: E731
    bwd = lambda: None                                        # noqa: E731
    fwd.launches, fwd.bytes, bwd.bytes = 20 * 270, 20 * 1e11, 20 * 4e10
    fake = types.SimpleNamespace(dropout_add=fwd, dropout_add_backward=bwd)
    monkeypatch.setitem(sys.modules, MODULE, fake)
    rec = _record()
    assert _reader("dropout_add_launches.train")(rec) == pytest.approx(270)
    want = 100 * 14 * 1.4e11 / 3.35e12 / 0.5
    assert _reader("dropout_add_roofline.train")(rec) == pytest.approx(want)
    rec["kernel_s"] = {"gemm": 3.0}
    assert _reader("dropout_add_roofline.train")(rec) is None


def test_a_program_without_the_kernel_gives_nothing(monkeypatch):
    monkeypatch.delitem(sys.modules, MODULE, raising=False)
    rec = _record()
    assert _reader("dropout_add_launches.train")(rec) is None
    assert _reader("dropout_add_roofline.train")(rec) is None
