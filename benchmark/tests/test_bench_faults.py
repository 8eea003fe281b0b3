"""Whole runs of the cells on the CPU at tiny sizes, with the look for a
card skipped: a sound run comes out correct, a run whose timed path is
broken underneath comes out not correct (each fault the cell can have),
and so does the control, the reference in lower precision put in the
program's place. One card has no exchange between chips to leave out."""

import pytest
import torch

from benchmark.tests import tiny


def _failed(result):
    return sorted(n for n, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("trace", [False, True])
def test_sound_openqa_run_is_correct(trace):
    r = tiny.run("openqa-b8", tiny.openqa(), trace=trace, seconds=0.2)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    if trace:
        assert {"retrieve_ms.train", "postprocess_ms.train",
                "fwd_bwd_ms.train", "optimizer_ms.train"} <= set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("trace", [False, True])
def test_sound_embed_run_is_correct(trace):
    r = tiny.run("evidence-embed", tiny.embed(), trace=trace, seconds=0.2)
    assert r["correct"], r["checks"]
    if not trace:
        assert set(r["metrics"]) == {"embed_passages_per_s", "setup_s"}


@pytest.mark.parametrize("fault,caught_by", [
    ("unchanged_state", "update_gap"),
    ("half_batch", "grad_norm_gap"),
    ("token_altered", "format_mismatches"),
    ("row_altered", "retrieval_gap"),
    ("unchanged_after_setup", "update_gap"),
])
def test_a_broken_openqa_step_is_not_correct(fault, caught_by):
    r = tiny.run("openqa-b8", tiny.openqa(), fault=fault)
    assert not r["correct"]
    assert caught_by in _failed(r), r["checks"]


def test_an_altered_embedding_is_not_correct():
    o = tiny.embed()
    o["traffic"]["check_rows"] = 10 ** 6          # every row the window made
    r = tiny.run("evidence-embed", o, fault="embedding_altered")
    assert not r["correct"] and _failed(r) == ["row_gap"]


def _driver(cell, overrides):
    from benchmark import harness
    manifest = harness.read_json(tiny.HERE.parent / "BENCHMARK.json")
    run = harness.Run(manifest, cell, 5, 0.0, False, device="cpu",
                      overrides=overrides)
    mod = harness.load_module(
        tiny.HERE / "drivers" / f"{run.traffic['driver']}.py",
        "bench_driver_" + run.traffic["driver"])
    return run, mod, mod.Driver(run)


def _openqa_control(mod, drv):
    """The numbers of the reference in float8 in the program's place,
    judged by the float32 reference that follows its selection."""
    from benchmark.reference import model
    drv.make_world()
    return mod.numbers(*mod.stand_in(drv, model.Numerics("fp8")))


def _embed_control(run, mod, drv, n):
    from benchmark.reference import model
    drv.make_world()
    docs = torch.randperm(run.config["num_passages"],
                          generator=torch.Generator().manual_seed(0))[:n] + 1
    return mod.stand_in_gap(drv, docs.numpy(), model.Numerics("fp8"))


def _tiny_control(cell: str):
    o = tiny.openqa() if cell == "openqa-b8" else tiny.embed()
    run, mod, drv = _driver(cell, o)
    try:
        if cell == "openqa-b8":
            return _openqa_control(mod, drv)
        return _embed_control(run, mod, drv, 64)
    finally:
        run.close()


def test_the_control_reads_far_above_the_program_openqa():
    """At the tiny size the limits, set at the cell's size, do not apply;
    what must hold here is the separation they rest on: the control reads
    ten times the sound program's gaps or more."""
    sound = tiny.run("openqa-b8", tiny.openqa(), seed=5)["checks"]
    ctrl = _tiny_control("openqa-b8")
    assert any(ctrl[n] > 10 * sound[n]["value"] + 1e-6
               for n in ("retrieval_gap", "grad_gap", "update_gap")), (ctrl,
                                                                      sound)


def test_the_control_reads_far_above_the_program_embed():
    sound = tiny.run("evidence-embed", tiny.embed(), seed=5)["checks"]
    ctrl = _tiny_control("evidence-embed")
    assert ctrl > 10 * sound["row_gap"]["value"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["openqa-b8", "evidence-embed"])
def test_the_control_fails_at_the_cells_size(cell):
    """On the card, at the cell's own size: the control comes out not
    correct against the committed limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    from benchmark import harness
    from benchmark.reference import model
    manifest = harness.read_json(tiny.HERE.parent / "BENCHMARK.json")
    run = harness.Run(manifest, cell, 4200000001, 0.0, False)
    mod = harness.load_module(
        tiny.HERE / "drivers" / f"{run.traffic['driver']}.py",
        "bench_driver_" + run.traffic["driver"])
    drv = mod.Driver(run)
    model.strict_float32()
    try:
        if cell == "openqa-b8":
            got = _openqa_control(mod, drv)
            assert any(got[n] > run.limits[n] for n in got), got
        else:
            gap = _embed_control(run, mod, drv,
                                 int(run.traffic["check_rows"]))
            assert gap > run.limits["row_gap"]
    finally:
        run.close()


@pytest.mark.parametrize("cell,overrides", [("openqa-b8", tiny.openqa),
                                            ("evidence-embed", tiny.embed)])
def test_jax_loaded_by_the_check_refuses_the_run(cell, overrides):
    """A module of JAX that only the check loads still leaves the run
    with no result line."""
    r = tiny.run_raw(cell, overrides(), fault="jax_in_check")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "jax" in r.stderr
