"""Whole runs of ``openqa-dp4`` on the CPU at tiny sizes: four ranks over
gloo, each a process, the look for cards skipped. A sound run comes out
correct; a run whose exchange between ranks is left out underneath, in
every rank, comes out not correct: the gradient kept on each rank without
its all-reduce, or each rank's own top k kept without
``sharded_mips_topk``'s all-gathers and merge."""

import pytest

from benchmark.tests import tiny_dp


def _failed(result):
    return sorted(n for n, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("trace", [False, True])
def test_sound_dp4_run_is_correct(trace):
    r = tiny_dp.run(tiny_dp.openqa_dp(), trace=trace, seconds=0.2)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    if trace:
        assert {"retrieve_ms.dp4", "allreduce_ms.dp4",
                "fwd_bwd_ms.dp4"} <= set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"train_step_ms", "setup_s"}


@pytest.mark.parametrize("fault,caught_by", [
    ("no_all_reduce", "grad_norm_gap"),
    ("local_topk", "retrieval_gap"),
])
def test_an_exchange_left_out_is_not_correct(fault, caught_by):
    r = tiny_dp.run(tiny_dp.openqa_dp(), fault=fault)
    assert not r["correct"]
    assert caught_by in _failed(r), r["checks"]
