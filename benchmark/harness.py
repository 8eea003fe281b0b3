"""The benchmark's general part: it reads ``BENCHMARK.json``, finds a cell's
configuration, traffic, driver, limits and per-layer readers by their
names, runs the cell and prints the one result line.

A run: check the card; make the inputs and weights from the seed and let
the cell's driver module set up and warm up (its check steps are part of
that); measure whole units of work (a train step, a partition of passages)
until ``--seconds`` have passed, under the profiler when ``--trace 1``;
read the peak memory; let the cell's driver module keep what its check
needs and release the program's state, then compare what the program
produced with the plain reference; refuse the run if JAX or the JAX
package was loaded by then; print each number compared beside its limit
on standard error and the result line on standard output.

Files of a cell: ``configs/<config>.json``, ``workloads/<traffic>.json``
(names its driver), ``drivers/<driver>.py`` (a class ``Driver``),
``limits/<cell>.json``, ``layer_metrics/<metric>.py`` (``read(record)``),
``counts/<metric>.json`` where a reader needs kernel names. A new cell,
configuration or metric is new files and manifest entries.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "emdr2_tpu")


class Refused(RuntimeError):
    """The run cannot give a result (no card, a missing file, JAX loaded)."""


def load_module(path: Path, name: str):
    if not path.is_file():
        raise Refused(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


class Run:
    """Everything a driver needs to know of the run."""

    def __init__(self, manifest: dict, cell_name: str, seed: int,
                 seconds: float, trace: bool, device: str = "cuda",
                 overrides: Optional[dict] = None):
        cells = {c["name"]: c for c in manifest["workloads"]}
        if cell_name not in cells:
            raise Refused(f"no cell {cell_name!r} in BENCHMARK.json")
        self.manifest = manifest
        self.cell = cells[cell_name]
        overrides = overrides or {}
        self.config = overrides.get("config") or read_json(
            HERE / "configs" / f"{self.cell['config']}.json")
        self.traffic = overrides.get("traffic") or read_json(
            HERE / "workloads" / f"{self.cell['traffic']}.json")
        self.limits = read_json(HERE / "limits" / f"{cell_name}.json")
        self.faults = overrides.get("faults", {})
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.workdir = tempfile.mkdtemp(prefix=f"bench_{cell_name}_")
        self.build_s = 0.0

    def streams(self, n: int) -> List[int]:
        from benchmark.world import streams
        return streams(self.seed, n)

    def close(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def check_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA card: this benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} are visible")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------- the trace

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_timeline(kernels, t0: float, t1: float):
    """(busy seconds, idle gaps [(start, end)]) of the device between t0
    and t1 (microseconds) from its operations [(name, start, end)]."""
    busy = _merge((max(s, t0), min(e, t1)) for _, s, e in kernels
                  if e > t0 and s < t1)
    total = sum(e - s for s, e in busy) / 1e6
    gaps, at = [], t0
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1))
    return total, gaps


def label_gaps(gaps, kernels, host_calls, top: int = 10):
    """What the host was doing in the device's idle gaps: the CUDA call
    running at the gap's start (a copy, a synchronize), else ``host, then
    <the operation the device ran next>``; seconds summed by label, the
    largest ``top``."""
    calls = sorted(host_calls, key=lambda o: o[1])
    starts = [o[1] for o in calls]
    after = sorted((s, name) for name, s, _ in kernels)
    kstarts = [s for s, _ in after]
    by: Dict[str, float] = {}
    for s, e in gaps:
        label = None
        i = bisect.bisect_right(starts, s)
        for name, cs, ce in calls[max(0, i - 50):i]:
            if cs <= s < ce:
                label = name
        if label is None:
            j = bisect.bisect_left(kstarts, e)
            label = "host, then " + (after[j][1][:80] if j < len(after)
                                     else "the window's end")
        by[label] = by.get(label, 0.0) + (e - s) / 1e6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def kernel_events(prof):
    """(device operations [(name, start_us, end_us)], the host's CUDA
    calls likewise) of a finished ``torch.profiler.profile``, read from
    its raw records (building the profiler's event tree takes minutes)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            continue
        start = ev.start_ns() / 1e3
        span = (ev.name(), start, start + ev.duration_ns() / 1e3)
        (dev if ev.device_type() == DeviceType.CUDA else host).append(span)
    return dev, host


# -------------------------------------------------------------------- a run

def metric_entries(manifest: dict, cell: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it (every
    per-layer entry lists its cells)."""
    return [m for m in manifest["per_layer"] if cell in m["workloads"]]


def metric_entries_e2e(manifest: dict, cell: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest["end_to_end"]
            if m.get("workloads") is None or cell in m["workloads"]]


def execute(run: Run, require_card: bool = True,
            started: Optional[float] = None) -> dict:
    """Run the cell; returns the result line's object (not printed)."""
    started = time.perf_counter() if started is None else started
    if require_card:
        check_card(int(run.cell["chips"]))
    import torch
    sys.path.insert(0, str(ROOT))
    traffic = run.traffic
    driver_mod = load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                             f"bench_driver_{traffic['driver']}")
    cuda = run.device.startswith("cuda")
    if cuda:
        from emdr2_tpu_torch.ops import build
        run.build_s = build.build()["seconds"]
    driver = driver_mod.Driver(run)
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - started

    prof = None
    if run.trace:
        # the card's operations and the host's CUDA calls, not every host
        # operation: recording those would slow the window down
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])
        prof.__enter__()
    units = attempted = failed = 0
    unit_s = []
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()            # the traced window's first call
    while True:
        t_unit = time.perf_counter()
        done, ok = driver.unit()
        unit_s.append(time.perf_counter() - t_unit)
        units += done
        attempted += done
        failed += 0 if ok else done
        if time.perf_counter() - t0 >= run.seconds:
            break
    if cuda:
        torch.cuda.synchronize()            # and its last
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    memory_peak = max(setup_peak, window_peak) if cuda else 0

    manifest = run.manifest
    metrics: Dict[str, dict] = {}
    breakdown = None
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(memory_peak)}
    if run.trace:
        dev_ops, host_ops = kernel_events(prof)
        prof = None
        if not host_ops:
            raise Refused("the profiler recorded no host call")
        span = (min(s_ for _, s_, _ in host_ops),
                max(e_ for _, _, e_ in host_ops))
        busy_s, gaps = device_timeline(dev_ops, *span)
        traced_s = (span[1] - span[0]) / 1e6
        device.update(busy_s=busy_s, window_s=traced_s)
        by_name: Dict[str, float] = {}
        for name, s, e in dev_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        breakdown = {
            "device_ops": sorted(([k, v] for k, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": label_gaps(gaps, dev_ops, host_ops)}
        record = {"units": units, "window_s": window_s,
                  "traced_s": traced_s, "busy_s": busy_s,
                  "kernel_s": by_name, "peak_bytes": window_peak,
                  "peak": _peak(device["kind"]), "config": run.config,
                  "traffic": traffic}
        record.update(driver.record())
        for m in metric_entries(manifest, run.cell["name"]):
            reader = load_module(HERE / "layer_metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(units, window_s)
        e2e["setup_s"] = setup_s
        for m in metric_entries_e2e(manifest, run.cell["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check()
    check_s = time.perf_counter() - t_check
    # after the window and the check alike: what either loaded
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package are loaded: "
                      f"{found}")
    correct = all(_within(v, lim) for _, v, lim in checks) and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["build_s"] = run.build_s
    result["unit_s"] = unit_s
    result["check_s"] = check_s
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def _within(value, limit) -> bool:
    return value is not None and math.isfinite(value) and value <= limit


def _peak(kind: str) -> Optional[dict]:
    from benchmark.counts.flops import PEAKS
    return PEAKS.get(kind)


def main(argv=None, started: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run = None
    try:
        manifest = read_json(ROOT / "BENCHMARK.json")
        run = Run(manifest, args.workload, args.seed, args.seconds,
                  bool(args.trace))
        result = execute(run, started=started)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    finally:
        if run is not None:
            run.close()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
