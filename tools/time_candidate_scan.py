#!/usr/bin/env python3
"""Time the MIPS candidate scan (K3) of one source tree on the card.

    python3 tools/time_candidate_scan.py [--tree DIR] [--nq 8 64 512 3610]
        [--dtypes bf16 int8] [--probe-loads]

``DIR`` is the root of a checkout that holds ``emdr2_tpu_torch`` (default:
the one this file lies in); its ``ops.mips`` is imported and its kernels
are built there. Over a 1,310,720 x 768 index (rows past 1,309,720 masked)
each query count is timed with CUDA events (median of 10 after 2 warm-up
calls): the dispatch (``candidate_scan``) and each kernel forced
(``_launch(..., route)``), each held first to the plain version on its
first 64 queries (int8 equal, bf16 within 1e-3 |v| + 1e-3).

- ``--probe-loads``: the staging of the first tensor-core scan alone (its
  three-stage cp.async ring of 128-query tiles and 128-row groups, 256
  threads, two blocks a multiprocessor, no products, no top-2), compiled
  from the source in this file, at each query count above 64: what that
  kernel's traffic from L2 into shared memory costs by itself.

To compare two commits, unpack the other one with ``git archive`` into a
directory and run this script once a tree, on one card, in the order
parent, change, change, parent: a process imports one tree only. Needs a
CUDA device. Prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

SEED = 1234
N_INDEX = 1_310_720
D = 768

PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int G = 128, THREADS = 256, KB = 128, LD = KB + 16, STAGES = 3;

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

template <int QT>
__global__ void __launch_bounds__(THREADS, 2)
    probe_kernel(const uint8_t* q, const uint8_t* x, float* out, int nq,
                 int rb) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int STAGE = (QT + G) * LD;
  const int n_tiles = (nq + QT - 1) / QT;
  const int q0 = (int)(blockIdx.x % n_tiles) * QT;
  const uint8_t* xs = x + (size_t)(blockIdx.x / n_tiles) * G * rb;
  const int nk = rb / KB;
  auto load = [&](int s, int kc) {
    for (int i = threadIdx.x; i < (QT + G) * (KB / 16); i += THREADS) {
      const int r = i / (KB / 16), c = (i % (KB / 16)) * 16;
      const uint8_t* src;
      bool ok = true;
      if (r < QT) {
        ok = q0 + r < nq;
        src = q + (size_t)(ok ? q0 + r : 0) * rb;
      } else {
        src = xs + (size_t)(r - QT) * rb;
      }
      cp16(smem + s * STAGE + r * LD + c, src + (size_t)kc * KB + c, ok);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float acc = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const int nxt = kc + STAGES - 1;
    if (nxt < nk) load(nxt % STAGES, nxt);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    acc += (float)smem[(kc % STAGES) * STAGE + threadIdx.x];
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

extern "C" int probe_loads(const void* q, const void* x, void* out, int nq,
                           int N, int rb, void* stream) {
  constexpr int QT = 128;
  const int smem = STAGES * (QT + G) * LD;
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((nq + QT - 1) / QT) * (N / G));
  probe_kernel<QT><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const uint8_t*)x, (float*)out, nq, rb);
  return (int)cudaGetLastError();
}
"""


def time_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_probe(tree):
    """The probe's shared library, built by nvcc into the tree's build
    directory."""
    from emdr2_tpu_torch.ops import build
    out_dir = os.path.join(tree, "emdr2_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "k3_probe_loads.cu")
    lib = os.path.join(out_dir, "k3_probe_loads.so")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
                    src], check=True)
    probe = ctypes.CDLL(lib)
    probe.probe_loads.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    probe.probe_loads.restype = ctypes.c_int
    return probe


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=here)
    ap.add_argument("--nq", type=int, nargs="+", default=[8, 64, 512, 3610])
    ap.add_argument("--dtypes", nargs="+", default=["bf16", "int8"])
    ap.add_argument("--probe-loads", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_candidate_scan: needs a CUDA device")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from emdr2_tpu_torch.ops import mips

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n_valid = N_INDEX - 1000
    emb = torch.randn(N_INDEX, D, device=dev, generator=gen)
    emb[n_valid:] = 0.0
    stored = {"bf16": emb.to(torch.bfloat16),
              "int8": mips.quantize_int8(emb, 128)[0]}
    del emb
    probe = build_probe(tree) if args.probe_loads else None
    rows = []
    for name in args.dtypes:
        index = stored[name]
        for nq in args.nq:
            qf = torch.randn(nq, D, device=dev, generator=gen)
            if name == "bf16":
                q = qf.to(torch.bfloat16)
            else:
                qs = qf.abs().amax(dim=1).clamp(min=1e-30) / 127.0
                q = torch.clamp(torch.round(qf / qs[:, None]), -127,
                                127).to(torch.int8)
            want = mips.candidate_scan_reference(q[:64], index, n_valid, 128,
                                                 2)
            calls = {"dispatch": lambda: mips.candidate_scan(
                q, index, n_valid, 128, 2)}
            # the CUDA-core kernel takes about 0.2 ms a query above 32
            for route in (("cuda_core", "tensor_core") if nq <= 512
                          else ("tensor_core",)):
                calls[route] = (lambda r=route: mips._launch(
                    q, index, n_valid, 128, 2, r))
            row = {"dtype": name, "nq": nq}
            for what, fn in calls.items():
                v, i = fn()
                torch.cuda.synchronize()
                v, i = v[:64], i[:64]
                if name == "int8":
                    ok = torch.equal(v, want[0]) and torch.equal(i, want[1])
                else:
                    ok = bool(((v - want[0]).abs()
                               <= 1e-3 * want[0].abs() + 1e-3).all())
                del v, i
                row[what] = time_ms(fn) if ok else "disagrees"
                print(f"{name} nq={nq} {what}: {row[what]}", flush=True)
            if probe is not None and nq > 64:
                out = torch.empty(((nq + 127) // 128) * (N_INDEX // 128),
                                  device=dev)
                rb = D * index.element_size()
                stream = torch.cuda.current_stream().cuda_stream

                def run_probe():
                    err = probe.probe_loads(q.data_ptr(), index.data_ptr(),
                                            out.data_ptr(), nq, N_INDEX, rb,
                                            stream)
                    if err:
                        raise RuntimeError(f"probe launch failed: {err}")
                row["probe_loads"] = time_ms(run_probe)
                row["probe_staged_bytes"] = (
                    ((nq + 127) // 128) * (N_INDEX // 128) * (128 + 128) * rb)
                print(f"{name} nq={nq} probe: {row['probe_loads']}",
                      flush=True)
            rows.append(row)
    print(json.dumps({"tree": tree, "card": card, "index": [N_INDEX, D],
                      "rows": rows}))


if __name__ == "__main__":
    main()
