#!/usr/bin/env python3
"""Place the hash kernels' crossover on one GPU: one thread a lane against
a group of ``kCoop`` threads a lane, over widths.

    python tools/hash_lane_threads_torch.py [--widths 1,2,4,...,131072]
                                            [--reps 5] [--refine 5]
                                            [--out FILE.json]

The ``csrc/poseidon_bn254.cu`` source is built with two more C entry
points, ``bench_hash2`` and ``bench_hash3``, which launch
``hash2_kernel<threads>`` / ``hash3_kernel<threads>`` at the threads a
lane the caller names (a generated source that includes the package's, into
``imt_tpu_torch/build/lane_threads/``).  Both kernels of both hashes are
held bit for bit against the plain version at a few widths (the package's
crossover and its neighbours among them) with edge values in the first
lanes; then each is timed at each width (CUDA events, the best of `reps`
single calls, the two kernels in turns) beside the package's own entry
points, and the crossover is bisected `refine` times between the last
power of two where hash2's cooperative kernel is faster and the next.  The
tool prints, and writes as JSON to `--out`: the times, the measured and the
package's crossover in lanes and in lanes an SM, each kernel's registers
and spill bytes (ptxas), and the card's name and power limit.  Needs a
CUDA device and nvcc, and refuses to run without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COOP = 4
BENCH_SOURCE = r"""
#include "%s"

extern "C" {

int bench_hash2(int threads, const void* a, const void* b, void* out,
                long long B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads == kCoop) {
    hash2_kernel<kCoop><<<coop_grid_for(B), kCoopBlock, 0, s>>>(
        (const u32*)a, (const u32*)b, (u32*)out, B);
  } else {
    hash2_kernel<1><<<grid_for(B), kBlock, 0, s>>>(
        (const u32*)a, (const u32*)b, (u32*)out, B);
  }
  return (int)cudaGetLastError();
}

int bench_hash3(int threads, const void* a, const void* b, const void* c,
                void* out, long long B, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads == kCoop) {
    hash3_kernel<kCoop><<<coop_grid_for(B), kCoopBlock, 0, s>>>(
        (const u32*)a, (const u32*)b, (const u32*)c, (u32*)out, B);
  } else {
    hash3_kernel<1><<<grid_for(B), kBlock, 0, s>>>(
        (const u32*)a, (const u32*)b, (const u32*)c, (u32*)out, B);
  }
  return (int)cudaGetLastError();
}

}
"""


def build(_build) -> tuple:
    """(the library with bench_hash2 / bench_hash3, its ptxas log)."""
    out_dir = os.path.join(_build.BUILD_DIR, "lane_threads")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "bench_hash.cu")
    with open(src, "w") as f:
        f.write(BENCH_SOURCE % _build.source("poseidon"))
    path = os.path.join(out_dir, "libimt_bench_hash.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           path, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log}")
    lib = ctypes.CDLL(path)
    P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, argtypes in (("imt_init_constants", [P, I64]),
                           ("bench_hash2", [I32, P, P, P, I64, P]),
                           ("bench_hash3", [I32, P, P, P, P, I64, P])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib, log


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths",
                    default=",".join(str(1 << k) for k in range(18)))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--refine", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "hash_lane_threads.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from imt_tpu_torch.ops import _build, field
    from imt_tpu_torch.ops import poseidon as plain
    from imt_tpu_torch.ops import poseidon_cuda as pc
    from imt_tpu_torch.ops import vpu_roofline as vr
    from imt_tpu_torch.ops.poseidon_spec import kernel_words

    card = vr.nvidia_smi("name,power.limit")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib, log = build(_build)
    words = kernel_words()
    err = lib.imt_init_constants(words.ctypes.data_as(ctypes.c_void_p),
                                 words.size)
    if err:
        raise RuntimeError(f"imt_init_constants: CUDA error {err}")
    ptxas = {k: v for k, v in chip_smoke.ptxas_report(log).items()
             if k.startswith(("hash2_kernel", "hash3_kernel"))}
    package = pc.coop_lanes(dev)
    widths = [int(w) for w in args.widths.split(",")]
    checks = sorted({1, 33, 1000, package - 1, package, package + 1})

    rng = np.random.default_rng(chip_smoke.SEED)
    cols = chip_smoke.seeded_limbs(rng, max(widths + checks) * 2)
    for i, v in enumerate(chip_smoke.edge_values(field)):
        cols[:, i] = chip_smoke.int_limbs(v)
    limbs = [torch.as_tensor(np.roll(cols, s, axis=1), device=dev)
             for s in (0, 7, 101)]
    nodes = [plain.limbs_to_nodes(x) for x in limbs[:2]]
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())

    def run(kind: str, threads: int, width: int) -> torch.Tensor:
        out = torch.empty((field.WORDS, width), dtype=torch.int32,
                          device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if kind == "hash2":
            a, b = (x[:, :width].contiguous() for x in nodes)
            err = lib.bench_hash2(threads, ptr(a), ptr(b), ptr(out), width,
                                  stream)
        else:
            a, b, c = (x[:, :width].contiguous() for x in limbs)
            err = lib.bench_hash3(threads, ptr(a), ptr(b), ptr(c), ptr(out),
                                  width, stream)
        if err:
            raise RuntimeError(f"bench_{kind}: CUDA launch error {err}")
        return out

    for width in checks:
        want = {"hash2": plain.hash2_nodes(*(x[:, :width] for x in nodes)),
                "hash3": plain.hash3_leaf(*(x[:, :width] for x in limbs))}
        for kind in ("hash2", "hash3"):
            for threads in (1, COOP):
                if not torch.equal(run(kind, threads, width), want[kind]):
                    raise AssertionError(f"{kind} at {threads} threads a "
                                         f"lane, width {width}: differs "
                                         f"from plain")
    print(f"both kernels of hash2 and hash3 equal plain at widths {checks} "
          f"(edge values in the first lanes)")

    def time_width(width: int) -> dict:
        inputs = {"hash2": [x[:, :width].contiguous() for x in nodes],
                  "hash3": [x[:, :width].contiguous() for x in limbs]}
        public = {"hash2": pc.hash2_nodes, "hash3": pc.hash3_leaf}
        ms = {}
        for turn in ((1, COOP), (COOP, 1)):
            for kind in ("hash2", "hash3"):
                for threads in turn:
                    t = vr.time_ms(lambda: run(kind, threads, width),
                                   args.reps, 1)
                    key = f"{kind}/{threads}"
                    ms[key] = min(ms.get(key, t), t)
        for kind in ("hash2", "hash3"):
            ms[f"{kind}/package"] = vr.time_ms(
                lambda: public[kind](*inputs[kind]), args.reps, 1)
        print(f"width {width}: ms {ms} [{card}]")
        return ms

    times = {w: time_width(w) for w in widths}
    faster = [w for w in widths if times[w]["hash2/4"] < times[w]["hash2/1"]]
    lo = max((w for w in faster if all(w2 in faster for w2 in widths
                                       if w2 <= w)), default=0)
    above = [w for w in widths if w > lo]
    hi = min(above) if above else lo
    for _ in range(args.refine if lo and hi > lo + 1 else 0):
        mid = (lo + hi) // 2
        times[mid] = time_width(mid)
        if times[mid]["hash2/4"] < times[mid]["hash2/1"]:
            lo = mid
        else:
            hi = mid
    result = {
        "card": card, "sms": sms, "ptxas": ptxas,
        "crossover_measured": lo, "crossover_measured_per_sm": lo / sms,
        "first_width_one_thread_faster": hi,
        "crossover_package": package, "crossover_package_per_sm":
            package / sms,
        "ms": {str(w): times[w] for w in sorted(times)}}
    print(f"ptxas (registers, spill store and load bytes): {ptxas}")
    print(f"hash2: the cooperative kernel is faster up to {lo} lanes "
          f"({lo / sms:.1f} an SM of {sms}), one thread a lane from {hi}; "
          f"the package takes the cooperative kernels up to {package} lanes "
          f"({package / sms:.1f} an SM) [{card}]")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
