#!/usr/bin/env python3
"""Measure K1 (``imt_permute_n``) over launch shapes on one GPU.

    python tools/k1_launch_torch.py [--variants 128:1,128:4,256:2]
                                    [--widths 8192,66560,131072]
                                    [--reps 10] [--out FILE.json]

Each variant is ``threads:min_blocks[:NAME=VALUE...]``: the
``csrc/poseidon_bn254.cu`` source built with ``-DIMT_K1_BLOCK=threads
-DIMT_K1_MIN_BLOCKS=min_blocks`` (K1's ``__launch_bounds__``; the blocks
per SM its registers must leave room for) and any further ``-D`` macros,
one nvcc per variant, all started at once, into
``imt_tpu_torch/build/k1_launch/``.  For each variant the tool prints
permute_kernel's registers and spill bytes (ptxas), holds it bit for bit
against the plain ``permute_n`` (n_perms 1 and 3 on a ragged width with
edge values in the first lanes), then times it at each width for n_perms 1
and 2, in turns (the variants in order, then in reverse; CUDA events, the
best of `reps` single calls), beside hash2_nodes of the package's own
build at the same widths.  The card's name and power limit are printed
beside the numbers, and the results written as JSON to `--out`.  Needs a
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

CHECK_WIDTH = 4099


def build_variants(_build, specs: list) -> dict:
    """spec -> (library path, ptxas log), one nvcc per spec, in parallel."""
    out_dir = os.path.join(_build.BUILD_DIR, "k1_launch")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, jobs = _build.find_nvcc(), {}
    for spec in specs:
        block, min_blocks, *defs = spec.split(":")
        flags = [f"-DIMT_K1_BLOCK={int(block)}",
                 f"-DIMT_K1_MIN_BLOCKS={int(min_blocks)}"]
        flags += [f"-D{d}" for d in defs]
        tag = spec.replace(":", "_").replace("=", "-")
        path = os.path.join(out_dir, f"libimt_k1_{tag}.so")
        jobs[spec] = (path, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-o", path,
             _build.source("poseidon")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for spec, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {spec}:\n{log}")
        built[spec] = (path, log)
    return built


def load_variant(_build, path: str, words: np.ndarray) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, argtypes in _build.LIBRARIES["poseidon"][1].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = lib.imt_init_constants(words.ctypes.data_as(ctypes.c_void_p),
                                 ctypes.c_longlong(words.size))
    if err:
        raise RuntimeError(f"imt_init_constants: CUDA error {err}")
    return lib


def permute(torch, lib, st, n: int):
    out = torch.empty_like(st)
    err = lib.imt_permute_n(
        ctypes.c_void_p(st.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_longlong(st.shape[-1]), ctypes.c_int(n),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"imt_permute_n: CUDA launch error {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="128:1,128:3,128:4,256:2,64:6")
    ap.add_argument("--widths", default="8192,66560,131072")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "k1_launch.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from imt_tpu_torch.ops import _build
    from imt_tpu_torch.ops import poseidon as plain
    from imt_tpu_torch.ops import poseidon_cuda as pc
    from imt_tpu_torch.ops import vpu_roofline as vr
    from imt_tpu_torch.ops.poseidon_spec import kernel_words

    card = vr.nvidia_smi("name,power.limit")
    specs = args.variants.split(",")
    widths = [int(w) for w in args.widths.split(",")]
    built = build_variants(_build, specs)
    words = kernel_words()
    libs = {s: load_variant(_build, path, words)
            for s, (path, _) in built.items()}
    dev = torch.device("cuda")

    rng = np.random.default_rng(chip_smoke.SEED)
    cols = chip_smoke.seeded_limbs(rng, max(widths + [CHECK_WIDTH]))
    from imt_tpu_torch.ops import field
    for i, v in enumerate(chip_smoke.edge_values(field)):
        cols[:, i] = chip_smoke.int_limbs(v)
    nodes = [plain.limbs_to_nodes(torch.as_tensor(
        np.roll(cols, s, axis=1), device=dev)) for s in (0, 7, 101)]
    st_all = torch.stack(nodes)
    check = st_all[..., :CHECK_WIDTH].contiguous()
    want = {n: plain.permute_n(check, n) for n in (1, 3)}

    results = {}
    for spec in specs:
        regs = chip_smoke.ptxas_report(built[spec][1]).get(
            "permute_kernel", (None, None, None))
        err = max(chip_smoke.max_abs_err(permute(torch, libs[spec], check, n),
                                         want[n]) for n in (1, 3))
        results[spec] = {"registers": regs[0], "spill_store": regs[1],
                         "spill_load": regs[2], "max_abs_err": err,
                         "ms": {}}
        print(f"variant {spec}: permute_kernel registers {regs[0]}, spill "
              f"store/load bytes {regs[1]}/{regs[2]}; vs plain at "
              f"{CHECK_WIDTH} lanes, n_perms 1 and 3: max_abs_err {err}")
        if err != 0:
            raise AssertionError(f"variant {spec} differs from plain")

    hash2 = {}
    for width in widths:
        st = st_all[..., :width].contiguous()
        h = lambda: pc.hash2_nodes(st[1], st[2])
        hash2[width] = [vr.time_ms(h, args.reps, 2)]
        for turn in (specs, specs[::-1]):
            for spec in turn:
                for n in (1, 2):
                    t = vr.time_ms(lambda: permute(torch, libs[spec], st, n),
                                   args.reps, 2)
                    results[spec]["ms"].setdefault(f"{width}/{n}",
                                                   []).append(t)
        hash2[width].append(vr.time_ms(h, args.reps, 0))
        for spec in specs:
            ms = results[spec]["ms"]
            print(f"width {width}: variant {spec}: n_perms 1 ms "
                  f"{ms[f'{width}/1']}, n_perms 2 ms {ms[f'{width}/2']}, "
                  f"per permutation {min(ms[f'{width}/2']) / 2}; hash2 ms "
                  f"{hash2[width]}, per permutation {min(hash2[width]) / 2} "
                  f"[{card}]")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "variants": results, "hash2_ms": hash2}, f,
                  indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
