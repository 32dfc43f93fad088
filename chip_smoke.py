#!/usr/bin/env python3
"""Smoke run of imt_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the CUDA Poseidon kernel from ``imt_tpu_torch/ops/csrc``, holds every
entry point of it bit for bit against its plain torch version on the card,
drives the port's main path (dense ``IndexedMerkleTree.insert_batch`` at
depth 24, K = 4096) and checks what comes out, then times the path and the
kernels.  Phases, in order; any failure raises and the exit code is not 0:

1. device: CUDA present; the card's name and power limit (nvidia-smi);
2. build: nvcc, with the build time and the ptxas register report;
3. kernel vs plain on CUDA tensors, bit for bit, at a ragged width of 65537
   lanes with edge values and at the main path's own widths, and the
   H(0,0,0) and poseidonperm_x5_254_3 anchors;
4. the slice: four depth-24 batches of 4096 values with planted duplicates
   and zeros (acceptance against set semantics, root against a full
   rebuild, the linked list walked in order, launch counts), then a depth-6
   replay against the python-int oracle;
5. numbers: depth-24 inserts/s, and each kernel's time beside its plain
   version's.

The line before the last is the kernels' JSON record (the main path's
kernels, then the entry points it does not run); the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEPTH, K, N_BATCHES = 24, 4096, 4
RAGGED = 65537
TIMING_WIDTH = 8192
SEED = 20260601

ANCHOR_H000 = 1960587138944869480785025106734196872454309951825657414575195034687326603497
TV_PERM_012 = [
    0x115cc0f5e7d690413df64c6b9662e9cf2a3617f2743245519e19607a4417189a,
    0x0fca49b798923ab0239de1c9e7a4a9a2210312b6a2f616d18b5a87f9b628ae29,
    0x0e7ae82e40091e63cbd4f16a6d16310b3729d4b6e138fcf54110e2867045a30c,
]

# entry point -> (TPU code it replaces, on the main path?).  hash2 and hash3
# are two modes of _hash_fn (pallas_call :1256), permute_n is _permute_fn
# (pallas_call :1216); the TPU ran the conversions as XLA around the kernel.
KERNELS = {
    "hash3_leaf": ("imt_tpu/ops/poseidon_rns_pallas.py:1240", True),
    "hash2_nodes": ("imt_tpu/ops/poseidon_rns_pallas.py:1240", True),
    "nodes_to_limbs": ("imt_tpu/ops/field_rns.py:262", True),
    "permute_n": ("imt_tpu/ops/poseidon_rns_pallas.py:1199", False),
    "limbs_to_nodes": ("imt_tpu/ops/field_rns.py:249", False),
}
SOURCE = "imt_tpu_torch/ops/csrc/poseidon_bn254.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def seeded_limbs(rng, width: int, bits: int = 254) -> np.ndarray:
    """int32[16, width] random values < 2^bits (some >= p when bits = 254)."""
    x = rng.integers(0, 1 << 16, (16, width), dtype=np.int64)
    top, rem = divmod(bits, 16)
    x[top + 1:] = 0
    if rem:
        x[top] &= (1 << rem) - 1
    return x.astype(np.int32)


def int_limbs(v: int) -> np.ndarray:
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                    dtype=np.int32)


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def phase_kernel_vs_plain(torch, pc, plain, field) -> dict:
    """Every entry point against its plain version on CUDA tensors: at a
    ragged width (edge values in the first lanes), then at the main path's
    own widths (hash3 over the 2K dirty leaves, hash2 over the K low leaves
    and the first slab level, the root decode)."""
    rng = np.random.default_rng(SEED)
    cols = seeded_limbs(rng, RAGGED)
    for i, v in enumerate([0, 1, field.P - 1, field.P, (1 << 256) - 1]):
        cols[:, i] = int_limbs(v)
    dev = torch.device("cuda")
    errs = {name: 0 for name in KERNELS}
    for width in (RAGGED, 2 * K, K, K // 2 + 1, 1):
        L = [torch.as_tensor(np.roll(cols, s, axis=1)[:, :width], device=dev)
             for s in (0, 7, 101)]
        nodes = [plain.limbs_to_nodes(x) for x in L]   # valid nodes (< p)
        cases = {
            "limbs_to_nodes": (pc.limbs_to_nodes, plain.limbs_to_nodes,
                               (L[0],)),
            "nodes_to_limbs": (pc.nodes_to_limbs, plain.nodes_to_limbs,
                               (nodes[0],)),
            "hash2_nodes": (pc.hash2_nodes, plain.hash2_nodes,
                            (nodes[0], nodes[1])),
            "hash3_leaf": (pc.hash3_leaf, plain.hash3_leaf, tuple(L)),
            "permute_n": (lambda s: pc.permute_n(s, 2),
                          lambda s: plain.permute_n(s, 2),
                          (torch.stack(nodes),)),
        }
        for name, (kern, ref, args) in cases.items():
            got = kern(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            errs[name] = max(errs[name], err)
            if err != 0:
                raise AssertionError(
                    f"{name} width {width}: kernel differs from plain")
    for name, err in errs.items():
        print(f"phase 3: {name} widths {RAGGED}, {2 * K}, {K}, {K // 2 + 1}, "
              f"1: kernel vs plain max_abs_err {err} (tolerance 0, "
              "bit-exact)")

    z = torch.zeros((16, 1), dtype=torch.int32, device=dev)
    h = field.limbs_to_int(pc.nodes_to_limbs(pc.hash3_leaf(z, z, z))[:, 0]
                           .cpu())
    if h != ANCHOR_H000:
        raise AssertionError(f"H(0,0,0) = {h:#x}, expected {ANCHOR_H000:#x}")
    st012 = torch.stack([torch.as_tensor(field.int_to_node(v), device=dev)
                         [:, None] for v in (0, 1, 2)])
    out = pc.permute_n(st012, 1).cpu()
    got = [field.node_to_int(out[j, :, 0].numpy()) for j in range(3)]
    if got != TV_PERM_012:
        raise AssertionError("poseidonperm_x5_254_3 vector mismatch")
    print("phase 3: kernel reproduces H(0,0,0) = 0x0455a7...48e9 and the "
          "poseidonperm_x5_254_3 vector")
    return errs


def plant(rng, batch: np.ndarray, prev: np.ndarray | None) -> np.ndarray:
    """Plant intra-batch duplicates, zeros and earlier-batch duplicates."""
    b = batch.copy()
    k = b.shape[1]
    idx = rng.choice(k, size=96, replace=False)
    b[:, idx[:32]] = b[:, idx[32:64]]            # intra-batch duplicates
    b[:, idx[64:80]] = 0                         # zeros
    if prev is not None:                         # duplicates of earlier values
        b[:, idx[80:96]] = prev[:, rng.choice(prev.shape[1], 16)]
    return b


def host_accept(seen: set, values: list[int]) -> list[bool]:
    """Sequential set semantics: accept a nonzero value not seen before."""
    ok = []
    for v in values:
        ok.append(v != 0 and v not in seen)
        if ok[-1]:
            seen.add(v)
    return ok


def phase_slice(torch, pc, field, indexed, reference_oracle) -> dict:
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    tree = indexed.IndexedMerkleTree(DEPTH, device=dev)
    batches, prev = [], None
    for _ in range(N_BATCHES):
        b = plant(rng, field.random_limbs(int(rng.integers(1 << 31)), K, 253),
                  prev)
        batches.append(b)
        prev = b
    torch.cuda.synchronize()

    seen: set = set()
    times, oks = [], []
    pc.reset_launch_counts()
    for b in batches:
        t0 = time.perf_counter()
        ok = tree.insert_batch(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        oks.append(ok)
    root = tree.get_root_int()
    launches = dict(pc.LAUNCHES)
    print(f"phase 4: depth {DEPTH}, {N_BATCHES} batches of K={K}: launches "
          f"{launches}")
    for name, (_, on_path) in KERNELS.items():
        if on_path and launches[name] == 0:
            raise AssertionError(f"main path never launched {name}")

    for i, (b, ok) in enumerate(zip(batches, oks)):
        want = host_accept(seen, field.limbs_to_ints(b))
        if ok.tolist() != want:
            raise AssertionError(f"batch {i}: ok mask differs from set "
                                 "semantics")
    print(f"phase 4: ok masks equal set semantics ({len(seen)} accepted of "
          f"{N_BATCHES * K})")

    leaves = pc.hash3_leaf(tree.vals, tree.next_vals, tree.next_idxs)
    full = indexed._build_levels(leaves, DEPTH)
    rebuilt = field.limbs_to_int(pc.nodes_to_limbs(full[-1])[:, 0].cpu())
    if rebuilt != root:
        raise AssertionError("root differs from a full rebuild")
    del leaves, full
    print(f"phase 4: root equals a full rebuild of 2^{DEPTH} leaves "
          f"({root:#x})")

    used = tree.count + 1
    vals, nvs, nis = (field.limbs_to_ints(x[:, :used].cpu().numpy())
                      for x in (tree.vals, tree.next_vals, tree.next_idxs))
    walk, slot = [], 0
    while nvs[slot] != 0:
        nxt = nis[slot]
        if vals[nxt] != nvs[slot]:
            raise AssertionError(f"slot {slot}: next_val != val of next_idx")
        walk.append(vals[nxt])
        slot = nxt
    if walk != sorted(seen) or any(a >= b for a, b in zip(walk, walk[1:])):
        raise AssertionError("linked list is not the accepted values in "
                             "strictly increasing order")
    print(f"phase 4: list walk from slot 0 visits {len(walk)} accepted values "
          "in strictly increasing order")

    replay_small(indexed, reference_oracle, dev)
    print("phase 4: depth-6 replay (3 batches of K=8 with duplicates, zeros, "
          "chains) matches the python-int oracle after every batch")
    return {"launches": launches, "batch_s": times}


def replay_small(indexed, reference_oracle, dev) -> None:
    """Three K=8 batches (duplicates, zeros, chains) into a depth-6 tree on
    `dev`; after each, the ok mask and the root must equal the python-int
    oracle's.  The oracle's own planner (update_idx_leaf) keeps the
    reference's quirk of taking an empty slot as a low leaf, and rejected
    values leave empty slots behind; so the list rule is replayed here on
    python ints, and the oracle hashes the leaves and builds the tree."""
    small = indexed.IndexedMerkleTree(6, device=dev)
    pre = [reference_oracle.Leaf(0, 0, 0) for _ in range(1 << 6)]
    seen6: set = set()
    slot = 0
    for vals6 in ([30, 10, 20, 5, 50, 35, 10, 0],
                  [31, 31, 0, 4, 36, 51, 2, 30],
                  [6, 7, 8, 9, 1, 5, 52, 3]):
        ok = small.insert_batch(vals6).tolist()
        want = host_accept(seen6, vals6)
        for v, accepted in zip(vals6, want):
            slot += 1                      # a rejected value consumes its slot
            if accepted:
                low = max((i for i, leaf in enumerate(pre)
                           if (i == 0 or leaf.val) and leaf.val < v),
                          key=lambda i: pre[i].val)
                pre[slot] = reference_oracle.Leaf(v, pre[low].next_val,
                                                  pre[low].next_idx)
                pre[low].next_val, pre[low].next_idx = v, slot
        oracle = reference_oracle.OracleTree(
            reference_oracle.hash_preimages(pre))
        if ok != want or small.get_root_int() != oracle.get_root():
            raise AssertionError("depth-6 replay differs from the oracle")


def cuda_ms(torch, fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_numbers(torch, pc, plain, card: str, slice_out: dict) -> dict:
    bs = slice_out["batch_s"]
    steady = bs[1:]
    print(f"phase 5: depth {DEPTH} insert_batch K={K} wall s per batch "
          f"{bs} (first includes warm-up); "
          f"{K * len(steady) / sum(steady)} inserts/s over batches 2-"
          f"{len(bs)} [{card}]")
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    L = [torch.as_tensor(seeded_limbs(rng, TIMING_WIDTH), device=dev)
         for _ in range(3)]
    nodes = [pc.limbs_to_nodes(x) for x in L]
    st = torch.stack(nodes)
    cases = {
        "hash2_nodes": (lambda f: f.hash2_nodes(nodes[0], nodes[1])),
        "hash3_leaf": (lambda f: f.hash3_leaf(*L)),
        "nodes_to_limbs": (lambda f: f.nodes_to_limbs(nodes[0])),
        "permute_n": (lambda f: f.permute_n(st, 1)),
        "limbs_to_nodes": (lambda f: f.limbs_to_nodes(L[0])),
    }
    times = {}
    for name, call in cases.items():
        # plain, kernel, kernel, plain
        p1 = cuda_ms(torch, lambda: call(plain), 1, 1)
        k1 = cuda_ms(torch, lambda: call(pc), 20, 3)
        k2 = cuda_ms(torch, lambda: call(pc), 20, 0)
        p2 = cuda_ms(torch, lambda: call(plain), 1, 0)
        times[name] = (min(k1, k2), min(p1, p2))
        print(f"phase 5: {name} width {TIMING_WIDTH}: kernel ms {k1} {k2}, "
              f"plain ms {p1} {p2} [{card}]")
    return times


def kernel_record(errs: dict, launches: dict, times: dict) -> dict:
    """The kernels' JSON record: the main path's kernels under "kernels"
    (each launched by phase 4), the entry points the main path does not
    run under "off_path_kernels"."""
    record = {"kernels": [], "off_path_kernels": []}
    for name, (rep, on_path) in KERNELS.items():
        record["kernels" if on_path else "off_path_kernels"].append(
            {"name": name, "route": "cuda", "source": SOURCE,
             "replaces": rep, "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1]})
    return record


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "imt_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1

    card = card_line()
    print(f"phase 1: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from imt_tpu_torch.ops import _build, field
    from imt_tpu_torch.ops import poseidon as plain
    from imt_tpu_torch.ops import poseidon_cuda as pc
    from imt_tpu_torch.tree import indexed, reference_oracle

    t0 = time.perf_counter()
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 2: kernel library built and loaded in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f}"
          f" s); ptxas: {' | '.join(ptxas)}")

    errs = phase_kernel_vs_plain(torch, pc, plain, field)
    slice_out = phase_slice(torch, pc, field, indexed, reference_oracle)
    times = phase_numbers(torch, pc, plain, card, slice_out)

    print(card)
    print(json.dumps(kernel_record(errs, slice_out["launches"], times)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
