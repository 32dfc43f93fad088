#!/usr/bin/env python3
"""Where imt_tpu_torch's paths spend their time on one GPU.

    python tools/profile_insert_torch.py

Needs a CUDA device (it refuses to run on the CPU).  Builds a depth-24 tree
on the card (the shape chip_smoke.py drives), runs one warm-up batch of
K = 4096, then:

1. times the two halves of the batched step (``_plan_batch``: sort, links,
   scatters and the dirty-leaf hash3; ``_update_paths_batch``: the level
   hashes) with a synchronise after each, on the host clock;
2. traces three whole ``insert_batch`` calls with ``torch.profiler`` and
   prints the device time by kernel, and the device's busy and idle share
   of the traced wall time;
3. the same for the sequential witness path: ``insert_seq`` of 16 values
   (after a warm-up of 4), then one ``non_inclusion_witness`` of 4096
   queries;
4. the same for one witness batch at config 3w's shape (a depth-16
   ``SparseIndexedMerkleTree`` holding all 2^16 slots, K = 4096, after a
   warm batch) and one ``insert_batches`` group at config 5's (depth 32,
   2^21 slots held, 8 batches of K = 65536, after a warm group).

Values are numpy-seeded 253-bit random limbs.  Every number is printed with
the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from imt_tpu_torch import (IndexedMerkleTree,  # noqa: E402
                           SparseIndexedMerkleTree)
from imt_tpu_torch.ops import field  # noqa: E402
from imt_tpu_torch.tree import indexed  # noqa: E402

DEPTH, K, BATCHES, SEQ, SEED = 24, 4096, 3, 16, 7


def _device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    depth, k = DEPTH, K
    rng = np.random.default_rng(SEED)
    batch = lambda: field.random_limbs(int(rng.integers(1 << 31)), k, 253)
    tree = IndexedMerkleTree(depth, device=dev)
    tree.insert_batch(batch())                                # warm-up
    torch.cuda.synchronize()

    # 1. the two halves of the step, synchronised
    cross = indexed._crossover(depth, k)
    plan_s, paths_s = [], []
    for _ in range(BATCHES):
        new_vals, _ = indexed._as_limb_batch(batch(), dev)
        t0 = time.perf_counter()
        low_idx, low_hash, slab_start, slab_hash, _ = indexed._plan_batch(
            tree.vals, tree.next_vals, tree.next_idxs, new_vals, tree.count,
            tree.num_slots, k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        indexed._update_paths_batch(tree.levels, low_idx, low_hash,
                                    slab_start, slab_hash, depth, cross)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tree.count += k
        plan_s.append(t1 - t0)
        paths_s.append(t2 - t1)
    print(f"depth {depth} K={k}: _plan_batch ms {[1e3 * s for s in plan_s]}; "
          f"_update_paths_batch ms {[1e3 * s for s in paths_s]} [{card}]")

    # 2. whole insert_batch calls under the profiler
    batches = [batch() for _ in range(BATCHES)]
    _trace(lambda: [tree.insert_batch(b) for b in batches],
           f"{BATCHES} traced insert_batch calls", card)

    # 3. the sequential witness path
    tree.insert_seq(batch()[:, :4])                            # warm-up
    seq, queries = batch()[:, :SEQ], batch()
    _trace(lambda: tree.insert_seq(seq),
           f"insert_seq of {SEQ} values (witness included)", card)
    _trace(lambda: tree.non_inclusion_witness(queries),
           f"non_inclusion_witness of {k} queries", card)
    del tree
    torch.cuda.empty_cache()

    # 4. a witness batch (config 3w) and a chained group (config 5)
    wtree = SparseIndexedMerkleTree(16, initial_capacity_log2=16, device=dev)
    wtree.insert_batch(batch(), witness=True)                 # warm-up
    wb = batch()
    _trace(lambda: wtree.insert_batch(wb, witness=True),
           f"insert_batch(witness=True) of {k} values at depth 16", card)
    c5 = SparseIndexedMerkleTree(32, initial_capacity_log2=21, device=dev)
    group = lambda: torch.as_tensor(np.stack([
        field.random_limbs(int(rng.integers(1 << 31)), 65536, 253)
        for _ in range(8)]), device=dev)
    c5.insert_batches(group())                                # warm-up
    g = group()
    _trace(lambda: c5.insert_batches(g),
           "insert_batches of 8 x 65536 values at depth 32 (2^21 held)",
           card)
    return 0


def _trace(fn, label: str, card: str) -> None:
    """Run fn under torch.profiler; print the wall time, the device's busy
    and idle share of it, and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel events only (device_type CUDA): the aten ops that launch them
    # carry the same time again
    rows = [(e.key, _device_time_us(e), e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows = [r for r in rows if r[1] > 0]
    busy_us = sum(r[1] for r in rows)
    print(f"{label}: wall ms {wall_us / 1e3}; device busy ms {busy_us / 1e3} "
          f"({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 - 100 * busy_us / wall_us:.1f}% idle) [{card}]")
    print("device time by kernel (ms total, launches, share of busy):")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:25]:
        print(f"  {us / 1e3:10.3f} ms  {n:6d}  {100 * us / busy_us:5.1f}%  "
              f"{key[:100]}")


if __name__ == "__main__":
    sys.exit(main())
