#!/usr/bin/env python3
"""Where a dense insert_batch of imt_tpu_torch spends its time on one GPU.

    python tools/profile_insert_torch.py

Needs a CUDA device (it refuses to run on the CPU).  Builds a depth-24 tree
on the card (the shape chip_smoke.py drives), runs one warm-up batch of
K = 4096, then:

1. times the two halves of the step (``_plan_batch``: sort, links, scatters
   and the dirty-leaf hash3; ``_update_paths_batch``: the level hashes)
   with a synchronise after each, on the host clock;
2. traces three whole ``insert_batch`` calls with ``torch.profiler`` and
   prints the device time by kernel, and the device's busy and idle share
   of the traced wall time.

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

from imt_tpu_torch import IndexedMerkleTree  # noqa: E402
from imt_tpu_torch.ops import field  # noqa: E402
from imt_tpu_torch.tree import indexed  # noqa: E402

DEPTH, K, BATCHES, SEED = 24, 4096, 3, 7


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
    from torch.profiler import ProfilerActivity, profile
    batches = [batch() for _ in range(BATCHES)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            tree.insert_batch(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel events only (device_type CUDA): the aten ops that launch them
    # carry the same time again
    rows = [(e.key, _device_time_us(e), e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows = [r for r in rows if r[1] > 0]
    busy_us = sum(r[1] for r in rows)
    print(f"{BATCHES} traced insert_batch calls: wall ms "
          f"{wall_us / 1e3}; device busy ms {busy_us / 1e3} "
          f"({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 - 100 * busy_us / wall_us:.1f}% idle) [{card}]")
    print("device time by kernel (ms total, launches, share of busy):")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:25]:
        print(f"  {us / 1e3:10.3f} ms  {n:6d}  {100 * us / busy_us:5.1f}%  "
              f"{key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
