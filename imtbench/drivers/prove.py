"""Witness proving: a rollup prover that needs the ``insert_leaf`` bundle of
every nullifier of every block, one closed-loop client.

Traffic keys: blocks of ``block_size`` (K) nullifiers go one at a time to
``insert_batch(values, witness=True)`` as host limbs [16, K]; a block is
acknowledged when every ``InsertWitness`` field is on the host as numpy
(the halo2 prover consumes the bundle on the CPU), and the next is
submitted then.  Its latency runs from submission to acknowledgement.  A
dense tree of the configuration starts empty; when the next block would
not fit, a fresh one is allocated inside the window and the same value
pool replayed.  ``warm_blocks`` blocks run on a scratch tree in set-up.
With a trace, ``trace_units`` whole blocks are profiled once
``trace_from`` of the window has passed.

Check, after the window, against the plain reference:

* every acknowledged mask against the set semantics;
* the chain of roots: each accepted insert's old root is the previous
  one's new root, across blocks too, and a tree's first old root is the
  empty tree's (every intermediate root the walk produced is in it);
* the last acknowledged new root against a rebuild from the values;
* in full, the first block, the last, and ``sampled_blocks`` blocks drawn
  from the seed: every value, index and helper field against the
  sequential semantics, and the four insert_leaf folds of every lane
  (old root from the low leaf and its proof, the interim root from both
  sides, the new root from the new leaf and its proof).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from imt_tpu_torch import IndexedMerkleTree
from imtbench.reference import poseidon, tree as ref
from imtbench.values import field_values

VALUE_FIELDS = ("low_leaf_val", "low_leaf_next_val", "low_leaf_next_idx",
                "new_leaf_val", "new_leaf_next_val", "new_leaf_next_idx",
                "new_leaf_index", "is_new_leaf_largest")


def p95(xs: list) -> float:
    """The 95th percentile by linear interpolation between order
    statistics (numpy's default), over every block."""
    return float(np.percentile(np.asarray(xs), 95))


def run(cell) -> dict:
    cfg, tr = cell.config, cell.traffic
    depth, k = cfg["depth"], tr["block_size"]
    if cfg["sparse"] or cfg["capacity_log2"] != depth:
        raise ValueError("the prove driver runs a dense tree")
    blocks = ((1 << depth) - 1) // k
    with cell.span("make_values"):
        stream = field_values(cell.seed, blocks * k)
        pool = np.ascontiguousarray(
            stream.reshape(16, blocks, k).transpose(1, 0, 2))
    rng = np.random.default_rng(abs(int(cell.seed)) + 1)
    sampled = set(rng.choice(blocks, size=min(tr["sampled_blocks"], blocks),
                             replace=False).tolist())

    with cell.span("warm_up"):
        tree = IndexedMerkleTree(depth, device=cell.device)
        for j in range(min(tr["warm_blocks"], blocks)):
            cell.host_copy(vars(tree.insert_batch(pool[j], witness=True)))
        tree = None
        tree = IndexedMerkleTree(depth, device=cell.device)

    lat, acks, full, traced = [], [], {}, 0
    t0 = cell.begin_window()
    j, tree_no, last = 0, 0, t0
    trace_left = tr["trace_units"] if cell.trace else 0
    profile = None
    while True:
        if trace_left and profile is None \
                and last - t0 >= tr["trace_from"] * cell.seconds:
            profile = cell.profiled()
            profile.__enter__()
        if j == blocks:
            with cell.span("swap_tree"):
                tree = None
                tree = IndexedMerkleTree(depth, device=cell.device)
            j, tree_no = 0, tree_no + 1
        sub = time.perf_counter()
        with cell.span("insert_batch_witness"):
            w = tree.insert_batch(pool[j], witness=True)
        with cell.span("witness_to_host"):
            f = cell.host_copy(vars(w))
        last = time.perf_counter()
        lat.append(last - sub)
        # the harness's own record for the check, after the acknowledgement
        acks.append((tree_no, j, f["ok"], f["old_root"].copy(),
                     f["new_root"].copy()))
        if (tree_no, j) == (0, 0) or (tree_no == 0 and j in sampled):
            full[(tree_no, j)] = {k: v.copy() for k, v in f.items()}
        last_f = (tree_no, j, f)
        if profile is not None and trace_left:
            traced += 1
            trace_left -= 1
            if not trace_left:
                profile.__exit__(None, None, None)
        j += 1
        if last - t0 >= cell.seconds and not trace_left \
                and len(acks) >= 2:
            break
    window_s = last - t0
    peak = torch.cuda.max_memory_allocated(cell.device) \
        if cell.device.type == "cuda" else 0
    tree = w = None
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    cell.note(f"{len(acks)} blocks in {window_s:.3f} s over {tree_no + 1} "
              f"trees ({tree_no} swaps), {blocks} blocks a tree")

    # -- the check -----------------------------------------------------------
    expect = ref.accepted(stream).reshape(blocks, k)
    bad_masks = sum(int((ok != expect[jj]).sum())
                    for _, jj, ok, _, _ in acks)
    # the chain of roots, over accepted lanes in insert order, per tree
    empty = poseidon.ints_to_limbs16(
        [poseidon.zero_hashes(depth)[depth]])[:, 0]
    bad_chain, prev = 0, None
    for _, jj, _, old, new in acks:
        lanes = np.flatnonzero(expect[jj])
        if jj == 0:
            prev = empty
        if not lanes.size:
            continue
        before = np.concatenate([prev[:, None], new[:, lanes[:-1]]], axis=1)
        bad_chain += int((old[:, lanes] != before).any(axis=0).sum())
        prev = new[:, lanes[-1]]
    h = poseidon.Hasher(cell.device)
    ltno, lj, lf = last_f
    lanes = np.flatnonzero(expect[lj])
    want = ref.tree_root(h, stream[:, :(lj + 1) * k], depth)
    got = poseidon.limbs16_to_ints(lf["new_root"][:, lanes[-1:]])[0] \
        if lanes.size else None
    bad_final = int(got != want) if lanes.size else 0
    full[(ltno, lj)] = lf

    bad_fields = 0
    keys = sorted(full)
    for key in keys:
        jj, f = key[1], full[key]
        e = ref.insert_expect(stream[:, :jj * k], pool[jj])
        m = e["ok"]
        for name in VALUE_FIELDS:
            bad_fields += int((f[name][..., m] != e[name][..., m])
                              .reshape(-1, m.sum()).any(axis=0).sum())
        for name, slots in (("low_leaf_proof_helper", e["low_slot"]),
                            ("new_leaf_proof_helper", e["new_leaf_index"])):
            bad_fields += int((f[name][:, m] != ref.helper_bits(
                slots, depth)[:, m]).any(axis=0).sum())
    stacked = {name: np.concatenate([full[key][name] for key in keys],
                                    axis=-1) for name in full[keys[0]]}
    ok_all = np.concatenate([expect[key[1]] for key in keys])
    roots = ref.insert_leaf_roots(h, stacked)
    fold_ok = ((roots["old"] == stacked["old_root"]).all(axis=0)
               & (roots["interim"] == roots["slot"]).all(axis=0)
               & (roots["new"] == stacked["new_root"]).all(axis=0))
    bad_folds = int((~fold_ok & ok_all).sum())
    cell.note(f"blocks checked in full: {keys}")
    attempted = len(acks) * k
    return {
        "attempted": attempted, "failed": bad_masks,
        "e2e": {"witness_inserts_per_s": attempted / window_s,
                "witness_block_p95_ms": 1e3 * p95(lat)},
        "checks": [("mask_lanes_wrong", bad_masks, 0),
                   ("root_chain_breaks", bad_chain, 0),
                   ("final_root_wrong", bad_final, 0),
                   ("witness_lanes_wrong", bad_fields, 0),
                   ("insert_leaf_folds_failed", bad_folds, 0)],
        "memory_peak_bytes": peak,
        "traced": {"units": traced, "counts": {}}}
