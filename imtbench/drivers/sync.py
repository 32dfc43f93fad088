"""Block sync: a full node catching up on a chain, one closed-loop client.

Traffic keys: ``blocks_per_group`` (b) blocks of ``block_size`` (K)
nullifiers go to ``insert_batches`` as host limbs [b, 16, K]; a group is
acknowledged when its masks (numpy) and its root (``get_root_int``) are
on the host, and the next is submitted then.  A tree of the configuration
(``depth``, ``capacity_log2``, ``sparse``) starts empty; when the next
group would not fit, a fresh tree of the same capacity is allocated inside
the window and the same value pool replayed, so every group lands in a
tree of fixed size with no growth.  ``warm_groups`` groups run on a
scratch tree in set-up.  With a trace, ``trace_units`` whole groups are
profiled, from the first group of index ``trace_group`` (within its tree,
so that every run traces the same tree sizes) once ``trace_from`` of the
window has passed.

Check, after the window, against the plain reference: every acknowledged
mask against the set semantics; every root against the roots the same
group index gave in the other trees of the run; and by a rebuild from the
values, the root of the window's last group, of the fullest group (index
G - 1, the tree at the largest size it reaches) and of ``sampled_groups``
group indices drawn from the seed among those the window acknowledged.
The other group indices are held only to their repeats across trees.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imtbench.reference import poseidon, tree as ref, work
from imtbench.values import field_values


def make_tree(cfg: dict, device):
    if cfg["sparse"]:
        return SparseIndexedMerkleTree(
            cfg["depth"], initial_capacity_log2=cfg["capacity_log2"],
            device=device)
    if cfg["capacity_log2"] != cfg["depth"]:
        raise ValueError("a dense tree holds all 2^depth slots")
    return IndexedMerkleTree(cfg["depth"], device=device)


def run(cell) -> dict:
    cfg, tr = cell.config, cell.traffic
    b, k = tr["blocks_per_group"], tr["block_size"]
    per_group = b * k
    groups = ((1 << cfg["capacity_log2"]) - 1) // per_group
    if groups < 1 or not 0 <= tr["trace_group"] < groups:
        raise ValueError("a group does not fit in the tree, or the traced "
                         "group index is not in it")
    with cell.span("make_values"):
        stream = field_values(cell.seed, groups * per_group)     # [16, n]
        pool = np.ascontiguousarray(
            stream.reshape(16, groups * b, k).transpose(1, 0, 2)
        ).reshape(groups, b, 16, k)

    with cell.span("warm_up"):
        tree = make_tree(cfg, cell.device)
        for g in range(min(tr["warm_groups"], groups)):
            tree.insert_batches(pool[g])
            tree.get_root_int()
        tree = None
        tree = make_tree(cfg, cell.device)

    acks, roots_seen, traced = [], {}, []
    t0 = cell.begin_window()
    g, tree_no, last = 0, 0, t0
    trace_left = tr["trace_units"] if cell.trace else 0
    profile = None
    while True:
        if g == groups:
            with cell.span("swap_tree"):
                tree = None
                tree = make_tree(cfg, cell.device)
            g, tree_no = 0, tree_no + 1
        if trace_left and profile is None and g == tr["trace_group"] \
                and last - t0 >= tr["trace_from"] * cell.seconds:
            profile = cell.profiled()
            profile.__enter__()
        with cell.span("insert_batches"):
            ok = tree.insert_batches(pool[g])
        with cell.span("get_root"):
            root = tree.get_root_int()
        last = time.perf_counter()
        acks.append((tree_no, g, ok, root))
        roots_seen.setdefault(g, set()).add(root)
        if profile is not None and trace_left:
            traced.append(g)
            trace_left -= 1
            if not trace_left:
                profile.__exit__(None, None, None)
        g += 1
        if last - t0 >= cell.seconds and not trace_left \
                and len(acks) >= 2:
            break
    window_s = last - t0
    peak = torch.cuda.max_memory_allocated(cell.device) \
        if cell.device.type == "cuda" else 0
    tree = None
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    cell.note(f"{len(acks)} groups in {window_s:.3f} s over {tree_no + 1} "
              f"trees ({tree_no} swaps), {groups} groups a tree")

    # -- the check -----------------------------------------------------------
    expect = ref.accepted(stream).reshape(groups, b, k)
    bad_masks = sum(int((np.asarray(ok) != expect[gi]).sum())
                    for _, gi, ok, _ in acks)
    repeats = sum(len(s) - 1 for s in roots_seen.values())
    h = poseidon.Hasher(cell.device)
    rng = np.random.default_rng(abs(int(cell.seed)) + 2)
    seen = sorted(roots_seen)
    drawn = rng.choice(len(seen), size=min(tr["sampled_groups"], len(seen)),
                       replace=False)
    checked = sorted({acks[-1][1], seen[-1]} | {seen[i] for i in drawn})
    bad_roots = 0
    for gi in checked:
        want = ref.tree_root(h, stream[:, :(gi + 1) * per_group],
                             cfg["depth"])
        bad_roots += int(roots_seen[gi] != {want})
    cell.note(f"reference roots of group indices {checked}")
    counts = {}
    if traced:
        perms = 0
        for gi in traced:
            need = work.needed_hashes(
                stream[:, :gi * per_group],
                stream[:, gi * per_group:(gi + 1) * per_group],
                cfg["capacity_log2"], cfg["depth"])
            perms += work.PERMS_PER_HASH * (need["hash3"] + need["hash2"])
        counts["needed_perms"] = perms
    attempted = len(acks) * per_group
    return {
        "attempted": attempted, "failed": bad_masks,
        "e2e": {"inserts_per_s": attempted / window_s},
        "checks": [("mask_lanes_wrong", bad_masks, 0),
                   ("roots_wrong", bad_roots, 0),
                   ("roots_differing_across_trees", repeats, 0)],
        "memory_peak_bytes": peak,
        "traced": {"units": len(traced) * b, "counts": counts}}
