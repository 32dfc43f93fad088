"""Public-state sync: a full node applying every block's public data writes
to Aztec's public data tree, one closed-loop client.

Traffic keys: blocks of ``block_size`` (K) writes, ``tx_size`` writes a
transaction, go to ``write_batches`` one block a group as host limbs
[1, 16, K] (slots and values); a group is acknowledged when its outcomes
(numpy) and its root (``get_root_int``) are on the host, and the next is
submitted then.  Each transaction's first write is a fee payment, the
balance slot of one of ``fee_payers`` payers drawn uniformly; of its other
writes a share ``rewrite_share`` rewrites a slot written in an earlier
block of the tree, drawn by YCSB's Zipfian generator (``zipf_theta``, Gray
et al.'s method, zeta grown as the slots grow; the hottest slot is the one
written first), the rest write fresh uniform field elements; the slots of
one transaction are distinct (a redrawn rewrite replaces a repeat), and
values are uniform field elements.  The pool of a whole tree is made in
set-up.  A tree of the configuration (``depth``, ``capacity_log2``, leaf
``public_data``) starts empty; when the next group would not fit, a fresh
tree is allocated inside the window and the same pool replayed.
``warm_groups``, ``trace_from``, ``trace_units`` and ``trace_group`` are
the sync driver's.

Check, after the window, against the plain reference
(``reference/public_data.py``): every outcome of every acknowledged group;
every root against the roots the same group index gave in the other trees
of the run; by a rebuild from the writes, the roots of the window's last
group, of the fullest group and of ``sampled_groups`` group indices drawn
from the seed; and the four state columns of the window's last tree,
copied to the host before it is freed, slot for slot.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from imt_tpu_torch.tree.public_data import PublicDataTree
from imtbench.reference import poseidon, public_data as ref
from imtbench.values import field_values


def make_tree(cfg: dict, device):
    if cfg.get("leaf") != "public_data" or not cfg["sparse"]:
        raise ValueError("the upsert driver runs a sparse public data tree")
    return PublicDataTree(cfg["depth"],
                          initial_capacity_log2=cfg["capacity_log2"],
                          device=device)


def zipf_ranks(u: np.ndarray, n: int, zetan: float,
               theta: float) -> np.ndarray:
    """YCSB's ZipfianGenerator over ranks 0..n-1 (Gray et al., "Quickly
    generating billion-record synthetic databases"), for uniform draws `u`
    in [0, 1) and zetan = sum_{i=1..n} i^-theta."""
    alpha = 1.0 / (1.0 - theta)
    zeta2 = 1.0 + 0.5 ** theta
    eta = (1.0 - (2.0 / n) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    uz = u * zetan
    r = (n * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    r = np.where(uz < 1.0, 0, np.where(uz < zeta2, 1, r))
    return np.clip(r, 0, n - 1)


def write_pool(seed: int, groups: int, tr: dict):
    """The writes of one tree, ``groups`` blocks: (slots, values) as
    int32 [16, groups * K] each, in write order."""
    k, tx, payers = tr["block_size"], tr["tx_size"], tr["fee_payers"]
    theta = tr["zipf_theta"]
    if k % tx:
        raise ValueError("a block is whole transactions")
    txs = k // tx
    rng = np.random.default_rng([abs(int(seed)), 20])
    # each write as an index into the table of distinct slots: the fee
    # payers first, then the fresh slots in write order
    idx = np.empty((groups, txs, tx), dtype=np.int64)
    ranked = np.empty(payers + groups * k, dtype=np.int64)  # by first write
    n_ranked, zeta_n, zetan, fresh = 0, 0, 0.0, payers
    seen = np.zeros(payers, dtype=bool)
    for g in range(groups):
        row = idx[g]
        row[:, 0] = rng.integers(0, payers, size=txs)
        # a rewrite needs a transaction's worth of earlier slots to draw from
        rw = (rng.random((txs, tx - 1)) < tr["rewrite_share"]) \
            & (n_ranked >= tx)
        body = np.empty((txs, tx - 1), dtype=np.int64)
        nf = int((~rw).sum())
        body[~rw] = fresh + np.arange(nf)
        start, fresh = fresh, fresh + nf
        zetan += float(np.sum(np.arange(zeta_n + 1, n_ranked + 1,
                                        dtype=np.float64) ** -theta))
        zeta_n = n_ranked
        draw = lambda c: ranked[zipf_ranks(rng.random(c), n_ranked, zetan,
                                           theta)]
        if rw.any():
            body[rw] = draw(int(rw.sum()))
        row[:, 1:] = body
        while True:       # a repeat within a transaction is drawn again
            srt = np.argsort(row, axis=1, kind="stable")
            sv = np.take_along_axis(row, srt, axis=1)
            rep = np.zeros(row.shape, dtype=bool)
            np.put_along_axis(rep, srt, np.concatenate(
                [np.zeros((txs, 1), dtype=bool), sv[:, 1:] == sv[:, :-1]],
                axis=1), axis=1)
            if not rep.any():
                break
            row[rep] = draw(int(rep.sum()))
        # this block's first writes, in write order, join the ranking
        flat = row.ravel()
        first = flat >= start
        for p in np.flatnonzero(~seen):
            at = np.flatnonzero(flat == p)
            if at.size:
                first[at[0]], seen[p] = True, True
        new = flat[first]
        ranked[n_ranked:n_ranked + new.size] = new
        n_ranked += new.size
    table = field_values(abs(int(seed)) * 3 + 1, fresh)
    slots = np.ascontiguousarray(table[:, idx.reshape(-1)])
    return slots, field_values(abs(int(seed)) * 3 + 2, groups * k)


def _blocks(x: np.ndarray, groups: int, k: int) -> np.ndarray:
    """[16, groups * K] -> [groups, 1, 16, K], contiguous."""
    return np.ascontiguousarray(
        x.reshape(16, groups, k).transpose(1, 0, 2))[:, None]


def run(cell) -> dict:
    cfg, tr = cell.config, cell.traffic
    k = tr["block_size"]
    groups = ((1 << cfg["capacity_log2"]) - 1) // k
    if groups < 1 or not 0 <= tr["trace_group"] < groups:
        raise ValueError("a group does not fit in the tree, or the traced "
                         "group index is not in it")
    with cell.span("make_values"):
        slots, values = write_pool(cell.seed, groups, tr)
        kpool, vpool = _blocks(slots, groups, k), _blocks(values, groups, k)

    with cell.span("warm_up"):
        tree = make_tree(cfg, cell.device)
        for g in range(min(tr["warm_groups"], groups)):
            tree.write_batches(kpool[g], vpool[g])
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
        with cell.span("write_batches"):
            out = tree.write_batches(kpool[g], vpool[g])
        with cell.span("get_root"):
            root = tree.get_root_int()
        last = time.perf_counter()
        acks.append((g, out))
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
    used = tree.count + 1
    cols = (tree.vals, tree.leaf_values, tree.next_vals, tree.next_idxs)
    state = [x[:, :used].cpu().numpy() for x in cols]
    tail = int(sum(int((x[:, used:] != 0).any(dim=0).sum()) for x in cols))
    tree = cols = None
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    cell.note(f"{len(acks)} groups in {window_s:.3f} s over {tree_no + 1} "
              f"trees ({tree_no} swaps), {groups} groups a tree")

    # -- the check -----------------------------------------------------------
    expect = ref.outcomes(slots).reshape(groups, k)
    bad_out = sum(int((np.asarray(out)[0] != expect[gi]).sum())
                  for gi, out in acks)
    repeats = sum(len(s) - 1 for s in roots_seen.values())
    h = poseidon.Hasher(cell.device)
    rng = np.random.default_rng(abs(int(cell.seed)) + 2)
    seen = sorted(roots_seen)
    drawn = rng.choice(len(seen), size=min(tr["sampled_groups"], len(seen)),
                       replace=False)
    checked = sorted({acks[-1][0], seen[-1]} | {seen[i] for i in drawn})
    bad_roots = 0
    for gi in checked:
        n = (gi + 1) * k
        want = ref.tree_root(h, slots[:, :n], values[:, :n], cfg["depth"])
        bad_roots += int(roots_seen[gi] != {want})
    cell.note(f"reference roots of group indices {checked}")
    n = used - 1
    want = ref.leaf_state(slots[:, :n], values[:, :n])
    bad_leaves = tail + int(np.any(
        [(x != w) for x, w in zip(state, want)], axis=(0, 1)).sum())
    counts = {}
    if traced:
        counts["needed_perms"] = sum(
            ref.needed_perms(slots[:, :gi * k],
                             slots[:, gi * k:(gi + 1) * k],
                             cfg["capacity_log2"], cfg["depth"])
            for gi in traced)
    attempted = len(acks) * k
    return {
        "attempted": attempted, "failed": bad_out,
        "e2e": {"inserts_per_s": attempted / window_s},
        "checks": [("outcomes_wrong", bad_out, 0),
                   ("roots_wrong", bad_roots, 0),
                   ("roots_differing_across_trees", repeats, 0),
                   ("leaves_wrong", bad_leaves, 0)],
        "memory_peak_bytes": peak,
        "traced": {"units": len(traced), "counts": counts}}
