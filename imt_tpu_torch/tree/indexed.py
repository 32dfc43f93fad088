"""Indexed Merkle tree (Aztec-style nullifier tree), dense, on torch tensors.

Counterpart of ``imt_tpu.tree.indexed`` for the dense tree: leaf semantics
``(val, next_val, next_idx)`` form a sorted linked list over the slots.

* ``insert_batches`` resolves each of B batches with one lexicographic
  sort, one 3-to-1 rehash of the 2K dirty leaves and a level-by-level
  dirty-path update up to the crossover (``_plan_batch`` then
  ``_update_paths_batch``), and rebuilds the levels above the crossover
  once, after the last (``rebuild_levels``); ``insert_batch`` is that
  chain of one batch.
  ``insert_batch(witness=True)`` also returns every insert's
  ``InsertWitness`` (``batch_witness.py``).
* ``insert`` / ``insert_seq`` are the sequential witness path: one step per
  value (``_insert_step``, ``imt_tpu``'s ``_insert_step_fn``) returning the
  ``InsertWitness`` bundle the reference's insert_leaf chip consumes.
* ``non_inclusion_witness`` gives the ``NonInclusionWitness`` of a batch of
  queries with one sort; ``verify_non_inclusion`` and ``insert_leaf`` are
  the verifier predicates.

Every mutating entry point and ``non_inclusion_witness`` take ``as_numpy``
(``imt_tpu`` :1037-1210).  With the default True, ``ok`` comes back as
numpy, which waits for the device once per call.  With False it stays a
bool tensor on the tree's device and the call neither reads a value back
nor waits for the card: inserts are counted as submitted (the
``inserts.submitted`` counter), the debug-witness check is skipped, and
calls queue behind one another on the card.  Values given as python ints
or numpy are range-checked on the host and copied to the card from pinned
memory; limbs given as a tensor are checked where they lie, which on the
card reads one flag back.

Every hash goes through ``ops/hashing.py``: the plain torch path for CPU
tensors, the CUDA kernel for CUDA tensors.  A tree lives on the card unless
the caller asks for ``device="cpu"``.

The tracer (``utils/observability.py``) sees each call as one API span
(``insert_batch``, ``insert_batches``, ``get_root``) over spans of its
layers: ``stage`` (host values to the device), the planner's ``sort``,
``link``, ``temporal`` and ``leaf_hash``, the witness ``walk`` and
``finish``, the path update's ``paths`` and ``rebuild``, the zero-spine
fold ``spine`` (a sparse tree's roots), and ``wait`` wherever the host
blocks on the device.

State: canonical limbs ``int32[16, N]`` for ``vals`` / ``next_vals`` /
``next_idxs``, and the Merkle levels as nodes ``int32[8, N >> d]``
(Montgomery form, fully reduced), leaves first.  The levels may cover an
active prefix of 2^ad slots of a tree of full depth ``tree_depth``
(``sparse.py``): everything to its right is empty, so roots are folded
over the zero-subtree spine and proofs extended with it (``_spine_fold``,
``_extend_proof``); the dense tree is the case ad = ``tree_depth``.
Unlike ``imt_tpu``, whose arrays are immutable, the inserts update the
state and the levels IN PLACE:
at depth 24 a functional update would copy ~4 GB per batch (and ~1 GB per
sequential insert).  An insert that raises part-way (a failed launch)
therefore leaves the tree inconsistent.

Duplicate and zero inserts are rejected (ok=False; the slot is consumed and
stays a zero leaf), as in ``imt_tpu``.  Values given as python ints are
reduced mod p; values given as packed limbs are stored as given (a value
>= p is sorted by its raw bits and hashed mod p, as ``imt_tpu`` does).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import field, hashing
from ..utils.observability import count, span
from .merkle import _dec_path, _enc_path, fold_nodes, verify_proofs

# H(0,0,0): the empty-slot leaf hash.
ZERO_LEAF_HASH = 1960587138944869480785025106734196872454309951825657414575195034687326603497

# Fail-fast witness checking (``imt_tpu`` :59-76): with IMT_DEBUG_WITNESS=1
# or set_debug_witness(True), every witness bundle is re-verified by the
# insert_leaf / verify_non_inclusion predicate as it is made, and an
# AssertionError raised if an accepted lane fails.
_debug_witness = os.environ.get("IMT_DEBUG_WITNESS") == "1"


def set_debug_witness(on: bool) -> None:
    global _debug_witness
    _debug_witness = bool(on)


def debug_witness_enabled() -> bool:
    return _debug_witness


@dataclass
class InsertWitness:
    """The argument bundle of the reference's insert_leaf chip
    (src/indexed_merkle_tree.rs:231-244) for K inserts (``imt_tpu`` :136),
    as tensors on the tree's device; ``ok`` is numpy, or with
    ``as_numpy=False`` a bool tensor on the tree's device."""

    ok: np.ndarray | torch.Tensor          # bool[K]
    old_root: torch.Tensor                 # int32[16, K]
    low_leaf_val: torch.Tensor             # int32[16, K]
    low_leaf_next_val: torch.Tensor        # int32[16, K]
    low_leaf_next_idx: torch.Tensor        # int32[16, K]
    low_leaf_proof: torch.Tensor           # int32[depth, 16, K]
    low_leaf_proof_helper: torch.Tensor    # int32[depth, K]
    new_root: torch.Tensor                 # int32[16, K]
    new_leaf_val: torch.Tensor             # int32[16, K]
    new_leaf_next_val: torch.Tensor        # int32[16, K]
    new_leaf_next_idx: torch.Tensor        # int32[16, K]
    new_leaf_index: torch.Tensor           # int32[K]
    new_leaf_proof: torch.Tensor           # int32[depth, 16, K]
    new_leaf_proof_helper: torch.Tensor    # int32[depth, K]
    is_new_leaf_largest: torch.Tensor      # bool[K]


@dataclass
class NonInclusionWitness:
    """Witness bundle of verify_non_inclusion for K queries (``imt_tpu``
    :158; the reference's standalone chip entry,
    src/indexed_merkle_tree.rs:127); ``ok`` is numpy, or with
    ``as_numpy=False`` a bool tensor on the tree's device."""

    ok: np.ndarray | torch.Tensor          # bool[K] (a low leaf exists)
    root: torch.Tensor                     # int32[16, K]
    low_leaf_val: torch.Tensor             # int32[16, K]
    low_leaf_next_val: torch.Tensor        # int32[16, K]
    low_leaf_next_idx: torch.Tensor        # int32[16, K]
    low_leaf_proof: torch.Tensor           # int32[depth, 16, K]
    low_leaf_proof_helper: torch.Tensor    # int32[depth, K]
    is_new_leaf_largest: torch.Tensor      # bool[K]


def check_insert_witness(w: InsertWitness) -> None:
    """Raise AssertionError if an accepted lane of `w` fails insert_leaf
    (``imt_tpu`` :105)."""
    pred = insert_leaf(
        w.old_root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper, w.new_root,
        w.new_leaf_val, w.new_leaf_next_val, w.new_leaf_next_idx,
        w.new_leaf_index, w.new_leaf_proof, w.new_leaf_proof_helper,
        w.is_new_leaf_largest).cpu().numpy()
    bad = np.asarray(w.ok) & ~pred
    if bad.any():
        raise AssertionError(
            f"witness-generation inconsistency: insert_leaf predicate "
            f"rejected accepted lanes {np.nonzero(bad)[0].tolist()}")


def check_non_inclusion_witness(w: NonInclusionWitness, queries) -> None:
    """Raise AssertionError if an ok lane of `w` fails verify_non_inclusion
    (``imt_tpu`` :122)."""
    pred = verify_non_inclusion(
        w.root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper,
        torch.as_tensor(queries, device=w.root.device),
        w.is_new_leaf_largest).cpu().numpy()
    bad = np.asarray(w.ok) & ~pred
    if bad.any():
        raise AssertionError(
            f"witness-generation inconsistency: verify_non_inclusion "
            f"rejected ok lanes {np.nonzero(bad)[0].tolist()}")


# limbs of each 48-bit sort key, most significant key first
_KEY_GROUPS = ((15, 14, 13), (12, 11, 10), (9, 8, 7), (6, 5, 4), (3, 2, 1),
               (0,))


def _stage(host: np.ndarray, device) -> torch.Tensor:
    """Host limbs -> int32 on `device`.  To the card the copy goes from
    pinned memory and does not wait for the device, so a call queues its
    work behind whatever the card is running."""
    x = torch.from_numpy(np.ascontiguousarray(host, dtype=np.int32))
    if torch.device(device).type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _checked_limbs(values, device) -> torch.Tensor:
    """Packed limbs (numpy or torch, any integer dtype) -> int32 on
    `device`, after checking that every limb lies in [0, 2^16): numpy on
    the host, a tensor where it lies."""
    if isinstance(values, np.ndarray):
        x = values.astype(np.int64)
        if ((x < 0) | (x > field.MASK)).any():
            raise ValueError("limbs must lie in [0, 2^16)")
        return _stage(x, device)
    x = values.to(torch.int64)
    bad = ((x < 0) | (x > field.MASK)).any()
    with span("wait"):
        bad = bool(bad)
    if bad:
        raise ValueError("limbs must lie in [0, 2^16)")
    return x.to(device=device, dtype=torch.int32).contiguous()


def _as_limb_batch(values, device) -> tuple[torch.Tensor, int]:
    """List of python ints OR packed limbs [16, K] (numpy or torch) ->
    (int32[16, K] on `device`, K)."""
    if isinstance(values, (np.ndarray, torch.Tensor)) and values.ndim == 2:
        if values.shape[0] != field.LIMBS:
            raise ValueError(
                f"expected [16, K] limb array, got {tuple(values.shape)}")
        return _checked_limbs(values, device), values.shape[1]
    return (_stage(field.ints_to_limbs([int(v) for v in values]), device),
            len(values))


def _as_batch_stack(values, device) -> torch.Tensor:
    """B equal-length lists of python ints OR packed limbs [B, 16, K]
    (numpy or torch) -> int32[B, 16, K] on `device` (``imt_tpu`` :183)."""
    if isinstance(values, (np.ndarray, torch.Tensor)):
        if values.ndim != 3 or values.shape[1] != field.LIMBS:
            raise ValueError(
                f"expected [B, 16, K] limb array, got {tuple(values.shape)}")
        return _checked_limbs(values, device)
    if len({len(v) for v in values}) != 1:
        raise ValueError("all batches must have equal length")
    return _stage(np.stack(
        [field.ints_to_limbs([int(x) for x in v]) for v in values]), device)


def index_to_limbs(idx: torch.Tensor) -> torch.Tensor:
    """Integer tensor [...] (indices < 2^31) -> canonical limbs [16, ...]."""
    idx = idx.to(torch.int32)
    rest = torch.zeros((field.LIMBS - 2,) + tuple(idx.shape),
                       dtype=torch.int32, device=idx.device)
    return torch.cat([(idx & field.MASK)[None], (idx >> field.LIMB_BITS)[None],
                      rest])


def _clamped_start(start: int, size: int, dim: int) -> int:
    """lax.dynamic_slice's start index: a negative start counts from the
    end, then the start is clamped into [0, dim - size]."""
    if start < 0:
        start += dim
    return max(0, min(start, dim - size))


def _dynamic_slice(x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim(x, start, size, axis=1)`` (a view)."""
    return x.narrow(1, _clamped_start(start, size, x.shape[1]), size)


def _dynamic_update_slice(x: torch.Tensor, update: torch.Tensor,
                          start: int) -> None:
    """``lax.dynamic_update_slice_in_dim(x, update, start, axis=1)``, in
    place."""
    _dynamic_slice(x, start, update.shape[1]).copy_(update)


def _value_keys(limbs: torch.Tensor) -> list:
    """Canonical limbs [16, M] -> six int64[M] keys of 48 bits (three limbs
    each), most significant first: sorting by them in order sorts by
    value."""
    keys = []
    for group in _KEY_GROUPS:
        key = torch.zeros(limbs.shape[1], dtype=torch.int64,
                          device=limbs.device)
        for limb in group:
            key = (key << field.LIMB_BITS) | limbs[limb].to(torch.int64)
        keys.append(key)
    return keys


def _participants(vals: torch.Tensor) -> torch.Tensor:
    """bool[M]: the linked-list participants among the slots of `vals`
    [16, M]: slot 0 (the sentinel) and every slot holding a nonzero value
    (``imt_tpu`` :489-490)."""
    occupied = ~field.is_zero(vals)
    occupied[0] = True
    return occupied


def _lex_order(keys) -> torch.Tensor:
    """Permutation sorting entries by `keys` (least significant first),
    ascending: one stable sort per key, least significant first (LSD), so
    ties keep the order the earlier keys gave -- ``np.lexsort(keys)``."""
    order = None
    for key in keys:
        k = key if order is None else key[order]
        idx = torch.sort(k, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def _crossover(depth: int, d_width: int) -> int:
    """First level index from which a dirty set of d_width entries rebuilds
    the levels whole (``rebuild_levels``) instead of updating its paths
    (``_update_paths_batch``)."""
    for d in range(depth):
        if d_width >= ((1 << depth) >> d) // 2:
            return d
    return depth


def _halves(level: torch.Tensor):
    return level[:, 0::2].contiguous(), level[:, 1::2].contiguous()


def rebuild_levels(levels: list, lo: int, hi: int) -> None:
    """Levels lo + 1 .. hi of the list `levels` rebuilt in place from level
    lo, each the hash2 of the halves of the one below (one launch a level);
    the list ends at level hi after."""
    del levels[lo + 1:]
    for _ in range(lo, hi):
        levels.append(hashing.hash2_nodes(*_halves(levels[-1])))


def _update_paths_batch(levels: list, low_idx: torch.Tensor,
                        low_hash: torch.Tensor, slab_start: int,
                        slab_hash: torch.Tensor, cross: int) -> None:
    """Batched dirty-path update (``imt_tpu`` ``_update_paths_batch``), in
    place on `levels` 0 .. `cross`.  The K new slots are contiguous from
    `slab_start`, so their parents form a dense slab that halves per level;
    only the K low leaves need gathered paths.  The levels above `cross`
    are left to the caller, which rebuilds them whole (``rebuild_levels``).

    low_idx: int64[K]; low_hash, slab_hash: nodes [8, K]."""
    k = low_hash.shape[1]
    # low_idx repeats an index only with identical hashes (the same leaf,
    # rehashed from the same post-batch state), so the unspecified winner
    # of a CUDA index_put_ over repeated indices is harmless here.
    levels[0][:, low_idx] = low_hash
    _dynamic_update_slice(levels[0], slab_hash, slab_start)
    cur_idx, s, w = low_idx, slab_start, k
    for d in range(cross):
        level, nxt = levels[d], levels[d + 1]
        # window [ps, ps + w//2 + 1) covers every parent of [s, s + w)
        wp = w // 2 + 1
        ps = max(min(s >> 1, level.shape[1] // 2 - wp), 0)
        slab_par = hashing.hash2_nodes(
            *_halves(_dynamic_slice(level, 2 * ps, 2 * wp)))
        _dynamic_update_slice(nxt, slab_par, ps)
        # low-leaf parents, read from the slab-updated child level; repeated
        # parent_idx again carry identical values
        parent_idx = cur_idx >> 1
        nxt[:, parent_idx] = hashing.hash2_nodes(
            level[:, parent_idx * 2], level[:, parent_idx * 2 + 1])
        cur_idx, s, w = parent_idx, ps, wp


def _next_true(mask: torch.Tensor) -> torch.Tensor:
    """int64[M]: the position of the first true entry of `mask` bool[M]
    strictly after each position, M where there is none: ``lax.cummin(...,
    reverse=True)`` as a flip around ``torch.cummin``, shifted by one."""
    m = mask.shape[0]
    nxt = torch.where(mask, torch.arange(m, device=mask.device), m) \
        .flip(0).cummin(0).values.flip(0)
    return torch.cat([nxt[1:], nxt.new_full((1,), m)])


def _prev_true(mask: torch.Tensor, none: int) -> torch.Tensor:
    """int64[M]: the position of the last true entry of `mask` bool[M]
    strictly before each position, `none` where there is none."""
    prv = torch.where(mask, torch.arange(mask.shape[0], device=mask.device),
                      -1).cummax(0).values
    return torch.cat([prv.new_full((1,), none), prv[:-1]])


def _true_neighbours(mask: torch.Tensor, pos: torch.Tensor):
    """(prv, nxt) int64[K]: the last true entry of `mask` bool[M] strictly
    before each position of `pos` int64[K], -1 where there is none, and
    the first strictly after it, M where there is none: what
    ``_prev_true(mask, -1)[pos]`` and ``_next_true(mask)[pos]`` give, for
    one count scan over M and two K-sized searches.  With c the inclusive
    count of true entries, the b-th true entry is the first i with
    c[i] >= b: the one before p is number c[p - 1] (none if 0), the one
    after it number c[p] + 1 (M if there are fewer)."""
    count("plan.rank_scans")
    count("plan.rank_queries", pos.numel())
    c = torch.cumsum(mask, 0, dtype=torch.int32)
    before = torch.where(pos > 0, c[(pos - 1).clamp(min=0)], 0)
    prv = torch.where(before > 0, torch.searchsorted(c, before), -1)
    return prv, torch.searchsorted(c, c[pos] + 1)


def _entry_vals(vals, new_vals, entry: torch.Tensor, n: int):
    """Values [16, K] of sort entries `entry` int64[K]: entries below n are
    the slots of `vals`, the rest the new values."""
    return torch.where(entry < n, vals[:, entry.clamp(max=n - 1)],
                       new_vals[:, (entry - n).clamp(min=0)])


def _sort_batch(vals, new_vals, slab_start: int, n: int, k: int):
    """The final-list sort of the batched planners (``imt_tpu`` :766-797,
    and :251-273 of its batch_witness): every existing slot and new value
    sorted by (value, slot), each entry accepted unless it equals its sorted
    predecessor.  Entries 0..n-1 are the slots of `vals`, n..n+K-1 the new
    values, which take the slots from `slab_start` on.

    Returns (order, entry_slot, accepted, pos_new): the sort permutation
    of the entries, each entry's slot, acceptance by sorted position, and
    each new value's sorted position (all int64 / bool, M = n + K)."""
    m = n + k
    dev = vals.device
    ar_m = torch.arange(m, device=dev)
    # Sort by (value, slot): six 48-bit value keys (three 16-bit limbs
    # each, most significant first) and the slot, as LSD passes.  Slots of
    # existing entries precede new slots, and new slots follow batch order:
    # the slot tie-break encodes sequential acceptance priority.
    value_keys = _value_keys(torch.cat([vals, new_vals], dim=1))
    entry_slot = torch.where(ar_m < n, ar_m, ar_m - n + slab_start)
    order = _lex_order([entry_slot] + value_keys[::-1])

    # An entry equal to its sorted predecessor is a duplicate: empty slots
    # tie the slot-0 sentinel's 0, duplicate or zero new values tie their
    # first occurrence.
    eq_prev = torch.ones(m - 1, dtype=torch.bool, device=dev)
    for key in value_keys:
        ks = key[order]
        eq_prev &= ks[1:] == ks[:-1]
    del value_keys
    accepted = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          ~eq_prev])
    inv_order = torch.empty_like(order)
    inv_order[order] = ar_m
    return order, entry_slot, accepted, inv_order[n:]


def _link_batch(vals, nvs, nis, new_vals, sort, slab_start: int, n: int,
                k: int):
    """The final list after the batch: each accepted new value linked
    between its sorted neighbours among the accepted entries, written IN
    PLACE in vals / nvs / nis.  `sort` is ``_sort_batch``'s result.

    Returns (prev_slot int64[K]: each new value's final low leaf,
    ok bool[K])."""
    order, entry_slot, accepted, pos_new = sort
    m = n + k
    slots = slab_start + torch.arange(k, device=vals.device)
    # each new entry's predecessor / successor position among accepted
    # entries (position 0, the slot-0 sentinel, is always accepted and
    # sorts first, so every new entry has a predecessor)
    prv_new, nxt_new = _true_neighbours(accepted, pos_new)

    # Everything below is K-sized: only the new entries and their low
    # leaves change.
    ok = accepted[pos_new]
    linked = (nxt_new < m) & ok
    succ_entry = order[nxt_new.clamp(0, m - 1)]
    succ_val = torch.where(linked, _entry_vals(vals, new_vals, succ_entry, n),
                           0)
    succ_slot = torch.where(linked, entry_slot[succ_entry], 0)
    prev_slot = entry_slot[order[prv_new.clamp(0, m - 1)]]

    # New-slot rows (zeros on rejected lanes: the consumed-slot contract),
    # then the low-leaf pointer rewrites of accepted lanes, then the new
    # rows' pointers.  The order matters: a low target that is itself a new
    # slot is overwritten by the new-row write that follows, with the same
    # successor.  The accepted lanes' low targets are distinct; a rejected
    # lane writes its own new slot instead, which no accepted lane targets
    # and the new-row write overwrites: a mask, not a host sync.
    new_cols = slice(slab_start, slab_start + k)
    vals[:, new_cols] = torch.where(ok, new_vals, 0)
    low_tgt = torch.where(ok, prev_slot, slots)
    nvs[:, low_tgt] = new_vals
    nvs[:, new_cols] = succ_val
    nis[:, low_tgt] = index_to_limbs(slots)
    nis[:, new_cols] = index_to_limbs(succ_slot)
    return prev_slot, ok


def _hash_dirty(cols, low_idx: torch.Tensor, slab_start: int, k: int,
                leaf_hash):
    """The dirty leaves of a batch, each state column of `cols` in preimage
    order: the K low leaves `low_idx` (a rejected lane rehashes an
    unchanged leaf) and the contiguous new-slot slab, in ONE width-2K call
    of `leaf_hash` (limbs in, nodes out), the span ``leaf_hash``.  Returns
    (low_hash [8, K], slab_hash [8, K])."""
    with span("leaf_hash"):
        hashes = leaf_hash(*[
            torch.cat([x[:, low_idx], _dynamic_slice(x, slab_start, k)],
                      dim=1) for x in cols])
    return hashes[:, :k].contiguous(), hashes[:, k:].contiguous()


def _plan_batch(vals, nvs, nis, new_vals, count: int, n: int, k: int):
    """The batched-insert planner (``imt_tpu`` ``_plan_batch``): sort every
    existing slot and new value by (value, slot), accept each entry that
    differs from its predecessor, link successors, rewrite pointers IN PLACE
    in vals / nvs / nis, and rehash the 2K dirty leaves.

    Returns (low_idx int64[K], low_hash [8, K], slab_start, slab_hash [8, K],
    ok bool[K])."""
    slab_start = count + 1
    with span("sort"):
        sort = _sort_batch(vals, new_vals, slab_start, n, k)
    with span("link"):
        low_idx, ok = _link_batch(vals, nvs, nis, new_vals, sort, slab_start,
                                  n, k)
    low_hash, slab_hash = _hash_dirty((vals, nvs, nis), low_idx, slab_start,
                                      k, hashing.hash3_leaf)
    return low_idx, low_hash, slab_start, slab_hash, ok


@lru_cache(maxsize=None)
def _zero_level_roots(depth: int,
                      zero_leaf: int = ZERO_LEAF_HASH) -> tuple[int, ...]:
    """Node value per level of an all-empty tree whose empty leaf hashes
    to `zero_leaf` (H(0,0,0) for a nullifier tree): h_0 = zero_leaf,
    h_{d+1} = H2(h_d, h_d), with the python-int oracle."""
    from ..ops.poseidon_spec import default_params
    from ..ops.poseidon_ref import hash_fixed
    params = default_params()
    h = [zero_leaf]
    for _ in range(depth):
        h.append(hash_fixed([h[-1], h[-1]], params))
    return tuple(h)


def _zero_levels(depth: int, device, zero_leaf: int = ZERO_LEAF_HASH) -> list:
    """All-empty tree levels as nodes, each materialised on `device` (the
    levels are updated in place, so no level may be a broadcast view)."""
    n = 1 << depth
    levels = []
    for d, h in enumerate(_zero_level_roots(depth, zero_leaf)):
        col = torch.as_tensor(field.int_to_node(h), device=device)[:, None]
        levels.append(col.expand(field.WORDS, n >> d).contiguous())
    return levels


def _build_levels(leaves: torch.Tensor, depth: int) -> list:
    """Full tree over leaf nodes [8, 2^depth]: all levels, leaves first."""
    levels = [leaves]
    rebuild_levels(levels, 0, depth)
    return levels


# ---------------------------------------------------------------------------
# Zero-subtree spine (``imt_tpu`` :358-414).  A tree of full depth F whose
# occupied slots all lie in its leftmost 2^d leaves is held as that active
# prefix: every ancestor above the prefix root is H(node, zero subtree of
# its level), and every proof sibling above it is that zero-subtree hash
# (helper 1: the path hugs the left spine).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _zero_sib_nodes(depth: int, full_depth: int, device: torch.device,
                    zero_leaf: int = ZERO_LEAF_HASH) -> torch.Tensor:
    """Zero-subtree hash of each level d in [depth, full_depth) as nodes
    [full_depth - depth, 8, 1] on `device` (shared: read only)."""
    roots = _zero_level_roots(full_depth, zero_leaf)
    nodes = np.zeros((full_depth - depth, field.WORDS), dtype=np.int32)
    for i, d in enumerate(range(depth, full_depth)):
        nodes[i] = field.int_to_node(roots[d])
    return torch.as_tensor(nodes, device=device)[:, :, None]


def _spine_fold(root: torch.Tensor, depth: int, full_depth: int,
                zero_leaf: int = ZERO_LEAF_HASH) -> torch.Tensor:
    """Active-prefix roots, nodes [8, K] (a series of roots or one) ->
    full-depth roots [8, K]: one hash2 launch per level above the prefix,
    with the zero-subtree hash of the level (over empty leaves hashing to
    `zero_leaf`), made contiguous, as the right child.  The fold is the
    span ``spine`` and counts ``spine.launches`` (one a level) and
    ``spine.lanes`` (K a level); an empty spine (a dense tree) opens and
    counts nothing."""
    root = root.contiguous()
    sibs = _zero_sib_nodes(depth, full_depth, root.device, zero_leaf)
    if not len(sibs):
        return root
    with span("spine"):
        for sib in sibs:
            root = hashing.hash2_nodes(root, sib.expand_as(root).contiguous())
        count("spine.launches", len(sibs))
        count("spine.lanes", len(sibs) * root.shape[1])
    return root


def _extend_proof(proof: torch.Tensor, helpers: torch.Tensor, depth: int,
                  full_depth: int, zero_leaf: int = ZERO_LEAF_HASH):
    """Active-depth sibling paths, nodes [depth, 8, K] and helpers
    [depth, K] -> full-depth ones: the zero-subtree hashes above, helper
    1."""
    ext, k = full_depth - depth, proof.shape[-1]
    if not ext:
        return proof, helpers
    sibs = _zero_sib_nodes(depth, full_depth, proof.device, zero_leaf)
    return (torch.cat([proof, sibs.expand(ext, field.WORDS, k)]),
            torch.cat([helpers, torch.ones((ext, k), dtype=helpers.dtype,
                                           device=helpers.device)]))


def _beyond_prefix_proof(prefix_root: torch.Tensor, index: int, depth: int,
                         full_depth: int, zero_leaf: int = ZERO_LEAF_HASH):
    """Sibling path of a slot `index` >= 2^depth of a depth-`full_depth`
    tree whose active prefix of depth `depth` has the root node
    `prefix_root` [8, 1]: nodes [full_depth, 8, 1] and helpers
    int32[full_depth, 1], from the index's own bits.  Below the prefix's
    level every sibling is the zero-subtree root of its level; above it,
    the sibling is node 0 of its level (the prefix root folded up the
    spine) where the index's sibling node is node 0, and a zero-subtree
    root elsewhere."""
    dev = prefix_root.device
    sibs = list(_zero_sib_nodes(0, full_depth, dev, zero_leaf))
    top = index.bit_length() - 1          # the level whose sibling is node 0
    sibs[top] = _spine_fold(prefix_root, depth, top, zero_leaf)
    helpers = torch.tensor([[((index >> d) & 1) == 0]
                            for d in range(full_depth)],
                           dtype=torch.int32, device=dev)
    return torch.stack(sibs), helpers


# ---------------------------------------------------------------------------
# Sequential insert step (witness path)
# ---------------------------------------------------------------------------

def _gather_proof(levels: list, idx: torch.Tensor, depth: int):
    """Sibling paths of the slots `idx` int64[K] (``imt_tpu`` :216): nodes
    [depth, 8, K] and helper bits int32[depth, K] (1 iff the path node is a
    left child, reference src/utils.rs:70-79)."""
    sibs, helpers = [], []
    for d in range(depth):
        sibs.append(levels[d][:, idx ^ 1])
        helpers.append(((idx & 1) == 0).to(torch.int32))
        idx = idx >> 1
    return torch.stack(sibs), torch.stack(helpers)


def _low_leaf(vals: torch.Tensor, nvs: torch.Tensor, new_val: torch.Tensor):
    """The low leaf of `new_val` [16, 1] among the slots of `vals` / `nvs`
    [16, M] (``imt_tpu`` :488-494): the first list participant (slot 0 or a
    nonzero value) with val < new_val and (new_val < next_val or next_val =
    0).  Returns (ok, low_idx) as 0-dim device tensors; with no such slot
    ok is False and low_idx 0, as jnp.argmax of an all-false mask gives.
    The comparisons run limb by limb in int32 (field.less_than), so the
    [16, M] mask allocates only bool[M] temporaries."""
    mask = _participants(vals) & field.less_than(vals, new_val) & (
        field.less_than(new_val, nvs) | field.is_zero(nvs))
    return mask.any(), torch.argmax(mask.to(torch.uint8))


def _update_paths(levels: list, pair: torch.Tensor, leaf: torch.Tensor,
                  depth: int):
    """Dirty-path recompute for the two touched leaves (``imt_tpu``
    ``_update_paths``, :323, with D = 2), into scratch columns: `levels` is
    only read.  pair: int64[2] slots (the low leaf, the new slot); leaf:
    their new leaf nodes [8, 2].

    Returns (idx, nodes, old_self, old_sibs, new_sibs): idx int64[depth + 1,
    2] is each path's node index per level; nodes and old_self, per level
    (leaves first, the root last), the two path nodes [8, 2] of the updated
    tree and those the tree holds now; old_sibs and new_sibs, per level
    below the root, the siblings in the tree now and in the updated tree.
    Where the two paths have merged, both columns carry the same values, as
    in ``imt_tpu``, whose repeated scatter indices write identical values."""
    idx = pair[None] >> torch.arange(depth + 1, device=pair.device)[:, None]
    sib = idx[:-1] ^ 1
    cols = torch.cat([sib, idx[:-1]], dim=1)        # one gather per level
    is_left = ((idx[:-1] & 1) == 0).unsqueeze(1)
    # the other path's node is this path's sibling in the updated level
    other_is_sib = (sib == idx[:-1].flip(1)).unsqueeze(1)
    nodes, old_self, old_sibs, new_sibs = [leaf], [], [], []
    cur = leaf
    for d in range(depth):
        old = levels[d][:, cols[d]]
        new_sib = torch.where(other_is_sib[d], cur.flip(1), old[:, :2])
        cur = hashing.hash2_nodes(torch.where(is_left[d], cur, new_sib),
                                  torch.where(is_left[d], new_sib, cur))
        nodes.append(cur)
        old_sibs.append(old[:, :2])
        old_self.append(old[:, 2:])
        new_sibs.append(new_sib)
    old_self.append(levels[depth][:, idx[depth]])
    return idx, nodes, old_self, old_sibs, new_sibs


def _insert_step(tree: "IndexedMerkleTree", new_val: torch.Tensor) -> dict:
    """One sequential insert into `tree`, in place (``imt_tpu``
    ``_insert_step_fn``, :472-556).  new_val: canonical limbs [16, 1] on the
    tree's device.  Returns the witness fields, one lane, with the roots and
    proofs still as nodes of the active prefix (insert_seq folds, extends
    and decodes them all at once, ``_finish_witness``).

    ``imt_tpu`` computes the whole post-insert state and selects it with
    jnp.where(ok, ...) over every level -- at depth 24 a ~1 GB copy per
    insert.  Here the two touched paths are computed into scratch columns,
    the new root and the new-leaf proof come from them, and the state is
    written only where the lane is accepted (a where over the touched
    columns, so nothing waits for the host).  A rejected lane still gets
    the hypothetical new root, proofs and pointers that ``imt_tpu``
    computes."""
    depth, dev = tree.active_depth, tree.device
    vals, nvs, nis, levels = (tree.vals, tree.next_vals, tree.next_idxs,
                              tree.levels)
    live = tree._live
    ok, low_idx = _low_leaf(vals[:, :live], nvs[:, :live], new_val)
    s = torch.full((1,), tree.count + 1, dtype=torch.int64, device=dev)
    pair = torch.cat([low_idx.view(1), s])                     # int64[2]
    old_v, old_nv, old_ni = vals[:, pair], nvs[:, pair], nis[:, pair]
    low_nv, low_ni = old_nv[:, :1], old_ni[:, :1]
    s_limbs = index_to_limbs(s)

    # the two leaves after imt_tpu's writes (:508-510), in their order: a
    # write at s overrides one at the low leaf where the two coincide
    at_low, at_s = pair == pair[0], pair == s
    v2 = torch.where(at_s, new_val, old_v)
    nv2 = torch.where(at_s, low_nv, torch.where(at_low, new_val, old_nv))
    ni2 = torch.where(at_s, low_ni, torch.where(at_low, s_limbs, old_ni))
    leaf = hashing.hash3_leaf(v2, nv2, ni2)                    # [8, 2]
    idx, nodes, old_self, old_sibs, new_sibs = _update_paths(
        levels, pair, leaf, depth)

    # witness, taken before the state is written: the low-leaf proof
    # against the old tree, the new-leaf proof against the tree AFTER the
    # low leaf's update (reference :734, imt_tpu :520-521)
    is_left = ((idx[:-1] & 1) == 0).to(torch.int32)
    w = dict(
        ok=ok.view(1), old_root=old_self[-1][:, :1], new_root=nodes[-1][:, :1],
        low_leaf_val=old_v[:, :1], low_leaf_next_val=low_nv,
        low_leaf_next_idx=low_ni,
        low_leaf_proof=torch.stack([o[:, :1] for o in old_sibs]),
        low_leaf_proof_helper=is_left[:, :1],
        new_leaf_val=new_val, new_leaf_next_val=low_nv,
        new_leaf_next_idx=low_ni, new_leaf_index=s.to(torch.int32),
        new_leaf_proof=torch.stack([n[:, 1:] for n in new_sibs]),
        new_leaf_proof_helper=is_left[:, 1:],
        is_new_leaf_largest=field.is_zero(low_nv))

    # commit, on an accepted lane only.  Where the two paths have merged
    # (always at the root), index_put_ sees a repeated index; both columns
    # hold the same value (see _update_paths), so the winner does not matter.
    for x, new, old in ((vals, v2, old_v), (nvs, nv2, old_nv),
                        (nis, ni2, old_ni)):
        x[:, pair] = torch.where(ok, new, old)
    for d in range(depth + 1):
        levels[d][:, idx[d]] = torch.where(ok, nodes[d], old_self[d])
    return w


def _finish_witness(w: dict, depth: int, full_depth: int) -> InsertWitness:
    """Witness fields with the roots and proofs as nodes of a depth-`depth`
    active prefix -> the InsertWitness of the full-depth tree: the old and
    new roots folded over the zero spine in one series, the proofs
    extended, then all of them decoded in one launch; ``ok`` stays a
    tensor."""
    k = w["old_root"].shape[1]
    roots = _spine_fold(torch.cat([w["old_root"], w["new_root"]], dim=1),
                        depth, full_depth)
    low, w["low_leaf_proof_helper"] = _extend_proof(
        w["low_leaf_proof"], w["low_leaf_proof_helper"], depth, full_depth)
    new, w["new_leaf_proof_helper"] = _extend_proof(
        w["new_leaf_proof"], w["new_leaf_proof_helper"], depth, full_depth)
    # roots as two one-level paths, then both proofs: [2 + 2F, 8, K]
    dec = _dec_path(torch.cat([roots[:, :k][None], roots[:, k:][None], low,
                               new]))
    w["old_root"], w["new_root"] = dec[0], dec[1]
    w["low_leaf_proof"] = dec[2:2 + full_depth]
    w["new_leaf_proof"] = dec[2 + full_depth:]
    return InsertWitness(**w)


def _empty_witness(full_depth: int, device) -> InsertWitness:
    """The InsertWitness of no inserts, in the batch layout with 0 lanes,
    as ``imt_tpu``'s ``insert_seq([])`` returns it."""
    z = lambda *shape, dtype=torch.int32: torch.zeros(
        shape, dtype=dtype, device=device)
    limbs = ("old_root", "low_leaf_val", "low_leaf_next_val",
             "low_leaf_next_idx", "new_root", "new_leaf_val",
             "new_leaf_next_val", "new_leaf_next_idx")
    w = {name: z(field.LIMBS, 0) for name in limbs}
    for side in ("low", "new"):
        w[f"{side}_leaf_proof"] = z(full_depth, field.LIMBS, 0)
        w[f"{side}_leaf_proof_helper"] = z(full_depth, 0)
    return InsertWitness(ok=z(0, dtype=torch.bool), new_leaf_index=z(0),
                         is_new_leaf_largest=z(0, dtype=torch.bool), **w)


def _stack_witness(steps: list, depth: int, full_depth: int,
                   device) -> InsertWitness:
    """Per-insert witness fields (one lane each) -> one InsertWitness in the
    batch layout ([16, C] / [full_depth, 16, C], ``imt_tpu`` :583-599);
    no steps give the empty one."""
    if not steps:
        return _empty_witness(full_depth, device)
    return _finish_witness({key: torch.cat([w[key] for w in steps], dim=-1)
                            for key in steps[0]}, depth, full_depth)


# ---------------------------------------------------------------------------
# Batched non-inclusion witness
# ---------------------------------------------------------------------------

def sort_queries(vals: torch.Tensor, queries: torch.Tensor):
    """One stable sort of the slots `vals` [16, M] and the queries
    [16, K] by (value, is_query, entry): an existing entry equal to a
    query sorts before it.  ``imt_tpu`` sorts with a 9-key lax.sort; here
    the value is six 48-bit keys and is_query rides in the low bit of the
    least significant one, as six stable LSD passes (``_lex_order``),
    which gives the same order.  Returns (order int64[M + K], each query's
    sorted position int64[K])."""
    n, m = vals.shape[1], vals.shape[1] + queries.shape[1]
    ar_m = torch.arange(m, device=vals.device)
    keys = _value_keys(torch.cat([vals, queries], dim=1))
    keys[-1] = (keys[-1] << 1) | (ar_m >= n).to(torch.int64)
    order = _lex_order(keys[::-1])
    inv = torch.empty_like(order)
    inv[order] = ar_m
    return order, inv[n:]


def _non_inclusion(vals, nvs, nis, levels, queries, full_depth: int) -> dict:
    """Low leaf, proof and ok of each query [16, K] (``imt_tpu``
    ``_non_inclusion_witness_fn``, :674-750) over the slots of `vals` [16, M]
    (a prefix holding every list participant), with the root and proofs of
    the depth-`full_depth` tree whose active prefix `levels` hold.  The
    slots and queries sort together (``sort_queries``): an existing entry
    equal to a query sorts before it, so that query's low leaf fails
    val < q (ok False, the value is present)."""
    dev = vals.device
    n, k = vals.shape[1], queries.shape[1]
    m = n + k
    order, qpos = sort_queries(vals, queries)
    participant = torch.cat([_participants(vals),
                             torch.zeros(k, dtype=torch.bool, device=dev)])
    # last participant strictly before each query's sorted position
    prv = _true_neighbours(participant[order], qpos)[0]
    found = prv >= 0
    low_idx = torch.where(found, order[prv.clamp(0, m - 1)], 0)

    low_val, low_nv, low_ni = vals[:, low_idx], nvs[:, low_idx], \
        nis[:, low_idx]
    ok = found & field.less_than(low_val, queries) & (
        field.less_than(queries, low_nv) | field.is_zero(low_nv))
    depth = len(levels) - 1
    proof, helpers = _extend_proof(*_gather_proof(levels, low_idx, depth),
                                   depth, full_depth)
    root = hashing.dec_nodes(_spine_fold(levels[-1], depth, full_depth)) \
        .expand(field.LIMBS, k).contiguous()
    return dict(ok=ok, root=root, low_leaf_val=low_val,
                low_leaf_next_val=low_nv, low_leaf_next_idx=low_ni,
                low_leaf_proof=_dec_path(proof),
                low_leaf_proof_helper=helpers,
                is_new_leaf_largest=field.is_zero(low_nv))


# ---------------------------------------------------------------------------
# Verifier predicates (the reference chip's constraints as batched booleans)
# ---------------------------------------------------------------------------

def _bound_ok(low_leaf_next_val, new_leaf_value, is_new_leaf_largest):
    return torch.where(torch.as_tensor(is_new_leaf_largest,
                                       device=low_leaf_next_val.device),
                       field.is_zero(low_leaf_next_val),
                       field.less_than(new_leaf_value, low_leaf_next_val))


def verify_non_inclusion(root, low_leaf_val, low_leaf_next_val,
                         low_leaf_next_idx, low_leaf_proof,
                         low_leaf_proof_helper, new_leaf_value,
                         is_new_leaf_largest) -> torch.Tensor:
    """Batched non-membership check (``imt_tpu`` :881; the reference's
    verify_non_inclusion, src/indexed_merkle_tree.rs:127-229).  Values are
    canonical limb tensors [16, K]; proof [depth, 16, K]; helpers
    [depth, K]; is_new_leaf_largest bool[K].  Returns bool[K] on the
    tensors' device."""
    low_hash = hashing.hash3_leaf(low_leaf_val.contiguous(),
                                  low_leaf_next_val.contiguous(),
                                  low_leaf_next_idx.contiguous())
    acc_left = torch.as_tensor(low_leaf_proof_helper,
                               device=low_hash.device) != 0
    computed = hashing.dec_nodes(fold_nodes(
        low_hash, _enc_path(low_leaf_proof), acc_left))
    return (_bound_ok(low_leaf_next_val, new_leaf_value, is_new_leaf_largest)
            & field.eq(computed, root)
            & field.less_than(low_leaf_val, new_leaf_value))


def insert_leaf(old_root, low_leaf_val, low_leaf_next_val, low_leaf_next_idx,
                low_leaf_proof, low_leaf_proof_helper, new_root,
                new_leaf_val, new_leaf_next_val, new_leaf_next_idx,
                new_leaf_index, new_leaf_proof, new_leaf_proof_helper,
                is_new_leaf_largest) -> torch.Tensor:
    """Batched insertion check (``imt_tpu`` :903; the reference's
    insert_leaf chip, src/indexed_merkle_tree.rs:231-314): non-inclusion of
    the new value, the interim root with the low leaf pointing at the new
    slot, the new slot empty under it, pointer inheritance, and the final
    root.  new_leaf_index: int[K].  Returns bool[K] on the tensors' device.

    The four root folds (old low leaf, rewritten low leaf, empty slot, new
    leaf) share one hash3 launch and run as one fold of width 4K."""
    k = old_root.shape[1]
    dev = old_root.device
    leaves = hashing.hash3_leaf(
        torch.cat([low_leaf_val, low_leaf_val, new_leaf_val], dim=1),
        torch.cat([low_leaf_next_val, new_leaf_val, new_leaf_next_val], dim=1),
        torch.cat([low_leaf_next_idx,
                   index_to_limbs(torch.as_tensor(new_leaf_index, device=dev)),
                   new_leaf_next_idx], dim=1))
    zero = torch.as_tensor(field.int_to_node(ZERO_LEAF_HASH), device=dev)
    low_sibs = _enc_path(low_leaf_proof)
    new_sibs = _enc_path(new_leaf_proof)
    low_h = torch.as_tensor(low_leaf_proof_helper, device=dev) != 0
    new_h = torch.as_tensor(new_leaf_proof_helper, device=dev) != 0
    roots = hashing.dec_nodes(fold_nodes(
        torch.cat([leaves[:, :2 * k], zero[:, None].expand(field.WORDS, k),
                   leaves[:, 2 * k:]], dim=1),
        torch.cat([low_sibs, low_sibs, new_sibs, new_sibs], dim=2),
        torch.cat([low_h, low_h, new_h, new_h], dim=1)))
    computed, interim, slot_root, final = roots.split(k, dim=1)
    non_inclusion = (
        _bound_ok(low_leaf_next_val, new_leaf_val, is_new_leaf_largest)
        & field.eq(computed, old_root)
        & field.less_than(low_leaf_val, new_leaf_val))
    inherit = field.eq(new_leaf_next_val, low_leaf_next_val) & \
        field.eq(new_leaf_next_idx, low_leaf_next_idx)
    return (non_inclusion & field.eq(slot_root, interim) & inherit
            & field.eq(final, new_root))


class IndexedMerkleTree:
    """Dense indexed Merkle tree over 2^depth slots on one device, all-empty
    at construction (every preimage (0, 0, 0)).  `device` is where the state
    lives and the hashes run: the card unless the caller asks for "cpu"
    (on a host without CUDA the default raises, as torch does).

    ``_live`` bounds the slots that can hold a nonzero value (every slot
    from it on is an empty, non-participant slot), so the sequential low-leaf
    search and the non-inclusion sort look at ``[0, _live)`` only; it is
    exact, since such slots can never be a low leaf.  ``levels`` cover the
    active prefix of ``active_depth`` levels (all of them here;
    ``SparseIndexedMerkleTree`` holds fewer).

    The leaf kind is three class attributes, which a tree of another leaf
    (``public_data.PublicDataTree``) overrides together with ``_plan``:
    ``COLUMNS``, the state columns in the leaf's preimage order (each
    int32[16, slots], named as ``to_arrays`` names it); ``zero_leaf``, the
    hash of an empty leaf, which the all-empty levels and the zero spine
    are built from; and ``_hash_leaves``, the leaf hash."""

    COLUMNS = ("vals", "next_vals", "next_idxs")
    zero_leaf = ZERO_LEAF_HASH

    def __init__(self, depth: int, device="cuda"):
        self._setup(depth, device)
        self._alloc(depth)

    def _setup(self, depth: int, device) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.tree_depth = depth
        self.num_slots = 1 << depth
        self.count = 0  # inserts performed (slot cursor)
        self._live = 1
        self.device = torch.device(device)
        from .batch_witness import WalkGraphs
        self._walk_graphs = WalkGraphs()

    def _alloc(self, active_depth: int) -> None:
        for name in self.COLUMNS:
            setattr(self, name, torch.zeros(
                (field.LIMBS, 1 << active_depth), dtype=torch.int32,
                device=self.device))
        self.levels = _zero_levels(active_depth, self.device, self.zero_leaf)

    def _columns(self) -> tuple:
        """The state columns, in the leaf's preimage order."""
        return tuple(getattr(self, name) for name in self.COLUMNS)

    @staticmethod
    def _hash_leaves(*cols) -> torch.Tensor:
        """Leaf nodes [8, B] of state columns [16, B] in preimage order."""
        return hashing.hash3_leaf(*cols)

    @property
    def active_depth(self) -> int:
        return len(self.levels) - 1

    def _reserve(self, c: int) -> None:
        """Room for c more inserts (slots count+1 .. count+c), or raise."""
        if self.count + c >= self.num_slots:
            raise ValueError("tree full")

    def _advance(self, k: int) -> None:
        """k more slots consumed; every write so far is at a slot <=
        count."""
        self.count += k
        self._live = max(self._live, self.count + 1)

    # -- queries -------------------------------------------------------------

    def get_root(self) -> torch.Tensor:
        """Root as canonical limbs int32[16, 1]."""
        return hashing.dec_nodes(_spine_fold(
            self.levels[-1], self.active_depth, self.tree_depth,
            self.zero_leaf))

    def get_root_int(self) -> int:
        with span("get_root"):
            root = self.get_root()[:, 0]
            with span("wait"):
                root = root.cpu()
            return field.limbs_to_int(root)

    def get_proof(self, index: int):
        """Sibling path as canonical limbs int32[depth, 16, 1] and helper
        bits int32[depth, 1] (helper = 1 iff the path node is a left
        child), over the full depth.  A slot beyond the active prefix
        (a sparse tree's empty right flank) takes its siblings from the
        zero spine (``_beyond_prefix_proof``)."""
        index, ad = int(index), self.active_depth
        if not 0 <= index < self.num_slots:
            raise IndexError(f"slot {index} is outside the tree's "
                             f"{self.num_slots} slots")
        if index >> ad:
            proof, helpers = _beyond_prefix_proof(
                self.levels[-1], index, ad, self.tree_depth, self.zero_leaf)
            return _dec_path(proof), helpers
        idx = torch.full((1,), index, dtype=torch.int64, device=self.device)
        proof, helpers = _extend_proof(*_gather_proof(self.levels, idx, ad),
                                       ad, self.tree_depth, self.zero_leaf)
        return _dec_path(proof), helpers

    def verify_proof(self, leaf, index: int, root, proof) -> bool:
        """Verify by index parity (reference src/utils.rs:87-107; ``imt_tpu``
        :1022).  Stateless: recomputes the root from the proof alone, on
        the tree's device."""
        return bool(verify_proofs(leaf, [index], root, proof, self.device)[0])

    def get_leaf_ints(self, index: int):
        return tuple(field.limbs_to_int(x[:, index].cpu())
                     for x in (self.vals, self.next_vals, self.next_idxs))

    def non_inclusion_witness(self, values,
                              as_numpy: bool = True) -> NonInclusionWitness:
        """Batched non-membership witnesses for `values` (``imt_tpu``
        :1036): a list of python ints or packed canonical limbs [16, K].
        ok=False lanes mean the value is present (or 0): no witness
        exists.  as_numpy=False leaves ``ok`` on the device too."""
        queries, k = _as_limb_batch(values, self.device)
        count("queries", k)
        live = self._live
        w = NonInclusionWitness(**_non_inclusion(
            self.vals[:, :live], self.next_vals[:, :live],
            self.next_idxs[:, :live], self.levels, queries, self.tree_depth))
        if not as_numpy:
            return w
        w.ok = w.ok.cpu().numpy()
        if _debug_witness:
            check_non_inclusion_witness(w, queries)
        return w

    # -- mutation ------------------------------------------------------------

    @staticmethod
    def _accepted(ok: torch.Tensor, as_numpy: bool):
        """The acceptance mask `ok` (a device tensor) as the caller asked
        (``imt_tpu`` :1146-1148): numpy, with the accepted and rejected
        inserts counted, or left on the device and counted as submitted,
        which reads nothing back."""
        if not as_numpy:
            count("inserts.submitted", ok.numel())
            return ok
        with span("wait"):
            ok = ok.cpu()
        ok = ok.numpy()
        accepted = int(ok.sum())
        count("inserts.accepted", accepted)
        count("inserts.rejected", ok.size - accepted)
        return ok

    @staticmethod
    def _package_witness(w: InsertWitness, as_numpy: bool) -> InsertWitness:
        """`w` with its ok as the caller asked (``_accepted``), re-verified
        under the debug-witness check."""
        w.ok = IndexedMerkleTree._accepted(w.ok, as_numpy)
        if as_numpy and _debug_witness:
            check_insert_witness(w)
        return w

    def insert(self, value: int, as_numpy: bool = True) -> InsertWitness:
        """Sequential insert with the full witness bundle (``imt_tpu``
        :1065; reference parity): a one-lane ``insert_seq``."""
        return self.insert_seq([value], as_numpy=as_numpy)

    def insert_seq(self, values, as_numpy: bool = True) -> InsertWitness:
        """Strictly sequential inserts, each seeing the state the previous
        one left (the reference's test loop, src/indexed_merkle_tree.rs:
        710-802; ``imt_tpu`` :1165), as a python loop of ``_insert_step``.
        `values` is a list of python ints or packed canonical limbs
        [16, C].  Returns one InsertWitness with C lanes in the batch layout
        ([16, C] / [depth, 16, C]); the loop itself never waits for the
        device, and with as_numpy=False neither does the call."""
        new_vals, c = _as_limb_batch(values, self.device)
        self._reserve(c)
        steps = []
        for i in range(c):
            steps.append(_insert_step(self, new_vals[:, i:i + 1]))
            self._advance(1)
        w = _stack_witness(steps, self.active_depth, self.tree_depth,
                           self.device)
        return self._package_witness(w, as_numpy)

    def insert_batch(self, values, witness: bool = False,
                     as_numpy: bool = True):
        """Batched insert with sequential semantics, sort-resolved, in place.
        `values` is a list of python ints or packed canonical limbs [16, K]
        (numpy or torch).  Returns the per-value acceptance mask bool[K];
        with witness=True, the InsertWitness of every insert instead
        (``batch_witness.py``), equal on its accepted lanes to what
        ``insert_seq`` of the same values returns.  Without a witness the
        batch runs as a chain of one (``_insert_chain``).  as_numpy=False
        keeps the mask (and the witness) on the device."""
        with span("insert_batch"):
            with span("stage"):
                new_vals, k = _as_limb_batch(values, self.device)
            self._reserve(k)
            if witness:
                from .batch_witness import insert_batch_witness
                fields = insert_batch_witness(
                    self.vals, self.next_vals, self.next_idxs, self.levels,
                    new_vals, self.count, self._walk_graphs)
                self._advance(k)
                with span("finish"):
                    w = _finish_witness(fields, self.active_depth,
                                        self.tree_depth)
                return self._package_witness(w, as_numpy)
            return self._accepted(self._insert_chain(new_vals[None])[0],
                                  as_numpy)

    def insert_batches(self, values, as_numpy: bool = True):
        """B chained batches (``imt_tpu`` :1187, :613): packed limbs
        [B, 16, K] or B equal-length lists of python ints, state-identical
        to B ``insert_batch`` calls.  Returns the acceptance masks
        bool[B, K], on the device with as_numpy=False."""
        with span("insert_batches"):
            with span("stage"):
                arr = _as_batch_stack(values, self.device)
            self._reserve(arr.shape[0] * arr.shape[2])
            return self._accepted(self._insert_chain(arr), as_numpy)

    def _plan(self, batch: torch.Tensor, n: int, k: int):
        """One staged batch planned (``_plan_batch``): the state written
        IN PLACE and its 2K dirty leaves hashed.  Returns (low_idx,
        low_hash, slab_start, slab_hash, each lane's result)."""
        return _plan_batch(self.vals, self.next_vals, self.next_idxs, batch,
                           self.count, n, k)

    def _insert_chain(self, arr: torch.Tensor) -> torch.Tensor:
        """The batched insert of the staged batches `arr` [B, ..., K], room
        reserved: each batch is planned by the tree's own planner
        (``_plan``) and updates the levels up to the crossover
        (``_crossover``, the span ``paths``); the levels above it, which a
        batch would rebuild whole, are rebuilt once, after the last batch
        (the span ``rebuild``).  Returns the planner's results [B, K] on
        the device (ok bool[B, K] here)."""
        k = arr.shape[-1]
        ad, n = self.active_depth, self.vals.shape[1]
        cross = _crossover(ad, k)
        oks = []
        for batch in arr:
            low_idx, low_hash, slab_start, slab_hash, ok = self._plan(
                batch, n, k)
            with span("paths"):
                _update_paths_batch(self.levels, low_idx, low_hash,
                                    slab_start, slab_hash, cross)
            self._advance(k)
            oks.append(ok)
        with span("rebuild"):
            rebuild_levels(self.levels, cross, ad)
        return torch.stack(oks) if oks else torch.zeros(
            (0, k), dtype=torch.bool, device=self.device)

    # -- serialization -------------------------------------------------------

    def to_arrays(self) -> dict:
        """The same dict as ``imt_tpu``'s ``to_arrays`` (uint32 limbs)."""
        host = lambda x: x.cpu().numpy().astype(np.uint32)
        return {"depth": np.int64(self.tree_depth),
                "count": np.int64(self.count),
                **{name: host(getattr(self, name)) for name in self.COLUMNS}}

    @classmethod
    def from_arrays(cls, arrays: dict, device="cuda") -> "IndexedMerkleTree":
        """Rebuild a tree from ``to_arrays()`` output of either package, on
        `device`."""
        tree = cls.__new__(cls)
        tree._setup(int(arrays["depth"]), device)
        tree._load(arrays, tree.tree_depth)
        return tree

    def _load(self, arrays: dict, active_depth: int) -> None:
        """State from ``to_arrays`` output whose arrays hold 2^active_depth
        slots; the levels rebuilt from it."""
        vals = np.asarray(arrays["vals"])
        if vals.shape != (field.LIMBS, 1 << active_depth):
            raise ValueError(f"vals of shape {vals.shape} do not hold "
                             f"2^{active_depth} slots")
        self.count = int(arrays["count"])
        nonzero = np.flatnonzero(vals.any(axis=0))
        self._live = int(nonzero[-1]) + 1 if nonzero.size else 1
        for name in self.COLUMNS:
            setattr(self, name, torch.as_tensor(np.ascontiguousarray(
                arrays[name], dtype=np.int64).astype(np.int32),
                device=self.device))
        self.levels = _build_levels(self._hash_leaves(*self._columns()),
                                    active_depth)
