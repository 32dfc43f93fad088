"""Indexed-Merkle-tree semantics, written again from the reference circuit's
rules (aerius-labs/indexed-merkle-tree-halo2), not taken from the program.

A tree of 2^depth slots starts with every leaf (0, 0, 0); slot 0 is the
sentinel, value 0.  Insert number k of a tree takes slot k + 1 whether or
not it is accepted.  A value is accepted iff it is nonzero and not yet in
the set; then its low leaf (the largest member below it) points at it, and
it takes over the low leaf's old successor.  A leaf hashes as H(val,
next_val, next_idx), a node as H(left, right), an empty subtree of level
d as ``zero_hashes[d]``.

Values cross this module as canonical 16-bit limbs ``[16, n]`` (numpy) and
as 32-byte big-endian keys (numpy ``S32``), whose byte order is the value
order.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from .poseidon import Hasher, hash_int, zero_hashes

# below this width a level is finished with python ints
_HOST_WIDTH = 32


def keys(limbs16: np.ndarray) -> np.ndarray:
    """[16, n] limbs -> S32 keys (big-endian bytes, sortable by value)."""
    be = np.ascontiguousarray(np.asarray(limbs16)[::-1].T.astype(">u2"))
    return be.view("S32").ravel()


def _sorted_members(stream16: np.ndarray):
    """(accepted bool[n], the slots of the accepted values in value order)
    for a stream inserted in order into an empty tree."""
    stream16 = np.asarray(stream16)
    k = keys(stream16)
    order = np.argsort(k, kind="stable")
    ks = k[order]
    first = np.ones(k.size, dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    first &= stream16.any(axis=0)[order]
    ok = np.zeros(k.size, dtype=bool)
    ok[order] = first
    return ok, 1 + order[first]


def accepted(stream16: np.ndarray) -> np.ndarray:
    """bool[n]: which values of a stream, inserted in order into an empty
    tree, are accepted: the nonzero first occurrences."""
    return _sorted_members(stream16)[0]


def leaf_state(stream16: np.ndarray):
    """The leaves of slots 0..n after inserting `stream16` [16, n] into an
    empty tree: (val, next_val, next_idx) as int64 [16, n + 1] each."""
    stream16 = np.asarray(stream16)
    n = stream16.shape[1]
    ok, chain = _sorted_members(stream16)
    chain = np.concatenate([[0], chain])          # the sentinel is least
    # built slot-major ([n + 1, 16], rows contiguous) for the gathers
    val = np.zeros((n + 1, 16), dtype=np.int64)
    val[1:] = stream16.T * ok[:, None]
    nv = np.zeros((n + 1, 16), dtype=np.int64)
    nv[chain[:-1]] = val[chain[1:]]
    ni = np.zeros((n + 1, 16), dtype=np.int64)
    ni[chain[:-1], 0] = chain[1:] & 0xFFFF
    ni[chain[:-1], 1] = chain[1:] >> 16
    return val.T, nv.T, ni.T


def leaf_nodes(h: Hasher, val, nv, ni) -> torch.Tensor:
    """Leaf hashes (Montgomery limbs [10, n]) of limb arrays [16, n]."""
    out = []
    for i in range(0, val.shape[1], h.chunk):
        s = slice(i, i + h.chunk)
        out.append(h.hash3(*[h.to_mont(torch.from_numpy(
            np.ascontiguousarray(x[:, s]))) for x in (val, nv, ni)]))
    return torch.cat(out, dim=1)


def root_of_level(h: Hasher, nodes: torch.Tensor, level: int,
                  depth: int) -> int:
    """The depth-`depth` root over the occupied nodes [10, w] of `level`,
    whose slots from w on are empty subtrees."""
    z = zero_hashes(depth)
    while nodes.shape[1] > _HOST_WIDTH:
        if nodes.shape[1] % 2:
            nodes = torch.cat([nodes, h.const(z[level], 1)], dim=1)
        nodes = h.hash2(nodes[:, 0::2].contiguous(),
                        nodes[:, 1::2].contiguous())
        level += 1
    ints = h.to_ints(nodes)
    while level < depth:
        if len(ints) % 2:
            ints.append(z[level])
        ints = [hash_int([ints[i], ints[i + 1]])
                for i in range(0, len(ints), 2)]
        level += 1
    return ints[0]


def tree_root(h: Hasher, stream16: np.ndarray, depth: int) -> int:
    """Root of a depth-`depth` tree after inserting `stream16` [16, n]."""
    return root_of_level(h, leaf_nodes(h, *leaf_state(stream16)), 0, depth)


# -- sequential witnesses ----------------------------------------------------

def insert_expect(pre16: np.ndarray, block16: np.ndarray) -> dict:
    """What sequential inserts of `block16` [16, K], into a tree that got
    `pre16` [16, m] before (slots 1..m), give for each insert: ok, the low
    leaf's slot and its (val, next_val, next_idx), the new slot and its
    (val, next_val, next_idx), and is_new_leaf_largest.  Values are limbs
    [16, K]; slots int64[K]."""
    pre16 = np.asarray(pre16, dtype=np.int64)
    block16 = np.asarray(block16, dtype=np.int64)
    m, k = pre16.shape[1], block16.shape[1]
    stream = np.concatenate([pre16, block16], axis=1)
    ok_pre = accepted(pre16)
    members = np.concatenate([[0], 1 + np.flatnonzero(ok_pre)])
    mkeys = np.concatenate([[b""], keys(pre16)[ok_pre]]).astype("S32")
    order = np.argsort(mkeys, kind="stable")
    skeys, sslots = mkeys[order], members[order]
    bkeys = keys(block16)
    pos = np.searchsorted(skeys, bkeys, side="left")
    present = (pos < skeys.size) & (skeys[np.minimum(pos, skeys.size - 1)]
                                     == bkeys)
    low_pre = sslots[pos - 1]                  # pos >= 1: the sentinel is b""
    succ_pos = np.minimum(pos, skeys.size - 1)
    succ_pre = np.where(pos < skeys.size, sslots[succ_pos], -1)

    ok = np.zeros(k, dtype=bool)
    low = np.zeros(k, dtype=np.int64)
    succ = np.full(k, -1, dtype=np.int64)
    in_keys, in_slots = [], []                 # accepted so far, sorted
    for i in range(k):
        key = bytes(bkeys[i])
        j = bisect.bisect_left(in_keys, key)
        dup = j < len(in_keys) and in_keys[j] == key
        if present[i] or dup or not key:
            continue
        ok[i] = True
        lo, lo_key = int(low_pre[i]), bytes(skeys[pos[i] - 1])
        if j > 0 and in_keys[j - 1] > lo_key:
            lo = in_slots[j - 1]
        sc = int(succ_pre[i])
        sc_key = bytes(skeys[succ_pos[i]]) if sc >= 0 else None
        if j < len(in_keys) and (sc_key is None or in_keys[j] < sc_key):
            sc = in_slots[j]
        low[i], succ[i] = lo, sc
        in_keys.insert(j, key)
        in_slots.insert(j, m + 1 + i)

    def vals_of(slots):
        out = np.zeros((16, k), dtype=np.int64)
        has = slots > 0
        out[:, has] = stream[:, slots[has] - 1]
        return out

    def idx_limbs(slots):
        s = np.maximum(slots, 0)
        out = np.zeros((16, k), dtype=np.int64)
        out[0], out[1] = s & 0xFFFF, s >> 16
        return out

    largest = succ < 0
    low_val = vals_of(low)
    # the low leaf's old successor is the new leaf's successor
    succ_val = np.where(largest, 0, vals_of(np.maximum(succ, 0)))
    return dict(ok=ok, low_slot=low, low_leaf_val=low_val,
                low_leaf_next_val=succ_val, low_leaf_next_idx=idx_limbs(succ),
                new_leaf_val=block16, new_leaf_next_val=succ_val,
                new_leaf_next_idx=idx_limbs(succ),
                new_leaf_index=m + 1 + np.arange(k),
                is_new_leaf_largest=largest)


def helper_bits(slots: np.ndarray, depth: int) -> np.ndarray:
    """int[depth, K]: 1 where the path node of each slot is a left child."""
    return np.stack([((slots >> d) & 1) == 0 for d in range(depth)]) \
        .astype(np.int64)


def fold_roots(h: Hasher, leaves: torch.Tensor, proof16: np.ndarray,
               helpers: np.ndarray) -> np.ndarray:
    """Roots [16, W] of leaf nodes [10, W] folded with sibling paths
    `proof16` [depth, 16, W] (canonical limbs) by `helpers` [depth, W]
    (1: the path node is a left child)."""
    node = leaves
    for d in range(proof16.shape[0]):
        sib = h.to_mont(torch.from_numpy(np.ascontiguousarray(
            proof16[d], dtype=np.int64)))
        left = torch.from_numpy(np.asarray(helpers[d]) != 0).to(h.device)
        node = h.hash2(torch.where(left, node, sib),
                       torch.where(left, sib, node))
    return h.from_mont(node).cpu().numpy()


def insert_leaf_roots(h: Hasher, w: dict) -> dict:
    """The four roots the insert_leaf chip (src/indexed_merkle_tree.rs:
    231-314) folds from a witness `w` (numpy fields, K lanes): the old
    root from the low leaf, the interim root from the low leaf pointing at
    the new slot, the same interim root from the empty new slot, and the
    new root from the new leaf.  Returns limbs [16, K] each."""
    k = w["low_leaf_val"].shape[1]
    idx = np.zeros((16, k), dtype=np.int64)
    idx[0] = np.asarray(w["new_leaf_index"]) & 0xFFFF
    idx[1] = np.asarray(w["new_leaf_index"]) >> 16
    cat = lambda *xs: np.concatenate([np.asarray(x, dtype=np.int64)
                                      for x in xs], axis=1)
    leaves = leaf_nodes(
        h, cat(w["low_leaf_val"], w["low_leaf_val"], w["new_leaf_val"]),
        cat(w["low_leaf_next_val"], w["new_leaf_val"],
            w["new_leaf_next_val"]),
        cat(w["low_leaf_next_idx"], idx, w["new_leaf_next_idx"]))
    zero = h.const(zero_hashes(0)[0], k)
    leaves = torch.cat([leaves[:, :2 * k], zero, leaves[:, 2 * k:]], dim=1)
    lp, np_ = w["low_leaf_proof"], w["new_leaf_proof"]
    lh, nh = w["low_leaf_proof_helper"], w["new_leaf_proof_helper"]
    roots = fold_roots(h, leaves, np.concatenate([lp, lp, np_, np_], axis=2),
                       np.concatenate([lh, lh, nh, nh], axis=1))
    old, interim, slot_root, new = np.split(roots, 4, axis=1)
    return dict(old=old, interim=interim, slot=slot_root, new=new)
