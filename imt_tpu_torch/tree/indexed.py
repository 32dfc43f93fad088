"""Indexed Merkle tree (Aztec-style nullifier tree), dense, on torch tensors.

Counterpart of ``imt_tpu.tree.indexed`` for the dense tree's batched insert:
leaf semantics ``(val, next_val, next_idx)`` form a sorted linked list over
the slots, and ``insert_batch`` resolves a whole batch with one lexicographic
sort, one 3-to-1 rehash of the 2K dirty leaves and a level-by-level
dirty-path update (``_plan_batch`` then ``_update_paths_batch``), with the
sequential semantics of ``imt_tpu``.  Every hash goes through
``ops/hashing.py``: the plain torch path for CPU tensors, the CUDA kernel
for CUDA tensors.

State: canonical limbs ``int32[16, N]`` for ``vals`` / ``next_vals`` /
``next_idxs``, and the Merkle levels as nodes ``int32[8, N >> d]``
(Montgomery form, fully reduced), leaves first.  Unlike ``imt_tpu``, whose
arrays are immutable, ``insert_batch`` updates the state and the levels IN
PLACE: at depth 24 a functional update would copy ~4 GB per batch.  A batch
that raises part-way (a failed launch) therefore leaves the tree
inconsistent.

Duplicate and zero inserts are rejected (ok=False; the slot is consumed and
stays a zero leaf), as in ``imt_tpu``.  Values given as python ints are
reduced mod p; values given as packed limbs are stored as given (a value
>= p is sorted by its raw bits and hashed mod p, as ``imt_tpu`` does).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import field, hashing
from ..utils.observability import GLOBAL_METRICS

# H(0,0,0): the empty-slot leaf hash.
ZERO_LEAF_HASH = 1960587138944869480785025106734196872454309951825657414575195034687326603497

# limbs of each 48-bit sort key, most significant key first
_KEY_GROUPS = ((15, 14, 13), (12, 11, 10), (9, 8, 7), (6, 5, 4), (3, 2, 1),
               (0,))


def _as_limb_batch(values, device) -> tuple[torch.Tensor, int]:
    """List of python ints OR packed limbs [16, K] (numpy or torch) ->
    (int32[16, K] on `device`, K)."""
    if isinstance(values, (np.ndarray, torch.Tensor)) and values.ndim == 2:
        if values.shape[0] != field.LIMBS:
            raise ValueError(
                f"expected [16, K] limb array, got {tuple(values.shape)}")
        x = torch.as_tensor(np.asarray(values).astype(np.int64)) \
            if isinstance(values, np.ndarray) else values.to(torch.int64)
        if bool(((x < 0) | (x > field.MASK)).any()):
            raise ValueError("limbs must lie in [0, 2^16)")
        return x.to(device=device, dtype=torch.int32).contiguous(), \
            values.shape[1]
    return (torch.as_tensor(field.ints_to_limbs([int(v) for v in values]),
                            device=device), len(values))


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


def _batch_hash_count(depth: int, k: int) -> int:
    """Fixed-length hashes one insert_batch performs (metrics accounting),
    mirroring _update_paths_batch's slab/low split."""
    total, slab, full = 2 * k, k, False       # 2k leaf hashes
    for d in range(depth):
        w = (1 << depth) >> d
        if full or k >= w // 2:
            full = True
            total += w // 2
        else:
            slab = slab // 2 + 1
            total += k + slab
    return total


def _crossover(depth: int, d_width: int) -> int:
    """First level index at which _update_paths_batch switches to full-level
    rebuild for a dirty set of d_width entries."""
    for d in range(depth):
        if d_width >= ((1 << depth) >> d) // 2:
            return d
    return depth


def _halves(level: torch.Tensor):
    return level[:, 0::2].contiguous(), level[:, 1::2].contiguous()


def _update_paths_batch(levels: list, low_idx: torch.Tensor,
                        low_hash: torch.Tensor, slab_start: int,
                        slab_hash: torch.Tensor, depth: int,
                        cross: int) -> None:
    """Batched dirty-path update (``imt_tpu`` ``_update_paths_batch``), in
    place on `levels`.  The K new slots are contiguous from `slab_start`,
    so their parents form a dense slab that halves per level; only the K low
    leaves need gathered paths.  Levels from `cross` up are rebuilt whole.

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
    for d in range(cross, depth):
        levels[d + 1] = hashing.hash2_nodes(*_halves(levels[d]))


def _plan_batch(vals, nvs, nis, new_vals, count: int, n: int, k: int):
    """The batched-insert planner (``imt_tpu`` ``_plan_batch``): sort every
    existing slot and new value by (value, slot), accept each entry that
    differs from its predecessor, link successors, rewrite pointers IN PLACE
    in vals / nvs / nis, and rehash the 2K dirty leaves.

    Returns (low_idx int64[K], low_hash [8, K], slab_start, slab_hash [8, K],
    ok bool[K])."""
    m = n + k
    dev = vals.device
    slab_start = count + 1
    slots = slab_start + torch.arange(k, device=dev)
    ar_m = torch.arange(m, device=dev)

    # Sort by (value, slot): six 48-bit value keys (three 16-bit limbs
    # each, most significant first) and the slot, as LSD passes.  Slots of
    # existing entries precede new slots, and new slots follow batch order:
    # the slot tie-break encodes sequential acceptance priority.
    value_keys = []
    for group in _KEY_GROUPS:
        key = torch.zeros(m, dtype=torch.int64, device=dev)
        for limb in group:
            key = (key << field.LIMB_BITS) | torch.cat(
                [vals[limb], new_vals[limb]]).to(torch.int64)
        value_keys.append(key)
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

    # successor / predecessor positions among accepted entries
    nxt = torch.where(accepted, ar_m, m).flip(0).cummin(0).values.flip(0)
    nxt = torch.cat([nxt[1:], torch.full((1,), m, device=dev)])   # strict >
    prv = torch.where(accepted, ar_m, -1).cummax(0).values
    prv = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), prv[:-1]])

    # Everything below is K-sized: only the new entries and their low
    # leaves change.
    inv_order = torch.empty_like(order)
    inv_order[order] = ar_m
    pos_new = inv_order[n:]
    ok = accepted[pos_new]

    nxt_new = nxt[pos_new]
    linked = (nxt_new < m) & ok
    succ_entry = order[nxt_new.clamp(0, m - 1)]
    succ_val = torch.where(
        succ_entry < n, vals[:, succ_entry.clamp(max=n - 1)],
        new_vals[:, (succ_entry - n).clamp(min=0)])
    succ_val = torch.where(linked, succ_val, 0)
    succ_slot = torch.where(linked, entry_slot[succ_entry], 0)
    prev_slot = entry_slot[order[prv[pos_new].clamp(0, m - 1)]]

    # New-slot rows (zeros on rejected lanes: the consumed-slot contract),
    # then the low-leaf pointer rewrites of accepted lanes, then the new
    # rows' pointers.  The order matters: a low target that is itself a new
    # slot is overwritten by the new-row write that follows, with the same
    # successor.  The accepted lanes' low targets are distinct.
    new_cols = slice(slab_start, slab_start + k)
    vals[:, new_cols] = torch.where(ok, new_vals, 0)
    acc = ok.nonzero().squeeze(1)
    low_tgt = prev_slot[acc]
    nvs[:, low_tgt] = new_vals[:, acc]
    nvs[:, new_cols] = succ_val
    nis[:, low_tgt] = index_to_limbs(slots[acc])
    nis[:, new_cols] = index_to_limbs(succ_slot)

    # dirty leaves: the K low leaves (rejected lanes rehash an unchanged
    # leaf) and the contiguous new-slot slab, in ONE width-2K hash3
    low_idx = prev_slot
    hashes = hashing.hash3_leaf(*[
        torch.cat([x[:, low_idx], _dynamic_slice(x, slab_start, k)], dim=1)
        for x in (vals, nvs, nis)])
    return (low_idx, hashes[:, :k].contiguous(), slab_start,
            hashes[:, k:].contiguous(), ok)


@lru_cache(maxsize=None)
def _zero_level_roots(depth: int) -> tuple[int, ...]:
    """Node value per level of an all-empty tree: h_0 = H(0,0,0),
    h_{d+1} = H2(h_d, h_d), with the python-int oracle."""
    from ..ops.poseidon_spec import default_params
    from ..ops.poseidon_ref import hash_fixed
    params = default_params()
    h = [ZERO_LEAF_HASH]
    for _ in range(depth):
        h.append(hash_fixed([h[-1], h[-1]], params))
    return tuple(h)


def _zero_levels(depth: int, device) -> list:
    """All-empty tree levels as nodes, each materialised on `device` (the
    levels are updated in place, so no level may be a broadcast view)."""
    n = 1 << depth
    levels = []
    for d, h in enumerate(_zero_level_roots(depth)):
        col = torch.as_tensor(field.int_to_node(h), device=device)[:, None]
        levels.append(col.expand(field.WORDS, n >> d).contiguous())
    return levels


def _build_levels(leaves: torch.Tensor, depth: int) -> list:
    """Full tree over leaf nodes [8, 2^depth]: all levels, leaves first."""
    levels = [leaves]
    for _ in range(depth):
        levels.append(hashing.hash2_nodes(*_halves(levels[-1])))
    return levels


class IndexedMerkleTree:
    """Dense indexed Merkle tree over 2^depth slots on one device, all-empty
    at construction (every preimage (0, 0, 0)).  `device` is where the state
    lives and the hashes run; it is never picked automatically."""

    def __init__(self, depth: int, device="cpu"):
        self._setup(depth, device)
        n = self.num_slots
        z = lambda: torch.zeros((field.LIMBS, n), dtype=torch.int32,
                                device=self.device)
        self.vals, self.next_vals, self.next_idxs = z(), z(), z()
        self.levels = _zero_levels(depth, self.device)

    def _setup(self, depth: int, device) -> None:
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.tree_depth = depth
        self.num_slots = 1 << depth
        self.count = 0  # inserts performed (slot cursor)
        self.device = torch.device(device)

    # -- queries -------------------------------------------------------------

    def get_root(self) -> torch.Tensor:
        """Root as canonical limbs int32[16, 1]."""
        return hashing.dec_nodes(self.levels[-1])

    def get_root_int(self) -> int:
        return field.limbs_to_int(self.get_root()[:, 0].cpu())

    def get_proof(self, index: int):
        """Sibling path as canonical limbs int32[depth, 16, 1] and helper
        bits int32[depth, 1] (helper = 1 iff the path node is a left
        child)."""
        sibs, helpers = [], []
        cur = int(index)
        for d in range(self.tree_depth):
            sibs.append(self.levels[d][:, cur ^ 1])
            helpers.append(1 if cur % 2 == 0 else 0)
            cur >>= 1
        proof = hashing.dec_nodes(torch.stack(sibs, dim=1).contiguous())
        return (proof.T.contiguous()[:, :, None],
                torch.tensor(helpers, dtype=torch.int32,
                             device=self.device)[:, None])

    def get_leaf_ints(self, index: int):
        return tuple(field.limbs_to_int(x[:, index].cpu())
                     for x in (self.vals, self.next_vals, self.next_idxs))

    # -- mutation ------------------------------------------------------------

    def insert(self, value: int):
        raise NotImplementedError(
            "sequential insert is not ported yet (ROADMAP.md Queue 1: "
            "sequential insert and the predicates)")

    def insert_batch(self, values, witness: bool = False) -> np.ndarray:
        """Batched insert with sequential semantics, sort-resolved, in place.
        `values` is a list of python ints or packed canonical limbs [16, K]
        (numpy or torch).  Returns the per-value acceptance mask bool[K]."""
        if witness:
            raise NotImplementedError(
                "insert_batch(witness=True) is not ported yet (ROADMAP.md "
                "Queue 1: witness batches)")
        new_vals, k = _as_limb_batch(values, self.device)
        if self.count + k >= self.num_slots:
            raise ValueError("tree full")
        depth = self.tree_depth
        low_idx, low_hash, slab_start, slab_hash, ok = _plan_batch(
            self.vals, self.next_vals, self.next_idxs, new_vals, self.count,
            self.num_slots, k)
        _update_paths_batch(self.levels, low_idx, low_hash, slab_start,
                            slab_hash, depth, _crossover(depth, k))
        self.count += k
        GLOBAL_METRICS.record_hashes(_batch_hash_count(depth, k))
        ok = ok.cpu().numpy()
        GLOBAL_METRICS.record_inserts(int(ok.sum()), k - int(ok.sum()))
        return ok

    # -- serialization -------------------------------------------------------

    def to_arrays(self) -> dict:
        """The same dict as ``imt_tpu``'s ``to_arrays`` (uint32 limbs)."""
        host = lambda x: x.cpu().numpy().astype(np.uint32)
        return {
            "depth": np.int64(self.tree_depth),
            "count": np.int64(self.count),
            "vals": host(self.vals),
            "next_vals": host(self.next_vals),
            "next_idxs": host(self.next_idxs),
        }

    @classmethod
    def from_arrays(cls, arrays: dict, device="cpu") -> "IndexedMerkleTree":
        """Rebuild a tree from ``to_arrays()`` output of either package."""
        tree = cls.__new__(cls)
        tree._setup(int(arrays["depth"]), device)
        tree.count = int(arrays["count"])
        dev = lambda a: torch.as_tensor(
            np.asarray(a).astype(np.int32), device=tree.device)
        tree.vals = dev(arrays["vals"])
        tree.next_vals = dev(arrays["next_vals"])
        tree.next_idxs = dev(arrays["next_idxs"])
        leaves = hashing.hash3_leaf(tree.vals, tree.next_vals, tree.next_idxs)
        tree.levels = _build_levels(leaves, tree.tree_depth)
        return tree
