"""Aztec's public data tree: an indexed Merkle tree of (slot, value) leaves
whose writes are upserts.

A leaf is ``PublicDataTreeLeafPreimage { slot, value, next_slot,
next_index }`` (aztec-packages noir-protocol-circuits), hashed in that
field order as a fixed-length Poseidon sponge of four inputs, H4 (the
halo2-base contract of ``hashing.hash_fixed``: three permutations, K1 on
the card).  The slots form the same sorted linked list as a nullifier
tree's values (``indexed.py``), so the tree is ``SparseIndexedMerkleTree``
with a fourth state column, ``leaf_values``, another leaf hash, an empty
leaf H4(0, 0, 0, 0) under its zero chain and spine, and another planner.

``write_batches`` applies B batches of K writes (slot, value).  Write
number j of a tree takes slot j + 1, whatever its outcome:

* insert (the slot is nonzero and not yet in the tree): as a nullifier
  insert, the new leaf (slot, value, low.next_slot, low.next_index) and
  the low leaf pointing at it;
* update (the slot is in the tree, or inserted earlier in the batch): the
  value of the leaf holding the slot (the group's *leader*) becomes that
  of the group's last write in batch order (last write wins); the write's
  own slot stays empty;
* reject (slot 0): the write's slot stays empty.

The planner is the nullifier tree's sort and links (``_sort_batch``,
``_true_neighbours`` inside ``_link_batch``) and one K-sized step, the span
``upsert`` (``_upsert``): masks only, no host read.  Every dirty leaf is
still one of K "low" slots (an insert's low leaf, an update's or a
reject's leader) or in the contiguous slab of new slots, so the path
update, the rebuild and the spine fold are the nullifier tree's
(``IndexedMerkleTree._insert_chain``).

The outcomes come back int8 [B, K]: 0 rejected, 1 inserted, 2 updated,
counted as ``writes.rejected`` / ``writes.inserted`` / ``writes.updated``
where they reach the host (``writes.submitted`` with ``as_numpy=False``).
Witnesses and non-inclusion queries of this tree are out of scope: the
nullifier tree's methods that assume a three-field leaf raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field, hashing
from ..utils.observability import count, span
from .indexed import _as_batch_stack, _hash_dirty, _link_batch, _sort_batch
from .sparse import SparseIndexedMerkleTree

# H4(0, 0, 0, 0): the empty public-data leaf.
ZERO_PUBLIC_DATA_LEAF_HASH = \
    10913207545003527179452412769170383321632543461197111647935310720364323312702

REJECTED, INSERTED, UPDATED = 0, 1, 2


def _hash_leaves4(*cols) -> torch.Tensor:
    """H4 of the state columns [16, B] (slot, value, next_slot,
    next_index) -> leaf nodes [8, B]: one sponge, three K1 launches on the
    card."""
    return hashing.hash_fixed_nodes(cols)


def _upsert(leaf_values, keys, values, sort, prev_slot, ok, slab_start: int,
            k: int) -> torch.Tensor:
    """The writes' outcomes int8[K], and the group values set IN PLACE in
    `leaf_values`.  `sort` is ``_sort_batch``'s result over the slots and
    the batch's keys; `prev_slot`, `ok` are ``_link_batch``'s: an accepted
    lane (an insert) gets its low leaf, any other lane the last accepted
    entry before it in sorted order, which is the first entry of its key:
    the leader (the slot that holds the key, or the key's first new
    occurrence; the sentinel for key 0).

    A group's entries are contiguous in sorted order, and its new entries
    in batch order (ties are broken by slot), so a lane writes last to its
    key iff the next sorted entry is accepted (a new key) or none follows.
    Only those lanes scatter, their value at their leader; every other
    lane writes 0 to slot 0, the sentinel, whose value stays 0 (key 0 is
    never accepted), so the scatter needs no host read.  The leaders of
    distinct groups are distinct."""
    _, _, accepted, pos_new = sort
    m = accepted.shape[0]
    slots = slab_start + torch.arange(k, device=keys.device)
    nonzero = ~field.is_zero(keys)
    last = nonzero & ((pos_new == m - 1)
                      | accepted[(pos_new + 1).clamp(max=m - 1)])
    leader = torch.where(ok, slots, prev_slot)
    leaf_values[:, torch.where(last, leader, 0)] = torch.where(last, values,
                                                               0)
    return torch.where(ok, INSERTED, torch.where(nonzero, UPDATED, REJECTED)) \
        .to(torch.int8)


def _plan_upsert(vals, leaf_values, nvs, nis, keys, values, count: int,
                 n: int, k: int):
    """The public data tree's batch planner: the nullifier planner's sort
    and links over the keys (``_sort_batch``, ``_link_batch``, IN PLACE in
    vals / nvs / nis), the upsert step (``_upsert``, IN PLACE in
    `leaf_values`), then the 2K dirty leaves through H4.

    Returns (low_idx int64[K], low_hash [8, K], slab_start, slab_hash
    [8, K], outcome int8[K])."""
    slab_start = count + 1
    with span("sort"):
        sort = _sort_batch(vals, keys, slab_start, n, k)
    with span("link"):
        low_idx, ok = _link_batch(vals, nvs, nis, keys, sort, slab_start, n,
                                  k)
    with span("upsert"):
        outcome = _upsert(leaf_values, keys, values, sort, low_idx, ok,
                          slab_start, k)
    low_hash, slab_hash = _hash_dirty((vals, leaf_values, nvs, nis), low_idx,
                                      slab_start, k, _hash_leaves4)
    return low_idx, low_hash, slab_start, slab_hash, outcome


def _unsupported(name: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"PublicDataTree.{name}: the nullifier tree's method assumes a "
            f"three-field leaf and set semantics; write with write_batches")
    method.__name__ = name
    return method


class PublicDataTree(SparseIndexedMerkleTree):
    """Aztec's public data tree over 2^depth slots (``PUBLIC_DATA_TREE_HEIGHT``
    40), whose state covers an active prefix of 2^initial_capacity_log2
    slots at first, doubled as writes need; on the card unless the caller
    asks for `device="cpu"`.  ``get_root`` / ``get_root_int``,
    ``get_proof`` and ``verify_proof`` are the nullifier tree's, over the
    H4 leaves; ``to_arrays`` carries ``leaf_values``."""

    COLUMNS = ("vals", "leaf_values", "next_vals", "next_idxs")
    zero_leaf = ZERO_PUBLIC_DATA_LEAF_HASH

    _hash_leaves = staticmethod(_hash_leaves4)

    def _plan(self, batch: torch.Tensor, n: int, k: int):
        return _plan_upsert(self.vals, self.leaf_values, self.next_vals,
                            self.next_idxs, batch[0], batch[1], self.count,
                            n, k)

    def write_batches(self, keys, values, as_numpy: bool = True):
        """B chained batches of K writes: `keys` (the slots) and `values`,
        each packed canonical limbs [B, 16, K] (numpy or torch) or B
        equal-length lists of python ints.  Returns the outcomes int8[B, K]
        (0 rejected, 1 inserted, 2 updated) as numpy, or on the device with
        as_numpy=False, which reads nothing back."""
        with span("write_batches"):
            with span("stage"):
                keys = _as_batch_stack(keys, self.device)
                values = _as_batch_stack(values, self.device)
                if keys.shape != values.shape:
                    raise ValueError(f"keys {tuple(keys.shape)} and values "
                                     f"{tuple(values.shape)} differ in shape")
                arr = torch.stack([keys, values], dim=1)
            self._reserve(arr.shape[0] * arr.shape[-1])
            out = self._insert_chain(arr).to(torch.int8)
            return self._outcomes(out, as_numpy)

    @staticmethod
    def _outcomes(out: torch.Tensor, as_numpy: bool):
        """The outcomes `out` (a device tensor) as the caller asked: numpy,
        each kind counted, or left on the device and counted as
        submitted."""
        if not as_numpy:
            count("writes.submitted", out.numel())
            return out
        with span("wait"):
            out = out.cpu()
        out = out.numpy()
        n = np.bincount(out.ravel(), minlength=3)
        count("writes.rejected", int(n[REJECTED]))
        count("writes.inserted", int(n[INSERTED]))
        count("writes.updated", int(n[UPDATED]))
        return out

    insert = _unsupported("insert")
    insert_seq = _unsupported("insert_seq")
    insert_batch = _unsupported("insert_batch")
    insert_batches = _unsupported("insert_batches")
    non_inclusion_witness = _unsupported("non_inclusion_witness")
    get_leaf_ints = _unsupported("get_leaf_ints")
