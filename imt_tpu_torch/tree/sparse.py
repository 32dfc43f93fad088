"""Sparse-prefix indexed Merkle tree: deep trees without dense storage.

Counterpart of ``imt_tpu.tree.sparse``.  A nullifier tree of depth 32
would need 2^32 leaves held densely (2^32 x 32 bytes for level 0 alone),
but inserts only ever occupy slots 0..count: the slot cursor fills the
tree from the left.  So the tree is an active prefix of 2^ad slots, held
densely and doubled on demand, and an all-empty right flank, which only
the zero-subtree spine stands for: roots are folded over it and proofs
extended with it (``indexed._spine_fold`` / ``_extend_proof``).  Every
method is the dense tree's, run on the active prefix, so a
``SparseIndexedMerkleTree(depth)`` gives the same roots, masks and
witnesses as an ``IndexedMerkleTree(depth)`` fed the same values.

Growth rehashes the active leaves once per growth (the tree's leaf hash,
hash3 for a nullifier tree, at width 2^ad, and one rebuild of the
levels): O(1) hashes per insert, amortised.  A growth is the tracer's
span ``grow`` and counts ``sparse.grows``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field
from ..utils.observability import count, log_event, span
from .indexed import IndexedMerkleTree, _build_levels


class SparseIndexedMerkleTree(IndexedMerkleTree):
    """Indexed Merkle tree over 2^depth slots whose state covers an active
    prefix of 2^initial_capacity_log2 slots at first (clamped to [1,
    depth]), doubled as inserts need; on the card unless the caller asks
    for `device="cpu"`.  The API is ``IndexedMerkleTree``'s (``imt_tpu``
    :35-289): proofs, roots and witnesses are of the full depth."""

    def __init__(self, depth: int, initial_capacity_log2: int = 10,
                 device="cuda"):
        self._setup(depth, device)
        self._alloc(min(max(initial_capacity_log2, 1), depth))

    def _reserve(self, c: int) -> None:
        super()._reserve(c)
        self._grow_to(self.count + c + 1)

    def _grow_to(self, need: int) -> None:
        """Double the active prefix until it holds `need` slots (``imt_tpu``
        :56): the new slots are empty, then the levels are rebuilt."""
        ad = self.active_depth
        while (1 << ad) < need:
            ad += 1
        if ad == self.active_depth:
            return
        pad = (1 << ad) - self.vals.shape[1]
        with span("grow"):
            for name, x in zip(self.COLUMNS, self._columns()):
                setattr(self, name, torch.cat(
                    [x, x.new_zeros((field.LIMBS, pad))], dim=1))
            self.levels = _build_levels(self._hash_leaves(*self._columns()),
                                        ad)
        count("sparse.grows")
        log_event("sparse_grow", active_depth=ad, slots=1 << ad)

    def to_arrays(self) -> dict:
        """``imt_tpu``'s sparse snapshot: the active prefix's arrays and the
        ``sparse`` marker."""
        return dict(super().to_arrays(), sparse=np.int64(1))

    @classmethod
    def from_arrays(cls, arrays: dict,
                    device="cuda") -> "SparseIndexedMerkleTree":
        """Rebuild a tree from ``to_arrays()`` output of either package,
        sparse or dense, on `device`: the active prefix is the arrays'
        width, a power of two."""
        tree = cls.__new__(cls)
        tree._setup(int(arrays["depth"]), device)
        n = int(np.asarray(arrays["vals"]).shape[1])
        tree._load(arrays, min(max(n.bit_length() - 1, 1), tree.tree_depth))
        return tree
