"""Checks of a tree's results that need nothing but the tree and its inputs.

``bench_torch.py`` holds each config's last round to them, and
``chip_smoke.py``'s phases use them too:

* ``set_semantics``: which values of a stream an indexed tree accepts (the
  nonzero first occurrences), on numpy rows;
* ``rebuild_root``: the root of a tree rebuilt from its leaf state alone,
  to hold against the root its inserts left.
"""

from __future__ import annotations

import numpy as np

from ..ops import field, hashing
from ..tree import indexed


def set_semantics(stream: np.ndarray) -> np.ndarray:
    """bool[N]: sequential set semantics over the values [16, N] in stream
    order, on numpy rows: a value is accepted iff it is nonzero and its
    first occurrence."""
    rows = np.ascontiguousarray(stream.T.astype(np.int32))
    keys = rows.view(np.dtype((np.void, rows.shape[1] * 4))).ravel()
    ok = np.zeros(rows.shape[0], dtype=bool)
    ok[np.unique(keys, return_index=True)[1]] = True
    return ok & rows.any(axis=1)


def rebuild_root(tree) -> int:
    """The full-depth root of `tree` (an ``IndexedMerkleTree`` or a tree
    derived from it) rebuilt from its leaf state alone: its active prefix
    hashed from the leaves up by the tree's own leaf hash, then folded over
    the zero spine of its own empty leaf."""
    leaves = tree._hash_leaves(*tree._columns())
    ad = tree.active_depth
    top = indexed._build_levels(leaves, ad)[-1]
    root = indexed._spine_fold(top, ad, tree.tree_depth, tree.zero_leaf)
    return field.limbs_to_int(hashing.dec_nodes(root)[:, 0].cpu())
