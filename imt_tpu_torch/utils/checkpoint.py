"""Checkpoint and resume for indexed trees.

Counterpart of ``imt_tpu.utils.checkpoint``: atomic npz snapshots of the
leaf state (``vals`` / ``next_vals`` / ``next_idxs`` as uint32 limbs, the
slot cursor ``count`` and the full ``depth``), with the Merkle levels
rebuilt on load: the leaves are the source of truth.  The file format is
``imt_tpu``'s, so a snapshot written by either package loads in the other.
A sparse tree's snapshot carries the ``sparse`` marker (its ``to_arrays``
adds it) and holds the active prefix only.

A snapshot of a mesh-sharded tree (the ``sharded`` marker) and a restore
onto a mesh (``mesh=``) need the multi-GPU tree, which is not ported yet:
both raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..tree.indexed import IndexedMerkleTree
from ..tree.sparse import SparseIndexedMerkleTree

NO_MESH = "the multi-GPU (sharded) tree is not ported to imt_tpu_torch yet"


def save(tree, path: str) -> None:
    """Snapshot `tree` (dense or sparse) to `path`, atomically: the npz is
    written to a temporary file in the same directory and renamed into
    place, so a crash leaves the previous snapshot whole; the temporary
    file is removed on any failure."""
    arrays = tree.to_arrays()
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str, device="cuda", mesh=None):
    """The tree a snapshot holds, rebuilt on `device` (the card unless the
    caller asks for "cpu"): a ``SparseIndexedMerkleTree`` for a snapshot
    with the ``sparse`` marker, else an ``IndexedMerkleTree``."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if mesh is not None or int(arrays.get("sharded", 0)):
        raise NotImplementedError(NO_MESH)
    if int(arrays.get("sparse", 0)):
        return SparseIndexedMerkleTree.from_arrays(arrays, device=device)
    return IndexedMerkleTree.from_arrays(arrays, device=device)
