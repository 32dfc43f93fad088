"""Checkpoint and resume for indexed trees.

Counterpart of ``imt_tpu.utils.checkpoint``: atomic npz snapshots of the
leaf state (``vals`` / ``next_vals`` / ``next_idxs`` as uint32 limbs, the
slot cursor ``count`` and the full ``depth``), with the Merkle levels
rebuilt on load: the leaves are the source of truth.  The file format is
``imt_tpu``'s, so a snapshot written by either package loads in the other.
A sparse tree's snapshot carries the ``sparse`` marker (its ``to_arrays``
adds it) and holds the active prefix only.

A snapshot of a mesh-sharded tree (``parallel/sharded.py``) carries the
``sharded`` marker: every rank gathers the state, rank 0 of the mesh writes
the file, and every rank returns once it is written.  ``load`` restores
such a snapshot onto a mesh (the whole world's, or the one passed as
``mesh=``); ``mesh=`` also restores a dense or sparse snapshot sharded.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..tree.indexed import IndexedMerkleTree
from ..tree.sparse import SparseIndexedMerkleTree


def save(tree, path: str) -> None:
    """Snapshot `tree` (dense, sparse or sharded) to `path`, atomically:
    the npz is written to a temporary file in the same directory and
    renamed into place, so a crash leaves the previous snapshot whole; the
    temporary file is removed on any failure.  A sharded tree is saved by
    every rank of its mesh together (see the module docstring)."""
    arrays = dict(tree.to_arrays())
    # a sharded tree (or a Watchdog around one, which passes it through)
    write_once = getattr(tree, "write_once", None)
    if write_once is None:
        _write(arrays, path)
        return
    arrays["sharded"] = np.int64(1)
    write_once(lambda: _write(arrays, path))


def _write(arrays: dict, path: str) -> None:
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


def load(path: str, device=None, mesh=None):
    """The tree a snapshot holds, rebuilt on `device` (the card unless the
    caller asks for "cpu"): a ``ShardedIndexedMerkleTree`` for a snapshot
    with the ``sharded`` marker or when `mesh` is given (every rank of the
    mesh calls load; the tree's device defaults to the rank's own card),
    else a ``PublicDataTree`` for one with ``leaf_values``, a
    ``SparseIndexedMerkleTree`` for one with the ``sparse`` marker, else an
    ``IndexedMerkleTree``."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if "leaf_values" in arrays:
        if mesh is not None or int(arrays.get("sharded", 0)):
            raise ValueError("a public data tree is never sharded")
        from ..tree.public_data import PublicDataTree
        return PublicDataTree.from_arrays(
            arrays, device="cuda" if device is None else device)
    if mesh is not None or int(arrays.get("sharded", 0)):
        from ..parallel.sharded import ShardedIndexedMerkleTree
        return ShardedIndexedMerkleTree.from_arrays(arrays, mesh=mesh,
                                                    device=device)
    device = "cuda" if device is None else device
    if int(arrays.get("sparse", 0)):
        return SparseIndexedMerkleTree.from_arrays(arrays, device=device)
    return IndexedMerkleTree.from_arrays(arrays, device=device)
