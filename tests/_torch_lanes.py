"""Shape-only runs of the port's insert calls, to count the hash lanes they
dispatch at any size.

The Poseidon implementations are stand-ins that return zeros of the right
shape.  The counters of ``ops/hashing.py`` are kept before an
implementation is chosen, so they see each launch as a run on the CPU or
the card dispatches it: the call's own code decides every width, and no
width depends on a hash's value.  A single-device tree lies on torch's
meta device (shapes, no data: a depth-24 tree would take ~7 GB here).
``mesh_lanes`` runs each rank of a shard-local mesh in turn on the CPU
(1/D of the state; the meta device's elementwise ops are ~100x slower),
with collectives that return what a group of D ranks would in shape.
"""

import numpy as np
import torch

from imt_tpu_torch.ops import field, hashing
from imt_tpu_torch.parallel import collectives, local_plan
from imt_tpu_torch.parallel.sharded import ShardedIndexedMerkleTree
from imt_tpu_torch.utils import observability

META = torch.device("meta")
CPU = torch.device("cpu")
LANES = ("hash2.lanes", "hash3.lanes", "perm.lanes")


class _Shapes:
    """Poseidon by shape alone."""

    @staticmethod
    def hash2_nodes(a, b):
        return torch.zeros_like(a)

    @staticmethod
    def hash3_leaf(a, b, c):
        return a.new_zeros((field.WORDS, a.shape[1]))

    @staticmethod
    def hash_fixed(cols):
        return torch.zeros_like(cols[0])

    @staticmethod
    def limbs_to_nodes(x):
        return x.new_zeros((field.WORDS, x.shape[1]))

    @staticmethod
    def nodes_to_limbs(x):
        return x.new_zeros((field.LIMBS, x.shape[1]))


def shape_only(monkeypatch) -> None:
    monkeypatch.setattr(hashing, "_impl", lambda x: _Shapes)


def lanes(fn) -> int:
    """The hash lanes (hash2, hash3 and permutations) that `fn()`
    dispatches."""
    before = {n: observability.total(n) for n in LANES}
    fn()
    return sum(observability.total(n) - before[n] for n in LANES)


def values(*shape) -> np.ndarray:
    """Host limbs of the given shape: a shape-only run never reads them."""
    return np.zeros(shape, dtype=np.int32)


class _Mesh:
    def __init__(self, d: int):
        self.d = d

    def size(self) -> int:
        return self.d

    def get_group(self):
        return None


def mesh_lanes(monkeypatch, depth: int, k: int, d: int, b: int) -> int:
    """The lanes of one chain of `b` shard-local batches of `k` into an
    empty dense tree of `depth` over `d` ranks, summed over the ranks."""
    shape_only(monkeypatch)
    monkeypatch.setattr(
        collectives, "all_gather",
        lambda x, group, dim=None, what="": torch.stack([x] * d)
        if dim is None else torch.cat([x] * d, dim=dim))
    monkeypatch.setattr(collectives, "psum", lambda x, group, what="": x)
    total = 0
    for r in range(d):
        tree = ShardedIndexedMerkleTree.__new__(ShardedIndexedMerkleTree)
        tree._d, tree._r, tree.device, tree.tree_depth = d, r, CPU, depth
        shard = tree._empty_shard(depth)
        arr = torch.zeros((b, field.LIMBS, k), dtype=torch.int32)
        total += lanes(lambda: local_plan.local_insert_batches(
            shard, arr, _Mesh(d), k, b))
    return total
