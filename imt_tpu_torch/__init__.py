"""imt_tpu_torch: the indexed-Merkle-tree engine on PyTorch and CUDA.

The port of ``imt_tpu`` (JAX on a TPU) to PyTorch, with the Poseidon hash
and the elementwise throughput probe as hand-written CUDA kernels for Hopper
(``ops/csrc/``) and a plain torch version of each for CPU tensors.  Module
names mirror ``imt_tpu``'s.  This package imports neither ``jax`` nor
``imt_tpu``.  Its entry points run on the card: a tree, a Merkle tree and
the probe take ``device``, default "cuda", and run on the CPU only when the
caller passes ``device="cpu"``; functions that take tensors run where their
tensors live.  ``ShardedIndexedMerkleTree`` (``parallel/``) spreads one tree
over the ranks of a ``torch.distributed`` mesh.  ``hashing`` is the Poseidon
surface by device (``hash2``, ``hash3``, ``hash_fixed`` of any arity), and
``native.oracle`` an independent C++ implementation on the host CPU that
the port is held against.
"""

from .ops import hashing
from .ops.field import P as FIELD_MODULUS
from .tree.indexed import (ZERO_LEAF_HASH, IndexedMerkleTree, InsertWitness,
                           NonInclusionWitness, insert_leaf,
                           verify_non_inclusion)
from .tree.merkle import MerkleTree
from .tree.sparse import SparseIndexedMerkleTree
from .parallel.sharded import ShardedIndexedMerkleTree

__version__ = "0.2.0"

__all__ = ["FIELD_MODULUS", "ZERO_LEAF_HASH", "IndexedMerkleTree",
           "InsertWitness", "NonInclusionWitness", "MerkleTree",
           "ShardedIndexedMerkleTree", "SparseIndexedMerkleTree", "hashing",
           "insert_leaf", "verify_non_inclusion"]
