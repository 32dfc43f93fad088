"""imt_tpu_torch: the indexed-Merkle-tree engine on PyTorch and CUDA.

The port of ``imt_tpu`` (JAX on a TPU) to PyTorch, with the Poseidon hash
as a hand-written CUDA kernel for Hopper (``ops/csrc/poseidon_bn254.cu``)
and a plain torch version of it for CPU tensors.  Module names mirror
``imt_tpu``'s.  This package imports neither ``jax`` nor ``imt_tpu``; it
picks no device by itself (every entry point takes ``device``, default
"cpu").
"""

from .ops.field import P as FIELD_MODULUS
from .tree.indexed import ZERO_LEAF_HASH, IndexedMerkleTree

__version__ = "0.1.0"

__all__ = ["FIELD_MODULUS", "ZERO_LEAF_HASH", "IndexedMerkleTree"]
