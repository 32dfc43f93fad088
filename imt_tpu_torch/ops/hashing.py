"""Poseidon dispatch by device: one hash surface for the tree code.

Counterpart of ``imt_tpu.ops.hashing``.  The engine is chosen by the device
of the input tensor and nothing else: a CPU tensor runs the plain torch
version (``poseidon.py``), a CUDA tensor runs the hand-written kernel
(``poseidon_cuda.py``) or raises.  There is one node form (Montgomery,
fully reduced, ``int32[8, B]``), so there is no backend switch and no
``node_repr``.

Canonical limbs are ``int32[16, B]``; nodes are ``int32[8, B]``.
"""

from __future__ import annotations

import torch

from . import poseidon, poseidon_cuda


def _impl(x: torch.Tensor):
    kind = x.device.type
    if kind == "cpu":
        return poseidon
    if kind == "cuda":
        return poseidon_cuda
    raise ValueError(f"no Poseidon implementation for device {x.device}")


def hash2(a, b):
    """Batched 2-to-1 Poseidon hash, canonical limbs in and out."""
    return _impl(a).hash2(a, b)


def hash3(a, b, c):
    """Batched 3-to-1 Poseidon hash (indexed leaf), canonical limbs."""
    return _impl(a).hash3(a, b, c)


def hash_fixed(cols):
    """Batched fixed-length hash of any arity (the halo2-base
    hash_fix_len_array contract; ``imt_tpu.ops.hashing.hash_fixed``,
    :163), canonical limbs int32[16, B] x n in and out.  Arity 2 and 3
    route to ``hash2`` / ``hash3``; any other arity runs the sponge where
    the columns live: the plain version on the CPU, n // 2 + 1 launches of
    the permutation kernel on the card."""
    cols = list(cols)
    if not cols:
        raise ValueError("hash_fixed needs at least one input")
    dev, width = cols[0].device, cols[0].shape[-1]
    if any(c.device != dev or c.shape[-1] != width for c in cols[1:]):
        raise ValueError("hash_fixed: the columns differ in device or width")
    if len(cols) == 2:
        return hash2(*cols)
    if len(cols) == 3:
        return hash3(*cols)
    return _impl(cols[0]).hash_fixed(cols)


def enc_nodes(limbs):
    """Canonical limbs int32[16, B] -> nodes int32[8, B]."""
    return _impl(limbs).limbs_to_nodes(limbs)


def dec_nodes(nodes):
    """Nodes int32[8, B] -> canonical limbs int32[16, B]."""
    return _impl(nodes).nodes_to_limbs(nodes)


def hash2_nodes(a, b):
    """Batched 2-to-1 hash, nodes in and out (every Merkle level)."""
    return _impl(a).hash2_nodes(a, b)


def hash3_leaf(a, b, c):
    """Batched 3-to-1 leaf hash: canonical limbs in, nodes out."""
    return _impl(a).hash3_leaf(a, b, c)
