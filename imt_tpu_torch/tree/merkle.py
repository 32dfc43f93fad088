"""Poseidon Merkle tree over canonical limbs, on torch tensors.

Counterpart of ``imt_tpu.tree.merkle`` (the reference's native tree,
src/utils.rs:6-108):

* ``MerkleTree.build(leaves, device)`` -- bottom-up build, one batched
  ``hashing.hash2`` per level (``imt_tpu``'s jitted loop, ``:41-56``).
* ``get_root`` / ``get_proofs`` / ``get_proof`` -- sibling paths and helper
  bits, helper = 1 iff the path node is a LEFT child.
* ``verify_proofs`` / ``verify_proof`` -- recompute the root by index parity
  (``:60-76``).
* ``compute_root_from_helpers`` -- the helper-bit fold of the circuit
  gadget (``:79-103``; helper = 1 => the running hash goes LEFT).

The error contract is ``imt_tpu``'s (``:117-126``): no leaves, an odd count
above 1, or a count that is not a power of two is rejected; one leaf is its
own root.  Levels are canonical limbs ``int32[16, N >> d]``, leaves first;
the folds run in node form (one encode of leaf and proof, one decode of the
result), which gives the same bits as a fold of ``hashing.hash2``.  A
tree lives on the device it is built on (the card unless the caller asks
for "cpu") and verifies there; the functions run where their tensors live,
on the card for numpy arguments, or on the `device` they are given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field, hashing


def _enc_path(proof: torch.Tensor) -> torch.Tensor:
    """Canonical-limb path [depth, 16, K] -> nodes [depth, 8, K] (one
    encode launch)."""
    d, _, k = proof.shape
    flat = proof.permute(1, 0, 2).reshape(field.LIMBS, d * k).contiguous()
    return hashing.enc_nodes(flat).view(field.WORDS, d, k).permute(1, 0, 2)


def _dec_path(proof: torch.Tensor) -> torch.Tensor:
    """Node path [depth, 8, K] -> canonical limbs [depth, 16, K] (one
    decode launch)."""
    d, _, k = proof.shape
    flat = proof.permute(1, 0, 2).reshape(field.WORDS, d * k).contiguous()
    return hashing.dec_nodes(flat).view(field.LIMBS, d, k).permute(1, 0, 2) \
        .contiguous()


def fold_nodes(leaf: torch.Tensor, sibs: torch.Tensor,
               acc_left: torch.Tensor) -> torch.Tensor:
    """Root of a path in node form: leaf nodes [8, K], sibling nodes
    [depth, 8, K], acc_left bool [depth, K] (the running hash goes left
    where true).  One hash2_nodes launch per level."""
    acc = leaf
    for lvl in range(sibs.shape[0]):
        left = acc_left[lvl].unsqueeze(0)
        acc = hashing.hash2_nodes(torch.where(left, acc, sibs[lvl]),
                                  torch.where(left, sibs[lvl], acc))
    return acc


def _as_limbs(x, device) -> torch.Tensor:
    """Canonical limbs (numpy uint32/int32 or torch) -> int32 on device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64)
                           .astype(np.int32), device=device)


def _device_of(device, *xs) -> torch.device:
    """Where a function runs: `device` if given, else the first torch
    tensor's device, else the card (numpy arrays carry no device, and the
    entry points run on the card unless the caller asks for the CPU)."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def compute_root_from_helpers(leaf, proof, helpers,
                              device=None) -> torch.Tensor:
    """Batched helper-bit root fold (``imt_tpu.tree.merkle``, :101).
    leaf [16, K], proof [depth, 16, K], helpers [depth, K] (int or bool;
    nonzero = the running hash goes LEFT).  Canonical limbs in and out, on
    `device` (default: where the tensor arguments live, the card if none
    is a tensor)."""
    dev = _device_of(device, leaf, proof, helpers)
    acc = hashing.enc_nodes(_as_limbs(leaf, dev))
    if proof.shape[0] == 0:
        return hashing.dec_nodes(acc)
    acc_left = torch.as_tensor(helpers, device=dev) != 0
    return hashing.dec_nodes(
        fold_nodes(acc, _enc_path(_as_limbs(proof, dev)), acc_left))


def verify_proofs(leaves, indices, root, proofs, device=None) -> np.ndarray:
    """Batched verify by index parity (``imt_tpu``'s ``_verify_fn``,
    :60-76) -> bool[K].  leaves [16, K], indices int [K], root [16, K] or
    [16, 1], proofs [depth, 16, K]; runs on `device` (default: where the
    tensor arguments live, the card if none is a tensor)."""
    dev = _device_of(device, proofs, leaves, root)
    leaves = _as_limbs(leaves, dev)
    k = leaves.shape[1]
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=dev)
    depth = proofs.shape[0]
    acc_left = ((idx[None] >> torch.arange(depth, device=dev)[:, None]) & 1) \
        == 0
    root = _as_limbs(root, dev).expand(field.LIMBS, k)
    acc = hashing.enc_nodes(leaves)
    if depth:
        acc = fold_nodes(acc, _enc_path(_as_limbs(proofs, dev)), acc_left)
    return field.eq(hashing.dec_nodes(acc), root).cpu().numpy()


class MerkleTree:
    """Poseidon Merkle tree over canonical limb arrays on one device."""

    def __init__(self, levels: list):
        self.levels = levels  # levels[0] = leaves ... levels[-1] = [16, 1]

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, leaves, device="cuda") -> "MerkleTree":
        """leaves: canonical limbs [16, N] (numpy or torch), N 1 or a power
        of two; the tree is built on `device`."""
        leaves = _as_limbs(leaves, device)
        n = leaves.shape[1]
        if n == 0:
            raise ValueError("Cannot create Merkle Tree with no leaves")
        if n == 1:
            return cls([leaves])
        if n % 2 == 1:
            raise ValueError("Leaves must be even")
        if n & (n - 1):
            raise ValueError("Leaf count must be a power of two")
        levels = [leaves]
        while levels[-1].shape[1] > 1:
            cur = levels[-1]
            levels.append(hashing.hash2(cur[:, 0::2].contiguous(),
                                        cur[:, 1::2].contiguous()))
        return cls(levels)

    @classmethod
    def from_ints(cls, values: list, device="cuda") -> "MerkleTree":
        return cls.build(field.ints_to_limbs(values), device)

    # -- queries --------------------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    @property
    def num_leaves(self) -> int:
        return int(self.levels[0].shape[1])

    @property
    def device(self) -> torch.device:
        return self.levels[0].device

    def get_root(self) -> torch.Tensor:
        """Root as canonical limbs [16, 1]."""
        return self.levels[-1]

    def get_root_int(self) -> int:
        return field.limbs_to_int(self.get_root()[:, 0].cpu())

    def get_proofs(self, indices):
        """indices int [K] -> (proof [depth, 16, K], helpers int32
        [depth, K]); helpers[d] = 1 iff the path node at level d is a left
        child."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=self.device)
        proof, helpers = [], []
        for d in range(self.depth):
            proof.append(self.levels[d][:, idx ^ 1])
            helpers.append(((idx & 1) == 0).to(torch.int32))
            idx = idx >> 1
        if not proof:
            k = idx.shape[0]
            return (torch.zeros((0, field.LIMBS, k), dtype=torch.int32,
                                device=self.device),
                    torch.zeros((0, k), dtype=torch.int32,
                                device=self.device))
        return torch.stack(proof), torch.stack(helpers)

    def get_proof(self, index: int):
        """Single proof, the reference API (src/utils.rs:63-85)."""
        return self.get_proofs([index])

    def verify_proofs(self, leaves, indices, root, proofs) -> np.ndarray:
        """Batched verify by index parity (src/utils.rs:87-107) -> bool[K],
        on the tree's device."""
        return verify_proofs(leaves, indices, root, proofs, self.device)

    def verify_proof(self, leaf, index: int, root, proof) -> bool:
        return bool(self.verify_proofs(leaf, [index], root, proof)[0])
