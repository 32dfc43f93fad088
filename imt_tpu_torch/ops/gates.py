"""Gadget-level ops mirroring the reference chip's constraint-layer surface.

Counterpart of ``imt_tpu.ops.gates`` (``:29-89``).  The reference builds
its circuit from halo2-base GateChip/RangeChip gadgets
(src/indexed_merkle_tree.rs:32-125); here they are plain batched
computations with the same semantics:

| reference                                  | here                      |
|--------------------------------------------|---------------------------|
| select (s*a + (1-s)*b, :33-45)             | select                    |
| dual_mux (cond swap, :47-63)               | dual_mux                  |
| compute_merkle_root (:78-96)               | tree.merkle.compute_root_from_helpers |
| verify_merkle_proof (:65-76)               | verify_merkle_proof       |
| is_less_than (128-bit limb split, :98-125) | is_less_than / split_128  |
| gate.is_equal / is_zero                    | field.eq / field.is_zero  |
| assert_bit                                 | assert_bit                |

Value arguments are canonical limb tensors int32[16, K]; each function
runs where its tensors live (``verify_merkle_proof`` also takes numpy, and
runs on the card when no argument is a tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from . import field
from ..tree.merkle import _as_limbs, _device_of, compute_root_from_helpers


def assert_bit(s) -> None:
    """Debug-mode analog of gate.assert_bit: raises on non-boolean input
    (tensor or numpy)."""
    arr = s.cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)
    if arr.dtype != bool and not ((arr == 0) | (arr == 1)).all():
        raise ValueError("selector is not a bit")


def select(s, a, b):
    """s ? a : b per lane (reference select: s*a + (1-s)*b,
    src/indexed_merkle_tree.rs:33-45; s=1 -> a)."""
    return field.select(s, a, b)


def dual_mux(a, b, switch):
    """Conditional swap (reference dual_mux, src/indexed_merkle_tree.rs:47-63):
    switch=1 -> (a, b); switch=0 -> (b, a).  Returns (left, right)."""
    return field.select(switch, a, b), field.select(switch, b, a)


def verify_merkle_proof(root, leaf, proof, proof_helper):
    """Helper-bit Merkle verification (reference verify_merkle_proof,
    src/indexed_merkle_tree.rs:65-76) -> bool[K], where the tensor
    arguments live (on the card if none is a tensor)."""
    dev = _device_of(None, root, leaf, proof, proof_helper)
    return field.eq(compute_root_from_helpers(leaf, proof, proof_helper, dev),
                    _as_limbs(root, dev))


def split_128(a):
    """Split canonical values at 2^128: returns (q, r) as full-width limb
    arrays (the witness decomposition of reference verify_non_inclusion,
    src/indexed_merkle_tree.rs:145-173)."""
    zeros = torch.zeros_like(a[:8])
    return torch.cat([a[8:], zeros]), torch.cat([a[:8], zeros])


def is_less_than(a_q, a_r, b_q, b_r):
    """The reference's 254-bit comparator over 128-bit limb pairs
    (src/indexed_merkle_tree.rs:98-125):
        a < b  <=>  (a_q < b_q) | ((a_q == b_q) & (a_r < b_r))
    computed with the same boolean expansion (with the `a_r == b_q` typo of
    the reference's native test at :617 fixed, as in ``imt_tpu``)."""
    is_ll_msb = field.less_than(a_q, b_q)
    are_msb_eq = field.eq(a_q, b_q)
    is_ll_lsb = field.less_than(a_r, b_r)
    are_lsb_eq = field.eq(a_r, b_r)
    lhs = is_ll_msb & ~are_msb_eq
    rhs = (~is_ll_msb) & is_ll_lsb & are_msb_eq & ~are_lsb_eq
    return lhs | rhs


def less_than_254(a, b):
    """Direct 254-bit compare through the 128-bit split path (equivalent to
    field.less_than; exposed for parity with the reference's decomposition)."""
    aq, ar = split_128(a)
    bq, br = split_128(b)
    return is_less_than(aq, ar, bq, br)
