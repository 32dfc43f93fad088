"""Pure-python indexed-Merkle-tree oracle (host, python ints).

Mirrors the reference's native witness-generation machinery so device results
can be checked bit-exactly:

* ``update_idx_leaf``  — the sequential insertion planner
  (reference src/indexed_merkle_tree.rs:632-660), including its quirks
  (first-insert special case; silent no-op on duplicates).
* ``hash_preimages``   — leaf hashing H(val, next_val, next_idx)
  (reference src/indexed_merkle_tree.rs:662-671).
* ``OracleTree``       — build/root/proof/verify over python ints
  (reference src/utils.rs).

This plays the role pse-poseidon + the native tree play for the reference's
tests: the slow-but-obviously-correct generator of expected values.  It is a
copy of ``imt_tpu.tree.reference_oracle`` on the port's own python-int
Poseidon, so that a run on a machine without JAX can check a tree against it.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.poseidon_ref import PoseidonParams, generate_params, hash_fixed


@dataclass
class Leaf:
    val: int
    next_val: int
    next_idx: int


def update_idx_leaf(leaves: list[Leaf], new_val: int,
                    new_val_idx: int) -> tuple[list[Leaf], int]:
    """Reference planner semantics (src/indexed_merkle_tree.rs:632-660).
    Returns (updated preimages, low_leaf_idx).  On duplicate/no-fit, returns
    the input unchanged with low_leaf_idx=0 (the reference's fall-through)."""
    out = [Leaf(l.val, l.next_val, l.next_idx) for l in leaves]
    for i, node in enumerate(leaves):
        if node.next_val == 0 and i == 0:
            out[i + 1].val = new_val
            out[i].next_val = new_val
            out[i].next_idx = i + 1
            return out, i
        if node.val < new_val and (node.next_val > new_val or node.next_val == 0):
            out[new_val_idx].val = new_val
            out[new_val_idx].next_val = out[i].next_val
            out[new_val_idx].next_idx = out[i].next_idx
            out[i].next_val = new_val
            out[i].next_idx = new_val_idx
            return out, i
    return out, 0


def hash_preimages(leaves: list[Leaf],
                   params: PoseidonParams | None = None) -> list[int]:
    params = params or generate_params()
    return [hash_fixed([l.val, l.next_val, l.next_idx], params) for l in leaves]


class OracleTree:
    """Dense Poseidon Merkle tree over python ints (reference src/utils.rs)."""

    def __init__(self, leaves: list[int], params: PoseidonParams | None = None):
        if not leaves:
            raise ValueError("no leaves")
        if len(leaves) > 1 and len(leaves) % 2 == 1:
            raise ValueError("leaves must be even")
        self.params = params or generate_params()
        self.levels = [list(leaves)]
        cur = list(leaves)
        while len(cur) > 1:
            cur = [hash_fixed([cur[i], cur[i + 1]], self.params)
                   for i in range(0, len(cur), 2)]
            self.levels.append(cur)

    def get_root(self) -> int:
        return self.levels[-1][0]

    def get_proof(self, index: int) -> tuple[list[int], list[int]]:
        proof, helpers = [], []
        cur = index
        for level in self.levels[:-1]:
            sib = cur + 1 if cur % 2 == 0 else cur - 1
            proof.append(level[sib])
            helpers.append(1 if cur % 2 == 0 else 0)
            cur //= 2
        return proof, helpers

    def verify_proof(self, leaf: int, index: int, root: int,
                     proof: list[int]) -> bool:
        acc = leaf
        cur = index
        for sib in proof:
            acc = (hash_fixed([acc, sib], self.params) if cur % 2 == 0
                   else hash_fixed([sib, acc], self.params))
            cur //= 2
        return acc == root


class OracleIndexedTree:
    """Sequential indexed tree over python ints: the end-to-end oracle for the
    reference's multi-round flow (src/indexed_merkle_tree.rs:679-803)."""

    def __init__(self, depth: int, params: PoseidonParams | None = None):
        self.params = params or generate_params()
        self.depth = depth
        n = 1 << depth
        self.preimages = [Leaf(0, 0, 0) for _ in range(n)]
        self.count = 0
        self._rebuild()

    def _rebuild(self):
        self.tree = OracleTree(hash_preimages(self.preimages, self.params),
                               self.params)

    def get_root(self) -> int:
        return self.tree.get_root()

    def insert(self, new_val: int) -> dict:
        """One sequential insert, reference discipline: plan, rewrite, rebuild,
        witness (old/new roots + proofs).  Returns the witness dict."""
        old_root = self.get_root()
        old_preimages = [Leaf(l.val, l.next_val, l.next_idx)
                         for l in self.preimages]
        slot = self.count + 1
        new_preimages, low_idx = update_idx_leaf(self.preimages, new_val, slot)
        changed = any(
            (a.val, a.next_val, a.next_idx) != (b.val, b.next_val, b.next_idx)
            for a, b in zip(new_preimages, self.preimages))
        low_leaf = old_preimages[low_idx]
        low_proof, low_helpers = self.tree.get_proof(low_idx)
        self.preimages = new_preimages
        self._rebuild()
        new_leaf = self.preimages[slot]
        new_proof, new_helpers = self.tree.get_proof(slot)
        self.count += 1
        return dict(
            ok=changed,
            old_root=old_root,
            low_leaf=(low_leaf.val, low_leaf.next_val, low_leaf.next_idx),
            low_leaf_proof=low_proof, low_leaf_proof_helper=low_helpers,
            new_root=self.get_root(),
            new_leaf=(new_leaf.val, new_leaf.next_val, new_leaf.next_idx),
            new_leaf_index=slot,
            new_leaf_proof=new_proof, new_leaf_proof_helper=new_helpers,
            is_new_leaf_largest=(new_leaf.next_val == 0),
        )
