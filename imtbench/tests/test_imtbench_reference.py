"""The plain reference against the spec's anchor and python ints, and
against the program on sound runs (a second witness for both)."""

import random

import numpy as np
import torch

from imtbench.reference import poseidon, tree as ref
from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree


# Poseidon(0, 0, 0), published by the reference circuit's tests
ANCHOR_H000 = \
    1960587138944869480785025106734196872454309951825657414575195034687326603497


def test_anchor_and_lanes_against_python_ints():
    s = poseidon.spec()
    assert poseidon.ANCHOR == ANCHOR_H000
    assert poseidon.hash_int([0, 0, 0]) == ANCHOR_H000
    p = s["p"]
    rng = random.Random(7)
    rows = [[rng.randrange(p) for _ in range(3)] for _ in range(24)] \
        + [[p - 1] * 3, [0, 0, 0], [1, 0, p - 1], [(1 << 254) - 1 - p, 0, 1]]
    h = poseidon.Hasher("cpu")
    cols = [h.to_mont(torch.tensor(poseidon.ints_to_limbs16(
        [r[i] % p for r in rows]))) for i in range(3)]
    assert h.to_ints(h.hash3(*cols)) == [poseidon.hash_int(r) for r in rows]
    assert h.to_ints(h.hash2(*cols[:2])) == \
        [poseidon.hash_int(r[:2]) for r in rows]


def test_constants_agree_with_the_program():
    from imt_tpu_torch.ops.poseidon_ref import generate_params
    s, prog = poseidon.spec(), generate_params()
    assert s["rc"] == [list(r) for r in prog.round_constants]
    assert s["mds"] == [list(r) for r in prog.mds]
    assert len(s["rc"]) == s["r_f"] + s["r_p"] and s["mds"][0][0] != 0


def _values(n, seed):
    rng = np.random.default_rng(seed)
    return poseidon.ints_to_limbs16(
        [int(x) * int(y) for x, y in rng.integers(1, 1 << 62, (n, 2))])


def test_root_and_witness_fields_agree_with_the_program():
    h = poseidon.Hasher("cpu")
    pre, block = _values(10, 1), _values(8, 2)
    block[:, 2] = pre[:, 4]                  # already present: rejected
    block[:, 5] = 0                          # zero: rejected
    block[:, 6] = block[:, 1]                # a repeat in the block
    with torch.inference_mode():
        t = IndexedMerkleTree(6, device="cpu")
        t.insert_batch(pre.astype(np.int32))
        w = t.insert_batch(block.astype(np.int32), witness=True)
        got = {k: v.numpy() if isinstance(v, torch.Tensor) else v
               for k, v in vars(w).items()}
        root = t.get_root_int()
    stream = np.concatenate([pre, block], axis=1)
    assert root == ref.tree_root(h, stream, 6)
    e = ref.insert_expect(pre, block)
    ok = e["ok"]
    assert (got["ok"] == ok).all() and ok.sum() == 5
    for name in ("low_leaf_val", "low_leaf_next_val", "low_leaf_next_idx",
                 "new_leaf_next_val", "new_leaf_next_idx", "new_leaf_index",
                 "is_new_leaf_largest"):
        assert (got[name][..., ok] == e[name][..., ok]).all(), name
    roots = ref.insert_leaf_roots(h, got)
    assert (roots["old"][:, ok] == got["old_root"][:, ok]).all()
    assert (roots["interim"][:, ok] == roots["slot"][:, ok]).all()
    assert (roots["new"][:, ok] == got["new_root"][:, ok]).all()


def test_sparse_root_agrees_with_the_program():
    h = poseidon.Hasher("cpu")
    vals = _values(12, 3)
    with torch.inference_mode():
        t = SparseIndexedMerkleTree(20, initial_capacity_log2=4,
                                    device="cpu")
        t.insert_batches(vals.reshape(16, 2, 6).transpose(1, 0, 2)
                         .astype(np.int32))
        assert t.get_root_int() == ref.tree_root(h, vals, 20)
