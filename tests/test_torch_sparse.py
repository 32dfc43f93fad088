"""imt_tpu_torch's SparseIndexedMerkleTree (CPU).

Mirrors tests/test_sparse.py (its checkpoint half is not ported): the
sparse tree equals the dense tree of the same full depth through
insert_seq, insert_batch(witness=True) and growth, field by field; a
depth-32 root equals the python-int fold of the active prefix over the
zero-subtree spine; proofs and non-inclusion witnesses are of the full
depth; snapshots load across the two packages (imt_tpu loads the port's
and hands back its own, which the port loads: one small imt_tpu program
set, compiled once for the module); the entry point defaults to the card.
Batched and chained inserts are in test_torch_chained.py.  Tolerance:
exact.
"""

import numpy as np
import pytest
import torch

from imt_tpu.tree.sparse import SparseIndexedMerkleTree as JaxSparseTree
from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import field
from imt_tpu_torch.ops.poseidon_ref import hash_fixed
from imt_tpu_torch.ops.poseidon_spec import default_params
from imt_tpu_torch.tree import indexed, merkle

torch.set_num_threads(1)

CPU = "cpu"
FIELDS = list(indexed.InsertWitness.__dataclass_fields__)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def _state(t) -> list:
    return [t.vals, t.next_vals, t.next_idxs] + t.levels


def test_sparse_equals_dense_sequential_witness_and_growth():
    """Depth 2: one insert_seq value on an active prefix of 2 slots (the
    spine folds one level), then a witness batch that grows the prefix to
    the whole tree; every witness field and the state equal the dense
    tree's."""
    dense = IndexedMerkleTree(2, device=CPU)
    sparse = SparseIndexedMerkleTree(2, initial_capacity_log2=1, device=CPU)
    pairs = [(dense.insert_seq([30]), sparse.insert_seq([30]))]
    assert sparse.active_depth == 1
    pairs.append((dense.insert_batch([10, 20], witness=True),
                  sparse.insert_batch([10, 20], witness=True)))
    assert sparse.active_depth == 2
    for wd, ws in pairs:
        assert ws.ok.all() and ws.low_leaf_proof.shape[0] == 2
        for name in FIELDS:
            a, b = _np(getattr(wd, name)), _np(getattr(ws, name))
            assert a.shape == b.shape and np.array_equal(a, b), name
    for x, y in zip(_state(dense), _state(sparse)):
        assert torch.equal(x, y)
    assert sparse.get_root_int() == dense.get_root_int()


def test_depth32_root_is_the_python_fold():
    """A depth-32 tree (a dense level 0 would hold 2^32 leaves): its root
    equals the python-int fold of the active leaves' hashes over the
    zero-subtree spine."""
    t = SparseIndexedMerkleTree(32, initial_capacity_log2=2, device=CPU)
    assert t.insert_batch([2 ** 253, 7, 99]).all()
    params = default_params()
    level = [hash_fixed(list(t.get_leaf_ints(i)), params) for i in range(4)]
    for _ in range(2):
        level = [hash_fixed(level[i:i + 2], params)
                 for i in range(0, len(level), 2)]
    zero = [hash_fixed([0, 0, 0], params)]
    for _ in range(31):
        zero.append(hash_fixed([zero[-1]] * 2, params))
    root = level[0]
    for d in range(2, 32):
        root = hash_fixed([root, zero[d]], params)
    assert t.get_root_int() == root
    assert indexed._zero_level_roots(32)[2:] == tuple(zero[2:]) + (
        hash_fixed([zero[-1]] * 2, params),)


@pytest.fixture(scope="module")
def loaded():
    """A port snapshot (depth 6, active prefix 2^3, four values) through
    imt_tpu and back."""
    t = SparseIndexedMerkleTree(6, initial_capacity_log2=3, device=CPU)
    t.insert_batch([30, 10, 20, 2 ** 200])
    jt = JaxSparseTree.from_arrays(t.to_arrays())
    back = SparseIndexedMerkleTree.from_arrays(jt.to_arrays(), device=CPU)
    return t, jt, back, t.get_root()


def test_snapshots_load_across_packages(loaded):
    """imt_tpu rebuilds the port's snapshot to the same root; the port
    rebuilds imt_tpu's to the same state and levels."""
    t, jt, back, root = loaded
    a, b = t.to_arrays(), jt.to_arrays()
    assert a.keys() == b.keys() and int(a["sparse"]) == 1
    for key in a:
        assert np.array_equal(a[key], np.asarray(b[key])), key
    assert jt.active_depth == back.active_depth == 3
    assert jt.count == back.count == 4
    assert jt.get_root_int() == field.limbs_to_int(root[:, 0])
    for x, y in zip(_state(t), _state(back)):
        assert torch.equal(x, y)
    assert back._live == t._live == 5


def test_proof_api_symmetry(loaded):
    """get_proof / verify_proofs / packed non_inclusion_witness give
    full-depth paths: the active path, then the zero-subtree hashes with
    helper 1; a corrupted proof fails."""
    t, root = loaded[0], loaded[3]
    proof, helpers = t.get_proof(1)
    assert proof.shape == (6, field.LIMBS, 1) and helpers.shape == (6, 1)
    assert helpers[3:, 0].tolist() == [1, 1, 1]
    assert field.limbs_to_ints(_np(proof[3:, :, 0].T)) == list(
        indexed._zero_level_roots(6)[3:6])
    leaf = torch.as_tensor(field.ints_to_limbs([hash_fixed(
        list(t.get_leaf_ints(1)), default_params())]))
    bad = proof.clone()
    bad[4, 0, 0] ^= 1
    got = merkle.verify_proofs(leaf.expand(16, 2), [1, 1], root,
                               torch.cat([proof, bad], dim=2))
    assert got.tolist() == [True, False]
    w = t.non_inclusion_witness(field.ints_to_limbs([15, 30]))
    assert w.ok.tolist() == [True, False]
    assert w.low_leaf_proof.shape == (6, field.LIMBS, 2)
    assert torch.equal(w.root, root.expand(16, 2))


def test_from_arrays_checks_the_width():
    t = SparseIndexedMerkleTree(3, initial_capacity_log2=1, device=CPU)
    a = t.to_arrays()
    with pytest.raises(ValueError, match="2\\^3 slots"):
        IndexedMerkleTree.from_arrays(a, device=CPU)
    a["vals"] = a["vals"][:, :1]
    with pytest.raises(ValueError, match="slots"):
        SparseIndexedMerkleTree.from_arrays(a, device=CPU)
    with pytest.raises(ValueError, match="tree full"):
        t.insert_batch(list(range(1, 9)))
    with pytest.raises(ValueError, match="depth"):
        SparseIndexedMerkleTree(0, device=CPU)


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        assert SparseIndexedMerkleTree(2).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        SparseIndexedMerkleTree(2)
    with pytest.raises((AssertionError, RuntimeError)):
        SparseIndexedMerkleTree.from_arrays(
            SparseIndexedMerkleTree(2, device=CPU).to_arrays())
