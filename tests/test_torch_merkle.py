"""imt_tpu_torch's MerkleTree and gates against imt_tpu's (CPU, plain path).

Mirrors tests/test_merkle.py and the gate tests of tests/test_gates_utils.py:
the same numpy-seeded leaves and values go through both packages at depth
<= 3, and every level, root, proof, helper bit and predicate mask must agree
bit for bit (and with the python-int oracle).  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imt_tpu.ops import field as jfield
from imt_tpu.ops import gates as jgates
from imt_tpu.tree import merkle as jmerkle
from imt_tpu_torch import MerkleTree
from imt_tpu_torch.ops import field, gates
from imt_tpu_torch.tree import merkle
from imt_tpu_torch.tree.reference_oracle import OracleTree
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"


def rand_leaves(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % field.P
            for _ in range(n)]


@pytest.fixture(scope="module")
def trees():
    leaves = rand_leaves(1, 8)
    return (leaves, MerkleTree.from_ints(leaves, device=CPU),
            jmerkle.MerkleTree.from_ints(leaves), OracleTree(leaves))


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) \
        .astype(np.int64)


def test_build_matches_imt_tpu_and_oracle(trees):
    _, tt, jt, oracle = trees
    assert tt.depth == jt.depth == 3 and tt.num_leaves == 8
    for d, (a, b) in enumerate(zip(tt.levels, jt.levels)):
        assert np.array_equal(_np(a), _np(b)), d
        assert field.limbs_to_ints(a.numpy()) == oracle.levels[d], d
    assert tt.get_root_int() == jt.get_root_int() == oracle.get_root()


def test_single_leaf_root_is_leaf():
    leaves = rand_leaves(2, 1)
    assert MerkleTree.from_ints(leaves, device=CPU).get_root_int() == \
        leaves[0]


def test_error_contract():
    for n, msg in ((0, "no leaves"), (3, "even"), (6, "power of two")):
        with pytest.raises(ValueError, match=msg):
            MerkleTree.from_ints(rand_leaves(3, n), device=CPU)
        with pytest.raises(ValueError):
            jmerkle.MerkleTree.from_ints(rand_leaves(3, n))


def test_build_defaults_to_the_card():
    leaves = field.ints_to_limbs(rand_leaves(4, 2))
    if torch.cuda.is_available():
        assert MerkleTree.build(leaves).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            MerkleTree.build(leaves)


def test_proofs_match_imt_tpu_and_verify(trees):
    leaves, tt, jt, oracle = trees
    indices = [0, 3, 5, 7]
    pt, ht = tt.get_proofs(indices)
    pj, hj = jt.get_proofs(indices)
    assert np.array_equal(_np(pt), _np(pj))
    assert np.array_equal(_np(ht), _np(hj))
    for j, idx in enumerate(indices):
        oproof, ohelp = oracle.get_proof(idx)
        assert field.limbs_to_ints(pt[:, :, j].T.numpy()) == oproof
        assert ht[:, j].tolist() == ohelp
    leaf_arr = field.ints_to_limbs([leaves[i] for i in indices])
    assert tt.verify_proofs(leaf_arr, indices, tt.get_root(), pt).all()
    p1, h1 = tt.get_proof(5)
    assert p1.shape == (3, 16, 1) and h1.shape == (3, 1)
    assert tt.verify_proof(leaf_arr[:, 2:3], 5, tt.get_root(), p1)


def test_numpy_arguments_verify_on_the_trees_device(trees):
    leaves, tt, jt, _ = trees
    proof, helpers = tt.get_proofs([5])
    leaf = field.ints_to_limbs([leaves[5]])
    root, proof, helpers = (x.numpy() for x in (tt.get_root(), proof,
                                                helpers))
    # a CPU tree verifies numpy arguments on the CPU
    assert tt.verify_proof(leaf, 5, root, proof)
    assert not tt.verify_proof(leaf, 4, root, proof)
    assert jt.verify_proof(leaf.astype(np.uint32), 5,
                           root.astype(np.uint32), proof.astype(np.uint32))
    assert merkle.verify_proofs(leaf, [5], root, proof, device=CPU).all()
    assert gates.verify_merkle_proof(torch.as_tensor(root), leaf, proof,
                                     helpers).tolist() == [True]
    # with no tensor and no device, the functions run on the card
    calls = (lambda: merkle.verify_proofs(leaf, [5], root, proof),
             lambda: merkle.compute_root_from_helpers(leaf, proof, helpers),
             lambda: gates.verify_merkle_proof(root, leaf, proof, helpers))
    if not torch.cuda.is_available():         # the card path: test_torch_cuda
        for call in calls:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_verify_rejects_corruption_like_imt_tpu(trees):
    leaves, tt, jt, _ = trees
    proofs, _ = tt.get_proofs([2, 2, 2, 2])
    leaf = field.ints_to_limbs([leaves[2]] * 4)
    leaf[:, 1] = field.int_to_limbs(leaves[2] ^ 1)         # wrong leaf
    bad = proofs.clone()
    bad[1, 0, 3] ^= 1                                       # bad sibling
    idx = [2, 2, 3, 2]                                      # wrong index
    got = tt.verify_proofs(leaf, idx, tt.get_root(), bad)
    want = jt.verify_proofs(leaf.astype(np.uint32), idx, jt.get_root(),
                            bad.numpy().astype(np.uint32))
    assert got.tolist() == np.asarray(want).tolist() == [True, False, False,
                                                         False]


def test_root_from_helpers_matches_imt_tpu(trees):
    leaves, tt, jt, oracle = trees
    idx = [0, 5, 6]
    proofs, helpers = tt.get_proofs(idx)
    leaf = field.ints_to_limbs([leaves[i] for i in idx])
    got = merkle.compute_root_from_helpers(torch.as_tensor(leaf), proofs,
                                           helpers)
    want = jmerkle.compute_root_from_helpers(
        jnp.asarray(leaf.astype(np.uint32)),
        jnp.asarray(proofs.numpy().astype(np.uint32)),
        jnp.asarray(helpers.numpy()))
    assert np.array_equal(_np(got), _np(want))
    assert field.limbs_to_ints(got.numpy()) == [oracle.get_root()] * 3


# -- gates (tests/test_gates_utils.py) ---------------------------------------

def test_select_and_dual_mux_match_imt_tpu():
    a = field.ints_to_limbs([69, 1, 1])
    b = field.ints_to_limbs([420, 2, 2])
    s = np.array([False, True, False])
    got = gates.select(s, torch.as_tensor(a), torch.as_tensor(b))
    assert field.limbs_to_ints(got.numpy()) == [420, 1, 2]
    assert np.array_equal(got.numpy(), np.asarray(jgates.select(s, a, b)))
    left, right = gates.dual_mux(torch.as_tensor(a), torch.as_tensor(b), s)
    jl, jr = jgates.dual_mux(a, b, s)
    assert np.array_equal(left.numpy(), np.asarray(jl))
    assert np.array_equal(right.numpy(), np.asarray(jr))
    assert field.limbs_to_ints(right.numpy()) == [69, 2, 1]


def test_assert_bit():
    gates.assert_bit(np.array([0, 1, 1]))
    gates.assert_bit(torch.tensor([True, False]))
    for bad in (np.array([0, 2]), torch.tensor([0, 2])):
        with pytest.raises(ValueError):
            gates.assert_bit(bad)


def test_is_less_than_128_split_matches_imt_tpu():
    pow128 = 1 << 128
    cases = [(5, 7), (7, 5), (5, 5),
             (3 * pow128 + 10, 3 * pow128 + 11),
             (2 * pow128 + 9, 5 * pow128 + 1),
             (5 * pow128 + 1, 2 * pow128 + 9),
             # the reference's masked-typo class: equal low, differing high
             (7 * pow128 + 42, 9 * pow128 + 42),
             (9 * pow128 + 42, 7 * pow128 + 42)]
    cases += list(zip(rand_leaves(5, 100), rand_leaves(6, 100)))
    a = field.ints_to_limbs([c[0] for c in cases])
    b = field.ints_to_limbs([c[1] for c in cases])
    got = gates.less_than_254(torch.as_tensor(a), torch.as_tensor(b))
    want = jgates.less_than_254(jnp.asarray(a.astype(np.uint32)),
                                jnp.asarray(b.astype(np.uint32)))
    assert got.tolist() == np.asarray(want).tolist() == [
        x < y for x, y in cases]
    q, r = gates.split_128(torch.as_tensor(a))
    jq, jr = jgates.split_128(jnp.asarray(a))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(r.numpy(), np.asarray(jr))


def test_verify_merkle_proof_gadget_matches_imt_tpu(trees):
    leaves, tt, jt, _ = trees
    proof, helpers = tt.get_proofs([6, 6])
    leaf = field.ints_to_limbs([leaves[6], 12345])
    root = tt.get_root().expand(16, 2)
    got = gates.verify_merkle_proof(root, torch.as_tensor(leaf), proof,
                                    helpers)
    want = jgates.verify_merkle_proof(
        jnp.asarray(root.numpy().astype(np.uint32)),
        jnp.asarray(leaf.astype(np.uint32)),
        jnp.asarray(proof.numpy().astype(np.uint32)),
        jnp.asarray(helpers.numpy()))
    assert got.tolist() == np.asarray(want).tolist() == [True, False]


def test_jax_field_helpers_agree_on_limb_layout():
    # the two packages' host conversions agree, so the comparisons above
    # compare like with like
    xs = rand_leaves(7, 5)
    assert np.array_equal(field.ints_to_limbs(xs),
                          jfield.ints_to_limbs(xs).astype(np.int32))
