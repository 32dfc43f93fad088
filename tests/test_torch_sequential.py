"""imt_tpu_torch's sequential witness path against imt_tpu's (CPU).

Mirrors tests/test_golden_path.py, tests/test_non_inclusion.py and the
sequential half of tests/test_indexed.py at depth <= 4: the same values go
through both packages, and every field of every InsertWitness /
NonInclusionWitness lane -- rejected lanes included -- and every predicate
mask, on honest and on corrupted witnesses, must agree bit for bit.  The
port's tree starts from imt_tpu's ``to_arrays`` (so ``from_arrays`` and the
live-slot bound are on the path).  Then one test for each hazard of the
port: (e) a rejected insert writes nothing, (f) the new-leaf proof is taken
after the low leaf's update, (g) merged dirty paths, (h) the low-leaf
search.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imt_tpu.tree import indexed as jindexed
from imt_tpu_torch import IndexedMerkleTree
from imt_tpu_torch.ops import field, hashing
from imt_tpu_torch.tree import indexed, merkle
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
DEPTH = 4
FIRST = [7, 100]
# duplicate of a present value, zero, a duplicate within the run, a new
# smallest and a new largest value
VALS = [30, 10, 7, 0, 20, 30, 5, 2 ** 200]
QUERIES = [5, 6, 40, 101, 0, 1, 100, 2 ** 253]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def _jax_insert_leaf(w):
    return np.asarray(jindexed.insert_leaf(
        w.old_root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper, w.new_root,
        w.new_leaf_val, w.new_leaf_next_val, w.new_leaf_next_idx,
        jnp.asarray(np.asarray(w.new_leaf_index)), w.new_leaf_proof,
        w.new_leaf_proof_helper, jnp.asarray(np.asarray(
            w.is_new_leaf_largest))))


def _port_insert_leaf(w):
    return indexed.insert_leaf(
        w.old_root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper, w.new_root,
        w.new_leaf_val, w.new_leaf_next_val, w.new_leaf_next_idx,
        w.new_leaf_index, w.new_leaf_proof, w.new_leaf_proof_helper,
        w.is_new_leaf_largest).numpy()


@pytest.fixture(scope="module")
def run():
    jt = jindexed.IndexedMerkleTree(DEPTH)
    jt.insert_batch(FIRST)
    tt = IndexedMerkleTree.from_arrays(jt.to_arrays(), device=CPU)
    wj, wt = jt.insert_seq(VALS), tt.insert_seq(VALS)
    nj = jt.non_inclusion_witness(QUERIES)
    nt = tt.non_inclusion_witness(QUERIES)
    return jt, tt, wj, wt, nj, nt


@pytest.mark.parametrize("name",
                         list(indexed.InsertWitness.__dataclass_fields__))
def test_insert_seq_witness_matches_imt_tpu(run, name):
    _, _, wj, wt, _, _ = run
    a, b = _np(getattr(wj, name)), _np(getattr(wt, name))
    assert a.shape == b.shape and np.array_equal(a, b)


def test_insert_seq_state_and_masks(run):
    jt, tt, wj, wt, _, _ = run
    assert wt.ok.dtype == bool
    assert wt.ok.tolist() == [True, True, False, False, True, False, True,
                              True]
    assert tt.get_root_int() == jt.get_root_int() and tt.count == jt.count
    for name in ("vals", "next_vals", "next_idxs"):
        assert np.array_equal(_np(getattr(tt, name)),
                              _np(getattr(jt, name))), name


@pytest.mark.parametrize(
    "name", list(indexed.NonInclusionWitness.__dataclass_fields__))
def test_non_inclusion_witness_matches_imt_tpu(run, name):
    _, _, _, _, nj, nt = run
    a, b = _np(getattr(nj, name)), _np(getattr(nt, name))
    assert a.shape == b.shape and np.array_equal(a, b)


def _corrupt(w, make):
    """Lane 0 honest; lane 1 a flipped low-proof sibling, lane 4 a wrong
    new root, lane 6 a wrong new-leaf index, lane 7 a flipped new-proof
    sibling."""
    out = {k: np.array(_np(getattr(w, k))) for k in
           ("low_leaf_proof", "new_root", "new_leaf_index", "new_leaf_proof")}
    out["low_leaf_proof"][2, 0, 1] ^= 1
    out["new_root"][0, 4] ^= 1
    out["new_leaf_index"][6] += 1
    out["new_leaf_proof"][0, 3, 7] ^= 1
    return {k: make(v) for k, v in out.items()}


def test_insert_leaf_masks_match_imt_tpu(run):
    _, _, wj, wt, _, _ = run
    honest_j, honest_t = _jax_insert_leaf(wj), _port_insert_leaf(wt)
    assert honest_t.tolist() == honest_j.tolist() == wt.ok.tolist()
    wj.__dict__.update(_corrupt(wj, lambda a: jnp.asarray(
        a.astype(np.int32 if a.ndim == 1 else np.uint32))))
    wt2 = indexed.InsertWitness(**{**wt.__dict__, **_corrupt(
        wt, lambda a: torch.as_tensor(a.astype(np.int32)))})
    bad_j, bad_t = _jax_insert_leaf(wj), _port_insert_leaf(wt2)
    assert bad_t.tolist() == bad_j.tolist()
    assert not bad_t[[1, 4, 6, 7]].any() and bad_t[0]


def test_verify_non_inclusion_masks_match_imt_tpu(run):
    _, _, _, _, nj, nt = run
    q = field.ints_to_limbs(QUERIES)
    args_j = [nj.root, nj.low_leaf_val, nj.low_leaf_next_val,
              nj.low_leaf_next_idx, nj.low_leaf_proof,
              nj.low_leaf_proof_helper, jnp.asarray(q.astype(np.uint32)),
              nj.is_new_leaf_largest]
    args_t = [nt.root, nt.low_leaf_val, nt.low_leaf_next_val,
              nt.low_leaf_next_idx, nt.low_leaf_proof,
              nt.low_leaf_proof_helper, torch.as_tensor(q),
              nt.is_new_leaf_largest]
    got = indexed.verify_non_inclusion(*args_t).numpy()
    assert got.tolist() == np.asarray(
        jindexed.verify_non_inclusion(*args_j)).tolist()
    assert got[nt.ok].all()
    # another value against lane 0's witness, and a flipped sibling
    args_j[6] = jnp.asarray(field.ints_to_limbs([41] * 8).astype(np.uint32))
    args_t[6] = torch.as_tensor(field.ints_to_limbs([41] * 8))
    bad = np.array(_np(nt.low_leaf_proof))
    bad[1, 0, 2] ^= 1
    args_j[4] = jnp.asarray(bad.astype(np.uint32))
    args_t[4] = torch.as_tensor(bad.astype(np.int32))
    got = indexed.verify_non_inclusion(*args_t).numpy()
    assert got.tolist() == np.asarray(
        jindexed.verify_non_inclusion(*args_j)).tolist()
    assert not got[2]


def test_insert_seq_equals_a_loop_of_insert():
    a, b = IndexedMerkleTree(3, device=CPU), IndexedMerkleTree(3, device=CPU)
    seq = a.insert_seq([5, 5])              # accepted, then rejected
    loop = [b.insert(v) for v in (5, 5)]
    for name in indexed.InsertWitness.__dataclass_fields__:
        got = _np(getattr(seq, name))
        want = np.concatenate([_np(getattr(w, name)) for w in loop], axis=-1)
        assert np.array_equal(got, want), name
    assert a.get_root_int() == b.get_root_int()


def _leaf_hashes(preimages):
    cols = [field.ints_to_limbs([p[i] for p in preimages]) for i in range(3)]
    return hashing.hash3(*[torch.as_tensor(c) for c in cols])


def test_reference_golden_path():
    """tests/test_golden_path.py: a 254-bit value inserted as the largest
    element, then 42 as a middle one; each witness equals the one built by
    the reference's discipline (manual bookkeeping and a full MerkleTree
    rebuild) and satisfies insert_leaf."""
    rng = np.random.default_rng(9)
    a = int.from_bytes(rng.bytes(32), "little") % (1 << 254) % field.P
    t = IndexedMerkleTree(3, device=CPU)
    steps = [
        ([(0, 0, 0)] * 8, [(0, a, 1), (a, 0, 0)] + [(0, 0, 0)] * 6,
         a, (0, 0, 0), (a, 0, 0), 1, True),
        ([(0, a, 1), (a, 0, 0)] + [(0, 0, 0)] * 6,
         [(0, 42, 2), (a, 0, 0), (42, a, 1)] + [(0, 0, 0)] * 5,
         42, (0, a, 1), (42, a, 1), 2, False),
    ]
    for before, after, value, low, new, index, largest in steps:
        t0 = merkle.MerkleTree.build(_leaf_hashes(before), device=CPU)
        t1 = merkle.MerkleTree.build(_leaf_hashes(after), device=CPU)
        w = t.insert(value)
        ints = lambda x: field.limbs_to_ints(x.numpy())
        assert w.ok.tolist() == [True]
        assert ints(w.old_root) == [t0.get_root_int()]
        assert ints(w.new_root) == [t1.get_root_int()]
        assert (ints(w.low_leaf_val)[0], ints(w.low_leaf_next_val)[0],
                ints(w.low_leaf_next_idx)[0]) == low
        assert (ints(w.new_leaf_val)[0], ints(w.new_leaf_next_val)[0],
                ints(w.new_leaf_next_idx)[0]) == new
        assert w.new_leaf_index.tolist() == [index]
        assert w.is_new_leaf_largest.tolist() == [largest]
        for proof, helper, tree, slot in (
                (w.low_leaf_proof, w.low_leaf_proof_helper, t0, 0),
                (w.new_leaf_proof, w.new_leaf_proof_helper, t1, index)):
            p, h = tree.get_proof(slot)
            assert torch.equal(proof, p) and torch.equal(helper, h)
        assert _port_insert_leaf(w).all()
    assert t.get_root_int() == t1.get_root_int()


def _state(tree):
    return [x.clone() for x in (tree.vals, tree.next_vals, tree.next_idxs)] \
        + [lvl.clone() for lvl in tree.levels]


def test_hazard_e_rejected_insert_writes_nothing():
    t = IndexedMerkleTree(3, device=CPU)
    t.insert_batch([10, 20])
    before = _state(t)
    w = t.insert(10)                          # a duplicate: rejected
    assert w.ok.tolist() == [False] and t.count == 3
    assert all(torch.equal(a, b) for a, b in zip(before, _state(t)))
    # the witness still carries the hypothetical new root, as imt_tpu's
    assert not torch.equal(w.new_root, w.old_root)
    assert field.limbs_to_ints(w.old_root.numpy()) == [t.get_root_int()]


def test_hazard_f_new_leaf_proof_is_taken_after_the_low_leaf_update():
    t = IndexedMerkleTree(2, device=CPU)
    old_proof, _ = t.get_proof(1)
    w = t.insert(9)              # low leaf 0 and new slot 1 are siblings
    new_leaf = hashing.hash3(w.new_leaf_val, w.new_leaf_next_val,
                             w.new_leaf_next_idx)
    root = lambda p: merkle.compute_root_from_helpers(
        new_leaf, p, w.new_leaf_proof_helper)
    assert torch.equal(root(w.new_leaf_proof), w.new_root)
    assert not torch.equal(w.new_leaf_proof, old_proof)
    assert not torch.equal(root(old_proof), w.new_root)
    assert torch.equal(t.get_proof(1)[0], w.new_leaf_proof)


def test_hazard_g_merged_paths_write_identical_values(run):
    _, tt, _, _, _, _ = run
    # the levels after the inserts equal a full rebuild from the leaves
    leaves = hashing.hash3_leaf(tt.vals, tt.next_vals, tt.next_idxs)
    for d, lvl in enumerate(indexed._build_levels(leaves, DEPTH)):
        assert torch.equal(lvl, tt.levels[d]), d
    # two sibling slots: their paths share every node from level 1 up
    pair = torch.tensor([2, 3])
    leaf = hashing.hash3_leaf(*[
        torch.as_tensor(field.ints_to_limbs([v, v + 1])) for v in (4, 5, 6)])
    idx, nodes, _, _, new_sibs = indexed._update_paths(tt.levels, pair, leaf,
                                                       DEPTH)
    assert torch.equal(new_sibs[0][:, 0], leaf[:, 1])
    for d in range(1, DEPTH + 1):
        assert idx[d, 0] == idx[d, 1]
        assert torch.equal(nodes[d][:, 0], nodes[d][:, 1]), d


def test_hazard_h_low_leaf_search():
    vals = torch.as_tensor(field.ints_to_limbs([0, 10, 30, 0, 20, 0]))
    nvs = torch.as_tensor(field.ints_to_limbs([10, 20, 0, 0, 30, 0]))
    for v, want in ((15, (True, 1)), (5, (True, 0)), (40, (True, 2)),
                    (20, (False, 0)), (0, (False, 0))):
        ok, low = indexed._low_leaf(vals, nvs, torch.as_tensor(
            field.ints_to_limbs([v])))
        assert (bool(ok), int(low)) == want, v
    # a malformed list with two candidates: the first wins, as jnp.argmax
    nvs2 = nvs.clone()
    nvs2[:, 4] = torch.as_tensor(field.int_to_limbs(0))
    ok, low = indexed._low_leaf(vals, nvs2, torch.as_tensor(
        field.ints_to_limbs([35])))
    assert bool(ok) and int(low) == 2
    # the comparisons stay in int32 / bool: nothing wider than the inputs
    assert field.less_than(vals, vals[:, :1]).dtype == torch.bool


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert IndexedMerkleTree(2).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        IndexedMerkleTree(2)
    with pytest.raises((AssertionError, RuntimeError)):
        IndexedMerkleTree.from_arrays(
            IndexedMerkleTree(2, device=CPU).to_arrays())


def test_debug_witness_fails_fast(monkeypatch):
    monkeypatch.setattr(indexed, "_debug_witness", True)
    t = IndexedMerkleTree(2, device=CPU)
    t.insert(3)                                        # an honest witness
    monkeypatch.setattr(indexed, "insert_leaf",
                        lambda *a: torch.zeros(1, dtype=torch.bool))
    with pytest.raises(AssertionError, match="insert_leaf"):
        t.insert(4)
    indexed.set_debug_witness(False)
    assert not indexed.debug_witness_enabled()
