"""imt_tpu_torch's witness-producing batched insert against imt_tpu's (CPU).

Mirrors tests/test_batch_witness.py.  One imt_tpu program, compiled once
for the module: two witness batches of K = 7 into a sparse tree of full
depth 6 whose active prefix holds 2^4 slots.  The first batch is the
reference sequence [30, 10, 20, 5, 50, 35] (with its intra-batch chains:
20 after 10, 35 after 30) and a 200-bit value; the second meets that
state: a present value, a duplicate within the batch, zero, and values
that land between values of the same batch (119 between 50 and 120).
Every field of every lane, rejected lanes included, the ok masks, the
state and the root must agree bit for bit.  The rest is held against the port's own sequential
path (``insert_seq``, already held against imt_tpu): accepted lanes equal
field by field, and a one-value batch equals ``insert``.  Then the
helpers that stand in for XLA ops, one test per hazard: (i) the per-level
merge sort, (ii) the dropped scatters, (iii) the levels updated in place,
(iv) the reversed cummin, (v) rejected lanes (the all-lane comparison).
Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from imt_tpu.tree.sparse import SparseIndexedMerkleTree as JaxSparseTree
from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import field, hashing
from imt_tpu_torch.tree import batch_witness, indexed
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
FULL, ACTIVE = 6, 4
B1 = [30, 10, 20, 5, 50, 35, 2 ** 200]
B2 = [50, 50, 7, 0, 120, 119, 31]
FIELDS = list(indexed.InsertWitness.__dataclass_fields__)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def run():
    jt = JaxSparseTree(FULL, initial_capacity_log2=ACTIVE)
    tt = SparseIndexedMerkleTree(FULL, initial_capacity_log2=ACTIVE,
                                 device=CPU)
    pairs = [(jt.insert_batch(b, witness=True),
              tt.insert_batch(b, witness=True)) for b in (B1, B2)]
    return jt, tt, pairs


@pytest.mark.parametrize("name", FIELDS)
def test_witness_batch_matches_imt_tpu(run, name):
    for wj, wt in run[2]:
        a, b = _np(getattr(wj, name)), _np(getattr(wt, name))
        assert a.shape == b.shape and np.array_equal(a, b), name


def test_masks_state_and_root_match_imt_tpu(run):
    jt, tt, pairs = run
    assert [w.ok.tolist() for _, w in pairs] == [
        [True] * 7, [False, False, True, False, True, True, True]]
    assert pairs[1][1].ok.dtype == bool
    assert pairs[1][1].low_leaf_proof.shape == (FULL, 16, 7)
    a, b = jt.to_arrays(), tt.to_arrays()
    for key in a:
        assert np.array_equal(np.asarray(a[key]), b[key]), key
    root = field.limbs_to_ints(_np(pairs[1][0].new_root))[-1]
    assert tt.get_root_int() == root


def _checked(fn, check):
    def wrapped(*args):
        check(*args)
        return fn(*args)
    return wrapped


def _unique_kept(size, fill, idx, keep, val):
    kept = idx[keep]
    assert kept.unique().numel() == kept.numel()


def _unique_kept_level(level, idx, keep, val):
    assert bool(keep.any())
    _unique_kept(None, None, idx, keep, val)


@pytest.mark.parametrize("values", [[42], [9, 3, 9]])
def test_accepted_lanes_equal_insert_seq(monkeypatch, values):
    """Accepted lanes equal insert_seq's field by field, a one-value batch
    equals insert (rejected lanes are held against imt_tpu above); the
    levels after the batch equal the sequential twin's.  Hazard (ii):
    every dropped scatter of the walk has unique kept targets."""
    monkeypatch.setattr(batch_witness, "_set_kept", _checked(
        batch_witness._set_kept, _unique_kept))
    monkeypatch.setattr(batch_witness, "_scatter_level", _checked(
        batch_witness._scatter_level, _unique_kept_level))
    a, b = IndexedMerkleTree(2, device=CPU), IndexedMerkleTree(2, device=CPU)
    wb = a.insert_batch(values, witness=True)
    ws = b.insert(values[0]) if len(values) == 1 else b.insert_seq(values)
    assert wb.ok.tolist() == ws.ok.tolist() == [True, True, False][
        :len(values)]
    for name in FIELDS[1:]:
        got, want = _np(getattr(wb, name)), _np(getattr(ws, name))
        assert got.shape == want.shape, name
        assert np.array_equal(got[..., wb.ok], want[..., wb.ok]), name
    for x, y in zip(a.levels + [a.vals, a.next_vals, a.next_idxs],
                    b.levels + [b.vals, b.next_vals, b.next_idxs]):
        assert torch.equal(x, y)


def test_debug_witness_fails_fast(monkeypatch):
    monkeypatch.setattr(indexed, "_debug_witness", True)
    t = IndexedMerkleTree(2, device=CPU)
    w = t.insert_batch([9, 11], witness=True)        # checked, passes
    bad = dataclasses.replace(w, new_root=w.new_root ^ 1)
    with pytest.raises(AssertionError, match="inconsistency"):
        indexed.check_insert_witness(bad)


@pytest.mark.parametrize("k", [1, 2, 7, 64])
def test_ansv_prev_matches_brute_force(k):
    rng = np.random.default_rng(k)
    sigma = rng.integers(0, 10, k)
    sigma[rng.random(k) < 0.3] = batch_witness._NEVER
    thr = rng.integers(0, 11, k)
    pos, found = batch_witness._ansv_prev(torch.as_tensor(sigma),
                                          torch.as_tensor(thr))
    for r in range(k):
        hits = [q for q in range(r) if sigma[q] < thr[r]]
        assert bool(found[r]) == bool(hits), r
        assert int(pos[r]) == (hits[-1] if hits else 0), r


def test_hazard_i_merge_order_is_lexicographic_and_stable():
    """One int64 key (node << kb) | key2 sorts like imt_tpu's keys (node,
    key2) with rows in id order on ties, at the widest node (2^32 - 1) and
    kb = 20."""
    rng = np.random.default_rng(1)
    kb, n = 20, 3000
    node = rng.choice([0, 1, 5, 2 ** 31, 2 ** 32 - 1], n)
    key2 = rng.integers(0, 4, n) * (1 << 18) + rng.integers(0, 2, n)
    ns, pid = batch_witness._merge_order(torch.as_tensor(node),
                                         torch.as_tensor(key2), kb)
    want = np.lexsort((np.arange(n), key2, node))
    assert np.array_equal(pid.numpy(), want)
    assert np.array_equal(ns.numpy(), node[want])


def test_hazard_ii_dropped_scatters():
    """_set_kept is jnp .at[where(keep, idx, size)].set(mode="drop");
    _scatter_level writes exactly the kept lanes."""
    rng = np.random.default_rng(2)
    idx = rng.permutation(12)[:10]
    keep = rng.random(10) < 0.5
    keep[3] = True
    val = rng.integers(-5, 5, 10)
    want = np.full(12, -1)
    want[idx[keep]] = val[keep]
    got = batch_witness._set_kept(12, -1, torch.as_tensor(idx),
                                  torch.as_tensor(keep), torch.as_tensor(val))
    assert np.array_equal(got.numpy(), want)
    level = torch.as_tensor(rng.integers(0, 99, (8, 12)))
    vals = torch.as_tensor(rng.integers(100, 199, (8, 10)))
    want = level.clone()
    want[:, idx[keep]] = vals[:, keep]
    batch_witness._scatter_level(level, torch.as_tensor(idx),
                                 torch.as_tensor(keep), vals)
    assert torch.equal(level, want)


def test_hazard_iii_levels_are_read_before_they_are_written():
    """The low path's proof comes from the levels as they were before the
    batch, the new path's from the levels after the low leaf's update, and
    each level is updated in place: one insert into slot 2 of a depth-2
    tree of arbitrary nodes, with slot 0 as its low leaf."""
    rng = np.random.default_rng(3)
    node = lambda w: torch.as_tensor(np.stack([
        field.int_to_node(int(v)) for v in rng.integers(1, 1 << 62, w)],
        axis=1))
    levels = [node(4 >> d) for d in range(3)]
    before = [x.clone() for x in levels]
    upd = node(2)                       # the new slot's leaf, the low leaf
    low, new, low_h, new_h, old_root, new_root = batch_witness._witness_walk(
        levels, torch.tensor([0]), torch.tensor([2]), 2, upd)
    assert torch.equal(low[:, :, 0], torch.stack([before[0][:, 1],
                                                  before[1][:, 1]]))
    assert torch.equal(new[0], before[0][:, 3:4])
    assert torch.equal(new[1], levels[1][:, 0:1])   # the updated low path
    assert not torch.equal(new[1], before[1][:, 0:1])
    assert torch.equal(levels[0][:, [0, 2]], upd[:, [1, 0]])
    assert torch.equal(levels[0][:, [1, 3]], before[0][:, [1, 3]])
    assert torch.equal(old_root, before[2])
    assert torch.equal(levels[2], new_root)
    assert low_h.tolist() == [[1], [1]] and new_h.tolist() == [[1], [0]]


def test_walk_takes_s0_as_a_tensor():
    """The slab's first slot as an int64 scalar tensor (as a CUDA graph of
    the walk needs it) gives the walk's outputs and levels that the int
    gives: three inserts into slots 3..5 of a depth-3 tree of arbitrary
    nodes, the second with the first's new slot as its low leaf."""
    rng = np.random.default_rng(5)
    node = lambda w: torch.as_tensor(np.stack([
        field.int_to_node(int(v)) for v in rng.integers(1, 1 << 62, w)],
        axis=1))
    levels = [node(8 >> d) for d in range(4)]
    l_path, n_path, upd = torch.tensor([0, 3, 0]), torch.tensor([3, 4, 5]), \
        node(6)
    runs = []
    for s0 in (3, n_path[0]):
        lv = [x.clone() for x in levels]
        runs.append((batch_witness._witness_walk(lv, l_path, n_path, s0,
                                                 upd), lv))
    (out_int, lv_int), (out_t, lv_t) = runs
    assert all(torch.equal(a, b) for a, b in zip(out_int, out_t))
    assert all(torch.equal(a, b) for a, b in zip(lv_int, lv_t))
    assert not torch.equal(lv_int[0], levels[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_hazard_iv_scans_match_brute_force(seed):
    mask = np.random.default_rng(seed).random(40) < 0.3
    nxt = indexed._next_true(torch.as_tensor(mask)).tolist()
    prv = indexed._prev_true(torch.as_tensor(mask), -1).tolist()
    for p in range(40):
        after = [q for q in range(p + 1, 40) if mask[q]]
        before = [q for q in range(p) if mask[q]]
        assert nxt[p] == (after[0] if after else 40)
        assert prv[p] == (before[-1] if before else -1)


def test_node_helpers_agree_with_hashing():
    """The spine's cached zero-subtree nodes are the node form of the
    python-int zero roots."""
    sibs = indexed._zero_sib_nodes(2, 5, torch.device(CPU))
    roots = indexed._zero_level_roots(5)
    assert sibs.shape == (3, 8, 1)
    assert field.limbs_to_ints(hashing.dec_nodes(sibs[:, :, 0].T.contiguous())
                               .numpy()) == list(roots[2:5])
