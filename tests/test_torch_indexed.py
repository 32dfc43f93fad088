"""imt_tpu_torch's dense IndexedMerkleTree.insert_batch against imt_tpu's
(CPU, plain torch path).

One replay of four K=8 batches on a depth-6 tree drives both packages with
the same inputs: the sequence [30,10,20,5,50,35], intra-batch duplicates,
zeros, chains, a duplicate of an existing value, and packed limbs holding
values >= p.  After every batch the ok masks, the leaf state, every level
(decoded to canonical limbs) and the root must agree bit for bit; proofs and
the state carried across with to_arrays / from_arrays too.  The helpers that
stand in for XLA ops are held against XLA.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imt_tpu.ops import hashing as jhashing
from imt_tpu.tree import indexed as jindexed
from imt_tpu_torch import FIELD_MODULUS, ZERO_LEAF_HASH, IndexedMerkleTree
from imt_tpu_torch.ops import hashing
from imt_tpu_torch.tree import indexed

torch.set_num_threads(1)

DEPTH = 6
P = FIELD_MODULUS


def _packed(values) -> np.ndarray:
    """Raw (unreduced) canonical limbs uint32[16, K]."""
    return np.array([[(v >> (16 * i)) & 0xFFFF for v in values]
                     for i in range(16)], dtype=np.uint32)


BATCHES = [
    [30, 10, 20, 5, 50, 35, 0, 10],
    [7, 7, 0, 31, 32, 33, 1, 2],
    [100, 99, 98, 97, 5, 6, 200, 3],
    _packed([P + 5, (1 << 256) - 1, 40, 41, 42, 43, 44, P + 5]),
]


def _state(tree, levels) -> dict:
    return {
        "vals": np.asarray(tree.vals).astype(np.int64),
        "next_vals": np.asarray(tree.next_vals).astype(np.int64),
        "next_idxs": np.asarray(tree.next_idxs).astype(np.int64),
        "levels": levels,
        "root": tree.get_root_int(),
    }


def _split(dec: np.ndarray) -> list:
    """[16, 2N - 1] decoded levels side by side -> one array per level."""
    out, at = [], 0
    for d in range(DEPTH + 1):
        w = (1 << DEPTH) >> d
        out.append(dec[:, at:at + w].astype(np.int64))
        at += w
    return out


def _jax_levels(tree) -> list:
    # one decode of all levels side by side: one XLA compile, not seven
    return _split(np.asarray(jhashing.dec_nodes(
        jnp.concatenate(tree.levels, axis=1))))


def _torch_levels(tree) -> list:
    return _split(hashing.dec_nodes(torch.cat(tree.levels, dim=1)).numpy())


@pytest.fixture(scope="module")
def replay():
    jt = jindexed.IndexedMerkleTree(DEPTH)
    tt = IndexedMerkleTree(DEPTH, device="cpu")
    steps = []
    for b in BATCHES:
        ok_j = np.asarray(jt.insert_batch(b))
        ok_t = tt.insert_batch(b)
        steps.append((ok_j, ok_t, _state(jt, _jax_levels(jt)),
                      _state(tt, _torch_levels(tt))))
    return jt, tt, steps


def test_empty_tree_root():
    t = IndexedMerkleTree(3, device="cpu")
    assert t.get_root_int() == indexed._zero_level_roots(3)[-1]
    assert t.get_leaf_ints(0) == (0, 0, 0)
    assert indexed._zero_level_roots(3)[0] == ZERO_LEAF_HASH


def test_ok_masks_match(replay):
    for i, (ok_j, ok_t, _, _) in enumerate(replay[2]):
        assert ok_t.dtype == bool
        assert ok_t.tolist() == ok_j.tolist(), i
    assert replay[2][0][1].tolist() == [True] * 6 + [False, False]


def test_leaf_state_matches(replay):
    for i, (_, _, sj, st) in enumerate(replay[2]):
        for name in ("vals", "next_vals", "next_idxs"):
            assert np.array_equal(sj[name], st[name]), (i, name)


def test_levels_and_roots_match(replay):
    for i, (_, _, sj, st) in enumerate(replay[2]):
        assert len(sj["levels"]) == len(st["levels"]) == DEPTH + 1
        for d, (a, b) in enumerate(zip(sj["levels"], st["levels"])):
            assert np.array_equal(a, b), (i, d)
        assert sj["root"] == st["root"], i


def test_proofs_match(replay):
    jt, tt, _ = replay
    for slot in (0, 5, 17, 31, 63):
        pj, hj = jt.get_proof(slot)
        pt, ht = tt.get_proof(slot)
        assert pt.shape == (DEPTH, 16, 1) and ht.shape == (DEPTH, 1)
        assert np.array_equal(np.asarray(pj).astype(np.int64),
                              pt.numpy().astype(np.int64)), slot
        assert np.array_equal(np.asarray(hj), ht.numpy()), slot
    assert tt.get_leaf_ints(1) == jt.get_leaf_ints(1)


def test_arrays_carry_state_across(replay):
    jt, tt, _ = replay
    a = jt.to_arrays()
    b = tt.to_arrays()
    assert a.keys() == b.keys()
    for key in a:
        assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key
        assert np.array_equal(a[key], b[key]), key
    t2 = IndexedMerkleTree.from_arrays(a, device="cpu")
    assert t2.count == jt.count
    assert t2.get_root_int() == jt.get_root_int()
    for d in range(DEPTH + 1):
        assert torch.equal(t2.levels[d], tt.levels[d]), d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lex_order_matches_numpy_lexsort(seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, hi, 300) for hi in (5, 3, 1 << 48, 4)]
    want = np.lexsort(keys)
    got = indexed._lex_order([torch.as_tensor(k) for k in keys])
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("start", [-3, 0, 3, 6, 7, 12])
def test_clamped_slices_match_lax(start):
    x = np.arange(3 * 10, dtype=np.int32).reshape(3, 10)
    upd = -np.arange(3 * 4, dtype=np.int32).reshape(3, 4)
    want = jax.lax.dynamic_slice_in_dim(jnp.asarray(x), start, 4, axis=1)
    got = indexed._dynamic_slice(torch.as_tensor(x), start, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    want_u = jax.lax.dynamic_update_slice_in_dim(
        jnp.asarray(x), jnp.asarray(upd), start, axis=1)
    xt = torch.as_tensor(x.copy())
    indexed._dynamic_update_slice(xt, torch.as_tensor(upd), start)
    assert np.array_equal(xt.numpy(), np.asarray(want_u))


def test_helpers_match_imt_tpu():
    idx = np.array([0, 1, 65535, 65536, 2**31 - 1], dtype=np.int32)
    assert np.array_equal(
        indexed.index_to_limbs(torch.as_tensor(idx)).numpy(),
        np.asarray(jindexed.index_to_limbs(jnp.asarray(idx))).astype(np.int32))
    for depth, k in ((6, 8), (24, 4096), (10, 1), (4, 16)):
        assert indexed._crossover(depth, k) == jindexed._crossover(depth, k)
        assert (indexed._batch_hash_count(depth, k)
                == jindexed._batch_hash_count(depth, k))


def test_tree_full_raises():
    t = IndexedMerkleTree(2, device="cpu")
    with pytest.raises(ValueError, match="tree full"):
        t.insert_batch([1, 2, 3, 4])
    assert t.count == 0


def test_bad_inputs_and_unported_paths_raise():
    t = IndexedMerkleTree(2, device="cpu")
    with pytest.raises(ValueError, match="16, K"):
        t.insert_batch(np.zeros((8, 2), dtype=np.uint32))
    with pytest.raises(ValueError, match="2\\^16"):
        t.insert_batch(np.full((16, 1), 1 << 16, dtype=np.int64))
    with pytest.raises(ValueError, match="B, 16, K"):
        t.insert_batches(np.zeros((16, 2), dtype=np.uint32))
    with pytest.raises(ValueError, match="equal length"):
        t.insert_batches([[1], [2, 3]])
    with pytest.raises(ValueError, match="2\\^16"):
        t.insert_batches(np.full((1, 16, 1), -1, dtype=np.int64))
    with pytest.raises(ValueError, match="tree full"):
        t.insert_batch([5, 6, 7, 8], witness=True)
    with pytest.raises(ValueError, match="tree full"):
        t.insert_batches([[5, 6], [7, 8]])
    with pytest.raises(ValueError, match="tree full"):
        t.insert_seq([5, 6, 7, 8])
    assert t.count == 0
    with pytest.raises(ValueError, match="depth"):
        IndexedMerkleTree(0, device="cpu")
