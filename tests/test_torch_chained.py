"""imt_tpu_torch's chained insert_batches against imt_tpu's and against a
loop of insert_batch (CPU).

Mirrors tests/test_chained.py::test_insert_batches_matches_insert_batch.
One imt_tpu program, compiled once for the module: two chained batches of
K = 4 (an intra-batch duplicate, a duplicate of the first batch, zero) into
a sparse tree of full depth 6 with an active prefix of 2^4 slots, from
packed limbs.  The port's sparse tree starts from 2^1 slots, so it grows
on the way; its masks, state and root must equal imt_tpu's.  Then the
port's own paths: insert_batches equals the same batches through
insert_batch one by one, on the dense tree and on the sparse one, whose
active levels equal the dense tree's.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from imt_tpu.tree.sparse import SparseIndexedMerkleTree as JaxSparseTree
from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import field
from imt_tpu_torch.tree import indexed

torch.set_num_threads(1)

CPU = "cpu"
FULL = 6
BATCHES = [[30, 10, 2 ** 250, 10], [2 ** 250, 50, 35, 0]]
PACKED = np.stack([field.ints_to_limbs(b).astype(np.uint32)
                   for b in BATCHES])


@pytest.fixture(scope="module")
def chained():
    jt = JaxSparseTree(FULL, initial_capacity_log2=4)
    oks_j = np.asarray(jt.insert_batches(PACKED))
    tt = SparseIndexedMerkleTree(FULL, initial_capacity_log2=1, device=CPU)
    oks_t = tt.insert_batches(PACKED)
    return jt, tt, oks_j, oks_t


def test_insert_batches_matches_imt_tpu(chained):
    jt, tt, oks_j, oks_t = chained
    assert oks_t.dtype == bool and oks_t.shape == (2, 4)
    assert oks_t.tolist() == oks_j.tolist() == [
        [True, True, True, False], [False, True, True, False]]
    assert tt.active_depth == 4 and tt.count == jt.count == 8
    a, b = jt.to_arrays(), tt.to_arrays()
    assert a.keys() == b.keys()
    for key in a:
        assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key
        assert np.array_equal(np.asarray(a[key]), b[key]), key
    assert tt.get_root_int() == jt.get_root_int()


def test_insert_batches_equals_a_loop_of_insert_batch(chained):
    _, tt, _, oks_t = chained
    a, b = IndexedMerkleTree(4, device=CPU), IndexedMerkleTree(4, device=CPU)
    oks = a.insert_batches(BATCHES)
    loop = np.stack([b.insert_batch(v) for v in BATCHES])
    assert np.array_equal(oks, loop) and np.array_equal(oks, oks_t)
    assert a.count == b.count == tt.count
    for x, y, z in zip(a.levels + [a.vals, a.next_vals, a.next_idxs],
                       b.levels + [b.vals, b.next_vals, b.next_idxs],
                       tt.levels + [tt.vals, tt.next_vals, tt.next_idxs]):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_chained_hash_count_matches_imt_tpu():
    from imt_tpu.tree import indexed as jindexed
    for depth, k, b in ((4, 4, 2), (24, 4096, 8), (21, 65536, 8), (3, 1, 1)):
        assert (indexed._batches_hash_count(depth, k, b)
                == jindexed._batches_hash_count(depth, k, b))
