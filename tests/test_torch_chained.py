"""imt_tpu_torch's chained insert_batches against imt_tpu's and against a
loop of insert_batch (CPU).

Mirrors tests/test_chained.py::test_insert_batches_matches_insert_batch.
One imt_tpu program, compiled once for the module: two chained batches of
K = 4 (an intra-batch duplicate, a duplicate of the first batch, zero) into
a sparse tree of full depth 6 with an active prefix of 2^4 slots, from
packed limbs.  The port's sparse tree starts from 2^1 slots, so it grows
on the way; its masks, state and root must equal imt_tpu's, and so must
its non-inclusion witnesses of four queries on that state.  Then the
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
from _torch_inference import inference_mode  # noqa: F401
import _torch_lanes

torch.set_num_threads(1)

CPU = "cpu"
FULL = 6
BATCHES = [[30, 10, 2 ** 250, 10], [2 ** 250, 50, 35, 0]]
PACKED = np.stack([field.ints_to_limbs(b).astype(np.uint32)
                   for b in BATCHES])
# after the chain: absent, present, zero and absent beside a present value
QUERIES = [11, 30, 0, 2 ** 250 + 1]


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


@pytest.fixture(scope="module")
def queries(chained):
    jt, tt, _, _ = chained
    q = field.ints_to_limbs(QUERIES).astype(np.uint32)
    return jt.non_inclusion_witness(q), tt.non_inclusion_witness(q)


@pytest.mark.parametrize("name", list(
    indexed.NonInclusionWitness.__dataclass_fields__))
def test_queries_match_imt_tpu(queries, name):
    """Non-inclusion witnesses on the chained state, every lane (the state
    tests/test_torch_parallel.py's sharded tree is held to)."""
    a = np.asarray(getattr(queries[0], name)).astype(np.int64)
    b = getattr(queries[1], name)
    b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape and np.array_equal(a, b.astype(np.int64)), name


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


class _Mix:
    """A cheap stand-in for Poseidon that mixes every input word into its
    output, so that a node computed from other children differs: two
    insert paths compared under it run the same hashes on the same
    inputs."""

    @staticmethod
    def hash2_nodes(a, b):
        return a * 31 + b * 17 + 7

    @staticmethod
    def hash3_leaf(a, b, c):
        x = a * 3 + b * 5 + c * 7
        return x[:8] * 11 + x[8:] * 13 + 1

    @staticmethod
    def nodes_to_limbs(x):
        return torch.cat([x & 0xFFFF, (x >> 16) & 0xFFFF])


def _raw_limbs(v: int) -> np.ndarray:
    """The 16 limbs of v < 2^256 as given, not reduced mod p."""
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                    dtype=np.int32)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_insert_batch_is_a_chain_of_one(monkeypatch, sparse):
    """insert_batch(v) and insert_batches([v]) on two depth-8 trees, batch
    after batch (duplicates within and across batches, zeros, values p,
    p + 1 and 2^256 - 1 as raw limbs): the same masks, state and levels,
    and the same hash2 and hash3 launches and lanes."""
    from imt_tpu_torch.utils import observability
    monkeypatch.setattr(indexed.hashing, "_impl", lambda x: _Mix)
    p = field.P
    batches = [field.ints_to_limbs([30, 10, 0, 10, 5, 50, 35, 2 ** 250]),
               field.ints_to_limbs([7, 30, 0, 31, 7, 1, 2, 3])]
    for col, v in ((0, p), (3, p + 1), (6, 2 ** 256 - 1)):
        batches[1][:, col] = _raw_limbs(v)
    if sparse:
        make = lambda: SparseIndexedMerkleTree(8, initial_capacity_log2=2,
                                               device=CPU)
    else:
        make = lambda: IndexedMerkleTree(8, device=CPU)
    one, chain = make(), make()
    names = ("hash2.launches", "hash2.lanes", "hash3.launches",
             "hash3.lanes")

    def counted(fn):
        before = {n: observability.total(n) for n in names}
        out = fn()
        return out, {n: observability.total(n) - before[n] for n in names}

    for b in batches:
        ok, n_one = counted(lambda: one.insert_batch(b))
        oks, n_chain = counted(lambda: chain.insert_batches(b[None]))
        assert ok.shape == (8,) and np.array_equal(ok, oks[0])
        assert n_one == n_chain and n_one["hash2.launches"] > 0
        assert one.count == chain.count and \
            one.active_depth == chain.active_depth
        for x, y in zip(one.levels + [one.vals, one.next_vals,
                                      one.next_idxs],
                        chain.levels + [chain.vals, chain.next_vals,
                                        chain.next_idxs]):
            assert torch.equal(x, y)
    assert ok.tolist() == [True, False, False, True, True, True, True, True]
    assert one.active_depth == (5 if sparse else 8)


def test_chained_hash_count_matches_imt_tpu(monkeypatch):
    """The hash lanes insert_batches dispatches (counted at
    ops/hashing.py, shape-only) against imt_tpu's formula."""
    from imt_tpu.tree import indexed as jindexed
    _torch_lanes.shape_only(monkeypatch)
    for depth, k, b in ((4, 4, 2), (24, 4096, 8), (21, 65536, 8), (3, 1, 1)):
        tree = IndexedMerkleTree(depth, device=_torch_lanes.META)
        got = _torch_lanes.lanes(lambda: tree.insert_batches(
            _torch_lanes.values(b, 16, k), as_numpy=False))
        assert got == jindexed._batches_hash_count(depth, k, b)
