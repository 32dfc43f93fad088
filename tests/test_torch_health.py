"""imt_tpu_torch's in-run failure detection (utils/health.py, CPU).

Mirrors tests/test_health.py case for case on the port's trees: a clean
audit, a silent leaf bit-flip, order corruption and a zeroed occupied slot
(both rehashed with the port's own ``_build_levels``, so only the
invariant is broken), the cursor, and the watchdog's cadence and
delegation, keywords included.  Unlike ``imt_tpu``'s, the audit passes the
empty slot of a rejected insert (test_torch_sparse.py shows both).  The
audit draws the same slots as ``imt_tpu``'s for the same (count, sample,
seed): its ``_sample_slots`` is held equal to
``imt_tpu.utils.health._sample_slots`` (pure numpy; no JAX program).
Tolerance: exact.
"""

import copy

import numpy as np
import pytest
import torch

from imt_tpu.utils.health import _sample_slots as jax_sample_slots
from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import field, hashing
from imt_tpu_torch.tree import indexed
from imt_tpu_torch.utils import health
from imt_tpu_torch.utils.health import TreeCorruption, Watchdog, check_tree
from imt_tpu_torch.utils import observability
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def populated():
    """A depth-4 tree holding [30, 10, 20, 5]; each test corrupts a copy."""
    t = IndexedMerkleTree(4, device=CPU)
    assert t.insert_batch([30, 10, 20, 5]).all()
    return t


def _rehash(t) -> None:
    leaves = hashing.hash3_leaf(t.vals, t.next_vals, t.next_idxs)
    t.levels = indexed._build_levels(leaves, t.active_depth)


@pytest.mark.parametrize("count,sample,seed", [
    (0, 8, 0), (3, 8, 1), (8, 8, 2), (9, 8, 3), (100, 8, 0), (100, 64, 5),
    (2 ** 21 - 1, 64, 1), (2 ** 21 - 1, 16, 7)])
def test_sample_slots_equal_imt_tpu(count, sample, seed):
    got = health._sample_slots(count, sample, seed)
    want = jax_sample_slots(count, sample, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_check_tree_clean(populated):
    report = check_tree(populated, sample=4)
    assert report.ok and report.failures == []
    assert report.checked_slots == [0, 1, 2, 3, 4]


def test_check_tree_detects_leaf_corruption(populated):
    """One bit of a leaf value flipped WITHOUT rehashing: the sampled path
    no longer verifies against the root."""
    t = copy.deepcopy(populated)
    t.vals[0, 2] ^= 1
    with pytest.raises(TreeCorruption, match="path") as e:
        check_tree(t, sample=8)
    assert "(2, 'path'" in str(e.value)


def test_check_tree_detects_order_corruption(populated):
    """An occupied slot's next_val set below its val, and the tree rehashed:
    only the sorted-successor contract is broken."""
    t = copy.deepcopy(populated)
    s = next(s for s in range(1, 5) if t.get_leaf_ints(s)[0] > 1)
    t.next_vals[:, s] = 0
    t.next_vals[0, s] = 1
    _rehash(t)
    with pytest.raises(TreeCorruption, match="order") as e:
        check_tree(t, sample=8)
    assert "path" not in str(e.value)


def test_check_tree_detects_zeroed_occupied_slot(populated):
    """An occupied slot zeroed and rehashed (paths verify, order vacuous):
    the 'empty' class, since inserts never store 0."""
    t = copy.deepcopy(populated)
    for x in (t.vals, t.next_vals, t.next_idxs):
        x[:, 2] = 0
    _rehash(t)
    with pytest.raises(TreeCorruption, match="empty"):
        check_tree(t, sample=8)


def test_check_tree_passes_the_slot_of_a_rejected_insert():
    """A rejected insert consumes its slot and leaves it an empty leaf that
    no slot links to: sound, unlike a zeroed slot (the test above), which
    its predecessor still links to."""
    t = IndexedMerkleTree(3, device=CPU)
    assert t.insert_batch([30, 30, 10, 0]).tolist() == [
        True, False, True, False]
    assert t.get_leaf_ints(2) == t.get_leaf_ints(4) == (0, 0, 0)
    report = check_tree(t, sample=8)
    assert report.ok and report.checked_slots == [0, 1, 2, 3, 4]


def test_check_tree_detects_a_bad_cursor(populated):
    t = copy.deepcopy(populated)
    t.count = -1
    with pytest.raises(TreeCorruption, match="cursor"):
        check_tree(t)


def test_watchdog_cadence_and_delegation():
    """interval=2: every second mutating call audits, whichever entry point
    and keywords it took; reads pass through unaudited."""
    wd = Watchdog(SparseIndexedMerkleTree(5, initial_capacity_log2=2,
                                          device=CPU), interval=2, sample=4)
    before = observability.total("inserts.submitted")
    ok = wd.insert_batch([30, 10], as_numpy=False)        # op 1
    assert isinstance(ok, torch.Tensor) and bool(ok.all())
    assert observability.total("inserts.submitted") == before + 2
    assert wd._audits == 0
    assert wd.insert_batch([20, 5], witness=True).ok.all()  # op 2 -> audit
    assert wd._audits == 1 and wd.count == 4
    assert wd.insert(50).ok.all()                          # op 3
    assert wd.insert_batches([[35]]).all()                 # op 4 -> audit
    assert wd._audits == 2
    wd.get_root_int()
    assert wd._audits == 2
    assert wd.get_root_int() == wd._tree.get_root_int()
    field.limbs_to_int(wd.get_proof(5)[0][0, :, 0])        # delegated read
