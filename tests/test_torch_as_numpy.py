"""imt_tpu_torch's as_numpy=False (CPU).

``imt_tpu``'s device-resident results (imt_tpu/tree/indexed.py:1037-1210,
tree/sparse.py:96-260): for insert, insert_seq, insert_batch,
insert_batch(witness=True), insert_batches and non_inclusion_witness, on a
dense tree and on a sparse tree that grows inside most calls, the
as_numpy=False call equals the as_numpy=True call on a twin field by
field, its ``ok`` is a bool tensor on the tree's device, the state after
the call is the twin's, and the counters count the inserts as
submitted.
Rejected lanes (duplicates, zero) are among the values.  The default path
is held against ``imt_tpu`` by the other test_torch_* files.  Tolerance:
exact.
"""

import copy

import numpy as np
import pytest
import torch

from imt_tpu_torch import (IndexedMerkleTree, InsertWitness,
                           NonInclusionWitness, SparseIndexedMerkleTree)
from imt_tpu_torch.tree import indexed
from imt_tpu_torch.utils import observability
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
TREES = {
    "dense": lambda: IndexedMerkleTree(2, device=CPU),
    "sparse": lambda: SparseIndexedMerkleTree(2, initial_capacity_log2=1,
                                              device=CPU),
}
# entry point -> (call, values inserted, ok expected)
CALLS = {
    "insert": (lambda t, a: t.insert(30, as_numpy=a), 1, [True]),
    "insert_seq": (lambda t, a: t.insert_seq([10, 10], as_numpy=a), 2,
                   [True, False]),
    "insert_batch": (lambda t, a: t.insert_batch([20, 0, 20], as_numpy=a),
                     3, [True, False, False]),
    "insert_batch_witness": (
        lambda t, a: t.insert_batch([5, 5], witness=True, as_numpy=a), 2,
        [True, False]),
    "insert_batches": (
        lambda t, a: t.insert_batches([[40], [40]], as_numpy=a), 2,
        [[True], [False]]),
    "non_inclusion_witness": (
        lambda t, a: t.non_inclusion_witness([7, 0], as_numpy=a), 0,
        [True, False]),
}


def _totals() -> dict:
    names = ("inserts.submitted", "inserts.accepted", "inserts.rejected",
             "queries")
    return {n: observability.total(n) for n in names}


def _state(t) -> list:
    return [t.vals, t.next_vals, t.next_idxs] + t.levels


def _fields(out) -> dict:
    if isinstance(out, (InsertWitness, NonInclusionWitness)):
        return dict(vars(out))
    return {"ok": out}


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("kind", list(TREES))
def test_device_resident_equals_numpy(kind, call):
    run, k, want = CALLS[call]
    tree = TREES[kind]()
    twin = copy.deepcopy(tree)
    before = _totals()
    dev = _fields(run(tree, False))
    mid = _totals()
    host = _fields(run(twin, True))
    after = _totals()

    ok = dev["ok"]
    assert isinstance(ok, torch.Tensor) and ok.dtype == torch.bool
    assert ok.device.type == tree.device.type
    assert isinstance(host["ok"], np.ndarray)
    assert host["ok"].tolist() == want
    assert np.array_equal(ok.numpy(), host["ok"])
    assert dev.keys() == host.keys()
    for name in dev.keys() - {"ok"}:
        assert torch.equal(dev[name], host[name]), name
    assert tree.count == twin.count and tree._live == twin._live
    assert tree.active_depth == twin.active_depth
    for x, y in zip(_state(tree), _state(twin)):
        assert torch.equal(x, y)

    accepted = int(np.sum(want)) if k else 0
    assert mid["inserts.submitted"] == before["inserts.submitted"] + k
    assert mid["inserts.accepted"] == before["inserts.accepted"]
    assert after["inserts.submitted"] == mid["inserts.submitted"]
    assert after["inserts.accepted"] == mid["inserts.accepted"] + accepted
    assert after["inserts.rejected"] == \
        mid["inserts.rejected"] + k - accepted
    queries = 2 if call == "non_inclusion_witness" else 0
    assert mid["queries"] == before["queries"] + queries


def test_device_resident_skips_the_debug_witness_check(monkeypatch):
    """With debug_witness on, the numpy path re-verifies the witness and
    the device-resident path does not (imt_tpu :1153-1156)."""
    seen = []
    monkeypatch.setattr(indexed, "_debug_witness", True)
    monkeypatch.setattr(indexed, "check_insert_witness", seen.append)
    monkeypatch.setattr(indexed, "check_non_inclusion_witness",
                        lambda w, q: seen.append(w))
    tree = IndexedMerkleTree(1, device=CPU)
    tree.non_inclusion_witness([3], as_numpy=False)
    tree.insert(3, as_numpy=False)
    assert seen == []
    tree.non_inclusion_witness([3])
    assert len(seen) == 1 and seen[0].ok.tolist() == [False]
