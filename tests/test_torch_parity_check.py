"""tools/parity_check_torch.py, the port of tools/tpu_parity_check.py, on
the CPU: its three checks pass against the python-int oracle, a tree whose
root has been corrupted makes it raise, and it refuses the card where
there is none.  No imt_tpu program.  Tolerance: exact."""

import importlib.util
import os

import pytest
import torch

from imt_tpu_torch.tree import indexed
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parity_module():
    spec = importlib.util.spec_from_file_location(
        "parity_check_torch", os.path.join(ROOT, "tools",
                                           "parity_check_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity_on_the_cpu():
    assert parity_module().run_parity("cpu") == {
        "parity": True, "device": "cpu",
        "checks": {"sequential_replay_d3": True, "batched_sparse_d32": True,
                   "witness_batch_predicate": True}}


def test_a_corrupted_root_fails_parity(monkeypatch):
    """Each insert flips one bit of the tree's root node: the replay's
    first root check raises."""
    insert = indexed.IndexedMerkleTree.insert

    def corrupting(self, value, as_numpy=True):
        w = insert(self, value, as_numpy)
        self.levels[-1][0, 0] ^= 1
        return w
    monkeypatch.setattr(indexed.IndexedMerkleTree, "insert", corrupting)
    with pytest.raises(AssertionError, match="root mismatch at 30"):
        parity_module().run_parity("cpu")


def test_parity_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        parity_module().run_parity("cuda")
