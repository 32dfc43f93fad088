"""imt_tpu_torch's copy of the python-int oracle against imt_tpu's, and the
port's dense insert_batch against the oracle's sequential inserts (CPU).
Tolerance: exact."""

import numpy as np
import torch

from imt_tpu.tree import reference_oracle as joracle
from imt_tpu_torch import IndexedMerkleTree
from imt_tpu_torch.tree import reference_oracle
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

SEQ = [30, 10, 20, 5, 50, 35]


def test_oracle_copy_matches_imt_tpu():
    port, ref = reference_oracle.OracleIndexedTree(3), \
        joracle.OracleIndexedTree(3)
    assert port.get_root() == ref.get_root()
    for v in SEQ:
        assert port.insert(v) == ref.insert(v), v
    leaf = port.tree.levels[0][4]
    proof, _ = port.tree.get_proof(4)
    assert port.tree.verify_proof(leaf, 4, port.get_root(), proof)
    assert not port.tree.verify_proof(leaf + 1, 4, port.get_root(), proof)


def test_insert_batch_root_matches_sequential_oracle():
    oracle = reference_oracle.OracleIndexedTree(3)
    for v in SEQ:
        oracle.insert(v)
    tree = IndexedMerkleTree(3, device="cpu")
    assert np.asarray(tree.insert_batch(SEQ)).all()
    assert tree.get_root_int() == oracle.get_root()
    for slot in range(1 << 3):
        leaf = oracle.preimages[slot]
        assert tree.get_leaf_ints(slot) == (leaf.val, leaf.next_val,
                                            leaf.next_idx), slot
