"""Two faults of the port against its own contract, cleared (CPU).

* ``get_proof`` of a sparse tree's slot beyond its active prefix: the
  siblings come from the zero spine, so every proof of a depth-6
  ``SparseIndexedMerkleTree`` holding 2^2 slots equals the dense tree's and
  verifies.  ``imt_tpu``'s sparse tree clamps such a gather, and its proof
  fails its own ``verify_proof``: the port does not copy that.
* ``insert_seq([])`` returns the InsertWitness of no inserts in the batch
  layout, as ``imt_tpu``'s does, on the dense, the sparse and an unsharded
  ``ShardedIndexedMerkleTree`` (a 1-rank gloo mesh), with the count
  unchanged.

Neither compiles an ``imt_tpu`` program: the layout is written out below.
The sharded tree's proofs beyond its prefix are held in
tests/test_torch_parallel.py's ranks.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import hashing
from imt_tpu_torch.tree import indexed
from imt_tpu_torch.tree.merkle import verify_proofs
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

DEPTH, CAP, VALUES = 6, 2, [5, 3, 9]
FIELDS = list(indexed.InsertWitness.__dataclass_fields__)


def empty_layout(depth: int) -> dict:
    """Each field's shape in imt_tpu's InsertWitness of no inserts."""
    shapes = dict.fromkeys(FIELDS, (16, 0))
    shapes.update(ok=(0,), new_leaf_index=(0,), is_new_leaf_largest=(0,))
    for side in ("low", "new"):
        shapes[f"{side}_leaf_proof"] = (depth, 16, 0)
        shapes[f"{side}_leaf_proof_helper"] = (depth, 0)
    return shapes


def check_all_proofs(sparse, dense) -> None:
    """Every slot's proof of `sparse` equals `dense`'s, its helpers are the
    index's bits, and all of them verify against the root with the slot's
    leaf (one batched verify)."""
    n = dense.num_slots
    proofs = []
    for i in range(n):
        ps, hs = sparse.get_proof(i)
        pd, hd = dense.get_proof(i)
        assert torch.equal(ps.cpu(), pd.cpu()), i
        assert torch.equal(hs.cpu(), hd.cpu()), i
        bits = [int(((i >> d) & 1) == 0) for d in range(dense.tree_depth)]
        assert hs[:, 0].tolist() == bits, i
        proofs.append(ps)
    leaves = hashing.dec_nodes(hashing.hash3_leaf(
        dense.vals, dense.next_vals, dense.next_idxs))
    assert verify_proofs(leaves, list(range(n)), sparse.get_root(),
                         torch.cat(proofs, dim=-1)).all()


def test_sparse_proofs_beyond_the_prefix_equal_the_dense_ones():
    sparse = SparseIndexedMerkleTree(DEPTH, initial_capacity_log2=CAP,
                                     device="cpu")
    dense = IndexedMerkleTree(DEPTH, device="cpu")
    sparse.insert_batch(VALUES)
    dense.insert_batch(VALUES)
    assert sparse.active_depth == CAP
    assert sparse.get_proof(5)[1][:, 0].tolist() == [0, 1, 0, 1, 1, 1]
    check_all_proofs(sparse, dense)
    for tree in (sparse, dense):
        with pytest.raises(IndexError):
            tree.get_proof(1 << DEPTH)


@pytest.fixture
def one_rank_mesh(tmp_path):
    from imt_tpu_torch.parallel import sharded
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield sharded.make_mesh(1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def check_empty_insert_seq(tree) -> None:
    tree.insert_seq([5])
    count, root = tree.count, tree.get_root_int()
    w = tree.insert_seq([])
    want = empty_layout(tree.tree_depth)
    got = {name: tuple(getattr(w, name).shape) for name in FIELDS}
    assert got == want
    assert w.ok.dtype == np.bool_
    assert tree.count == count and tree.get_root_int() == root


@pytest.mark.parametrize("kind", ["dense", "sparse", "unsharded"])
def test_empty_insert_seq_returns_the_empty_witness(kind, request):
    if kind == "unsharded":
        from imt_tpu_torch.parallel.sharded import ShardedIndexedMerkleTree
        mesh = request.getfixturevalue("one_rank_mesh")
        tree = ShardedIndexedMerkleTree(4, mesh, sparse=False, device="cpu")
        assert not tree.is_sharded
    elif kind == "sparse":
        tree = SparseIndexedMerkleTree(4, initial_capacity_log2=1,
                                       device="cpu")
    else:
        tree = IndexedMerkleTree(4, device="cpu")
    check_empty_insert_seq(tree)
