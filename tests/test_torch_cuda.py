"""imt_tpu_torch on the card: the CUDA kernels against their plain torch
versions, and the dense insert, the sequential witness path, the witness
batches, the sparse tree with its chained batches, the predicates and the
Merkle tree on CUDA against the same calls on the CPU; hash_fixed through
K1 against its plain version, and the C++ oracle against the hash
kernels.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports nothing of JAX, so on the GPU host (which has none) it runs without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (the kernel and the plain path compute the same bits).
"""

import numpy as np
import pytest
import torch

from imt_tpu_torch import (FIELD_MODULUS, IndexedMerkleTree, MerkleTree,
                           SparseIndexedMerkleTree)
from imt_tpu_torch.ops import (field, poseidon, poseidon_cuda, vpu_roofline,
                               vpu_roofline_cuda)
from imt_tpu_torch.tree import indexed
from _torch_inference import inference_mode  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _limbs(seed: int, width: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, (16, width)).astype(np.int32)
    x[:, 0] = field.int_to_limbs(FIELD_MODULUS - 1)
    x[:, -1] = 0xFFFF                         # 2^256 - 1: reduced mod p
    return torch.as_tensor(x, device=dev)


@pytest.mark.parametrize("width", [1, 2, 129, 1000])
def test_kernel_equals_plain(cuda, width):
    a, b, c = (_limbs(s, width, cuda) for s in (1, 2, 3))
    na, nb = poseidon.limbs_to_nodes(a), poseidon.limbs_to_nodes(b)
    pairs = [
        (poseidon_cuda.limbs_to_nodes(a), na),
        (poseidon_cuda.nodes_to_limbs(na), poseidon.nodes_to_limbs(na)),
        (poseidon_cuda.hash2_nodes(na, nb), poseidon.hash2_nodes(na, nb)),
        (poseidon_cuda.hash3_leaf(a, b, c), poseidon.hash3_leaf(a, b, c)),
        (poseidon_cuda.hash2(a, b), poseidon.hash2(a, b)),
        (poseidon_cuda.permute_n(torch.stack([na, nb, na]), 3),
         poseidon.permute_n(torch.stack([na, nb, na]), 3)),
    ]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert torch.equal(got, want), i


def test_constant_tables_on_the_card(cuda):
    """The hash kernels read the sparse schedule's tables from constant
    memory: hashes of known inputs equal the python-int oracle's."""
    from imt_tpu_torch.ops.poseidon_ref import hash_fixed
    from imt_tpu_torch.ops.poseidon_spec import default_params
    pairs = [(0, 0), (1, 2), (FIELD_MODULUS - 1, 7), (2 ** 200, 3 ** 100)]
    nodes = [torch.as_tensor(np.stack([field.int_to_node(p[k]) for p in pairs],
                                      axis=1), device=cuda) for k in (0, 1)]
    got = poseidon_cuda.nodes_to_limbs(poseidon_cuda.hash2_nodes(*nodes))
    params = default_params()
    assert field.limbs_to_ints(got.cpu().numpy()) == [
        hash_fixed(list(p), params) for p in pairs]
    z = torch.as_tensor(field.ints_to_limbs([5, 0]), device=cuda)
    leaf = poseidon_cuda.nodes_to_limbs(poseidon_cuda.hash3_leaf(z, z, z))
    assert field.limbs_to_ints(leaf.cpu().numpy()) == [
        hash_fixed([5, 5, 5], params), hash_fixed([0, 0, 0], params)]


def test_wrappers_refuse_bad_tensors(cuda):
    n = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        poseidon_cuda.hash2_nodes(n.long(), n.long())
    with pytest.raises(ValueError, match="shape"):
        poseidon_cuda.hash2_nodes(n[:4], n[:4])
    with pytest.raises(ValueError, match="contiguous"):
        poseidon_cuda.nodes_to_limbs(torch.zeros((8, 8), dtype=torch.int32,
                                                 device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="width"):
        poseidon_cuda.hash2_nodes(n, n[:, :3].contiguous())


def test_insert_batch_on_cuda_equals_cpu(cuda):
    batches = [[30, 10, 20, 5, 50, 35, 0, 10], [7, 7, 0, 31, 32, 33, 1, 2],
               field.random_limbs(5, 64)]
    gpu = IndexedMerkleTree(8, device=cuda)
    cpu = IndexedMerkleTree(8, device="cpu")
    poseidon_cuda.reset_launch_counts()
    for b in batches:
        assert gpu.insert_batch(b).tolist() == cpu.insert_batch(b).tolist()
    assert poseidon_cuda.LAUNCHES["hash3_leaf"] == len(batches)
    assert poseidon_cuda.LAUNCHES["hash2_nodes"] > 0
    for name in ("vals", "next_vals", "next_idxs"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for d, (g, c) in enumerate(zip(gpu.levels, cpu.levels)):
        assert torch.equal(g.cpu(), c), d
    assert gpu.get_root_int() == cpu.get_root_int()


@pytest.mark.parametrize("name", list(vpu_roofline.BODIES))
def test_roofline_kernel_equals_plain(cuda, name):
    vpu_roofline_cuda.reset_launch_counts()
    for rows, b, k in ((3, 1000, 5), (48, 257, 1)):
        x = vpu_roofline.seeded_input(name, rows, b, seed=2, device=cuda)
        got = vpu_roofline_cuda.roofline(name, x, k)
        want = vpu_roofline.plain(name, x, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (rows, b, k)
        assert torch.equal(vpu_roofline.run(name, x, k), got)
    assert vpu_roofline_cuda.LAUNCHES[name] == 4


def test_roofline_wrapper_refuses_bad_tensors(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        vpu_roofline_cuda.roofline("imad16", x, 1)
    with pytest.raises(ValueError, match="contiguous"):
        vpu_roofline_cuda.roofline("mul", x[:, ::2], 1)
    with pytest.raises(ValueError, match="unknown body"):
        vpu_roofline_cuda.roofline("nope", x, 1)


def _fields(w) -> dict:
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in w.__dict__.items()}


def test_sequential_path_on_cuda_equals_cpu(cuda):
    vals = [30, 10, 20, 5, 50, 35, 10, 0, 2 ** 250]
    gpu = IndexedMerkleTree(6, device=cuda)
    cpu = IndexedMerkleTree(6, device="cpu")
    for t in (gpu, cpu):
        t.insert_batch([7, 70])
    poseidon_cuda.reset_launch_counts()
    wg, wc = _fields(gpu.insert_seq(vals)), _fields(cpu.insert_seq(vals))
    assert poseidon_cuda.LAUNCHES["hash2_nodes"] >= 6 * len(vals)
    for k in wc:
        assert np.array_equal(np.asarray(wg[k]), np.asarray(wc[k])), k
    assert gpu.get_root_int() == cpu.get_root_int()
    queries = [5, 6, 40, 70, 0, 2 ** 251]
    ng = gpu.non_inclusion_witness(queries)
    nc = _fields(cpu.non_inclusion_witness(queries))
    for k, v in _fields(ng).items():
        assert np.array_equal(np.asarray(v), np.asarray(nc[k])), k
    w = gpu.insert_seq([11, 11])
    pred = indexed.insert_leaf(
        w.old_root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper, w.new_root,
        w.new_leaf_val, w.new_leaf_next_val, w.new_leaf_next_idx,
        w.new_leaf_index, w.new_leaf_proof, w.new_leaf_proof_helper,
        w.is_new_leaf_largest)
    assert pred.device.type == "cuda" and pred.tolist() == [True, False]
    q = torch.as_tensor(field.ints_to_limbs(queries), device=cuda)
    assert indexed.verify_non_inclusion(
        ng.root, ng.low_leaf_val, ng.low_leaf_next_val, ng.low_leaf_next_idx,
        ng.low_leaf_proof, ng.low_leaf_proof_helper, q,
        ng.is_new_leaf_largest).cpu().numpy()[ng.ok].all()


def test_merkle_tree_on_cuda_equals_cpu(cuda):
    leaves = _limbs(4, 64, "cpu")
    leaves[15] &= 0x2FFF                       # canonical values < p
    gpu, cpu = MerkleTree.build(leaves), MerkleTree.build(leaves, "cpu")
    assert gpu.device.type == "cuda"
    for d, (g, c) in enumerate(zip(gpu.levels, cpu.levels)):
        assert torch.equal(g.cpu(), c), d
    idx = [0, 9, 63]
    pg, hg = gpu.get_proofs(idx)
    assert gpu.verify_proofs(leaves[:, idx], idx, gpu.get_root(), pg).all()
    bad = pg.clone()
    bad[2, 0, 1] ^= 1
    assert gpu.verify_proofs(leaves[:, idx], idx, gpu.get_root(),
                             bad).tolist() == [True, False, True]


def test_numpy_arguments_verify_on_the_card(cuda):
    leaves = _limbs(5, 16, "cpu")
    leaves[15] &= 0x2FFF                       # canonical values < p
    gpu = MerkleTree.build(leaves)
    idx = [3, 12]
    proof, helpers = (x.cpu().numpy() for x in gpu.get_proofs(idx))
    root, leaf = gpu.get_root().cpu().numpy(), leaves[:, idx].numpy()
    poseidon_cuda.reset_launch_counts()
    assert gpu.verify_proofs(leaf, idx, root, proof).all()
    assert poseidon_cuda.LAUNCHES["hash2_nodes"] == gpu.depth
    from imt_tpu_torch.ops import gates
    from imt_tpu_torch.tree import merkle
    got = gates.verify_merkle_proof(root, leaf, proof, helpers)
    assert got.device.type == "cuda" and got.tolist() == [True, True]
    assert merkle.verify_proofs(leaf, idx, root, proof).all()
    assert poseidon_cuda.LAUNCHES["hash2_nodes"] == 3 * gpu.depth
    tree = IndexedMerkleTree(4)
    tree.insert_batch([9])
    p, _ = tree.get_proof(1)
    leaf1 = indexed.hashing.hash3(*(x[:, 1:2].contiguous() for x in (
        tree.vals, tree.next_vals, tree.next_idxs))).cpu().numpy()
    poseidon_cuda.reset_launch_counts()
    assert tree.verify_proof(leaf1, 1, tree.get_root().cpu().numpy(),
                             p.cpu().numpy())
    assert poseidon_cuda.LAUNCHES["hash2_nodes"] == 4


def test_witness_batch_on_cuda_equals_cpu(cuda):
    """Two witness batches (chains, a duplicate of a present value, zero)
    on a dense depth-6 tree: every field of every lane, and the state."""
    gpu = IndexedMerkleTree(6, device=cuda)
    cpu = IndexedMerkleTree(6, device="cpu")
    poseidon_cuda.reset_launch_counts()
    for vals in ([30, 10, 20, 5, 50, 35, 2 ** 200],
                 [50, 50, 7, 0, 120, 119, 31, 6]):
        wg, wc = _fields(gpu.insert_batch(vals, witness=True)), \
            _fields(cpu.insert_batch(vals, witness=True))
        for k in wc:
            assert np.array_equal(np.asarray(wg[k]), np.asarray(wc[k])), k
    assert poseidon_cuda.LAUNCHES["hash3_leaf"] == 2
    assert poseidon_cuda.LAUNCHES["hash2_nodes"] == 2 * 6
    for g, c in zip(gpu.levels + [gpu.vals, gpu.next_vals, gpu.next_idxs],
                    cpu.levels + [cpu.vals, cpu.next_vals, cpu.next_idxs]):
        assert torch.equal(g.cpu(), c)


def test_sparse_tree_on_cuda_equals_cpu(cuda):
    """A depth-16 sparse tree grown from 2 slots through insert_batches,
    insert_seq and a witness batch: masks, witnesses, state and root."""
    gpu = SparseIndexedMerkleTree(16, initial_capacity_log2=1, device=cuda)
    cpu = SparseIndexedMerkleTree(16, initial_capacity_log2=1, device="cpu")
    batches = [[30, 10, 2 ** 250, 10], [2 ** 250, 50, 35, 0]]
    assert np.array_equal(gpu.insert_batches(batches),
                          cpu.insert_batches(batches))
    for step in (lambda t: t.insert_seq([7, 7, 99]),
                 lambda t: t.insert_batch([8, 6, 100], witness=True)):
        wg, wc = _fields(step(gpu)), _fields(step(cpu))
        assert wg["low_leaf_proof"].shape[0] == 16
        for k in wc:
            assert np.array_equal(np.asarray(wg[k]), np.asarray(wc[k])), k
    assert gpu.active_depth == cpu.active_depth == 4
    for g, c in zip(gpu.levels + [gpu.vals, gpu.next_vals, gpu.next_idxs],
                    cpu.levels + [cpu.vals, cpu.next_vals, cpu.next_idxs]):
        assert torch.equal(g.cpu(), c)
    assert gpu.get_root_int() == cpu.get_root_int()


@pytest.mark.parametrize("width", [1, 2, 1000])
def test_hash_fixed_on_the_card_equals_plain(cuda, width):
    """hashing.hash_fixed at arities 1-8 on the card against the plain
    sponge, with p - 1 in every absorbed word of column 2: arity // 2 + 1
    K1 launches a call at every arity through poseidon_cuda.hash_fixed,
    which at arities 2 and 3 equals hash2 and hash3."""
    from imt_tpu_torch.ops import hashing
    cols = [_limbs(10 + j, width, cuda) for j in range(8)]
    cols[2] = torch.as_tensor(np.repeat(
        field.int_to_limbs(FIELD_MODULUS - 1)[:, None], width, axis=1),
        device=cuda)
    for n in range(1, 9):
        poseidon_cuda.reset_launch_counts()
        got = poseidon_cuda.hash_fixed(cols[:n])
        torch.cuda.synchronize()
        assert poseidon_cuda.LAUNCHES["permute_n"] == n // 2 + 1
        assert poseidon_cuda.LAUNCHES["hash2_nodes"] == 0
        assert poseidon_cuda.LAUNCHES["hash3_leaf"] == 0
        want = poseidon.hash_fixed([c.cpu() for c in cols[:n]])
        assert torch.equal(got.cpu(), want), n
        assert torch.equal(hashing.hash_fixed(cols[:n]).cpu(), want), n


def test_native_oracle_equals_the_hash_kernels(cuda):
    """The C++ oracle's hash2 and hash3 through the limb bridge against the
    card's hash kernels, 2^256 - 1 and p - 1 among the inputs."""
    from imt_tpu_torch.native import oracle
    a, b, c = (_limbs(s, 1000, cuda) for s in (4, 5, 6))
    u = [oracle.limbs_to_u64(x.cpu().numpy()) for x in (a, b, c)]
    assert np.array_equal(oracle.u64_to_limbs(oracle.hash2_u64(*u[:2])),
                          poseidon_cuda.hash2(a, b).cpu().numpy())
    assert np.array_equal(oracle.u64_to_limbs(oracle.hash3_u64(*u)),
                          poseidon_cuda.hash3(a, b, c).cpu().numpy())
