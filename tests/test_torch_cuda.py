"""imt_tpu_torch on the card: the CUDA kernels against their plain torch
versions, and the dense insert, the sequential witness path, the witness
batches (their walk replayed from CUDA graphs too), the sparse tree with
its chained batches (at depth 40 too), the predicates and the Merkle tree
on CUDA against the same calls on the CPU; hash_fixed through
K1 against its plain version, and the C++ oracle against the hash
kernels.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports nothing of JAX, so on the GPU host (which has none) it runs without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (the kernel and the plain path compute the same bits).
"""

import ctypes

import numpy as np
import pytest
import torch

from imt_tpu_torch import (FIELD_MODULUS, IndexedMerkleTree, MerkleTree,
                           SparseIndexedMerkleTree)
from imt_tpu_torch.ops import (field, hashing, poseidon, poseidon_cuda,
                               vpu_roofline, vpu_roofline_cuda)
from imt_tpu_torch.tree import indexed
from imt_tpu_torch.utils import observability
from _torch_inference import inference_mode  # noqa: F401
import test_torch_port_faults as faults
from test_torch_port_faults import one_rank_mesh  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launched(since: dict | None = None) -> dict:
    """Each kernel entry point's launches on the card since `since` (an
    earlier ``_launched()``), from the tracer's ``cuda.<name>`` counters,
    which only a launch adds to."""
    since = since or {}
    return {k: observability.total("cuda." + k) - since.get(k, 0)
            for k in ("permute_n", "hash2_nodes", "hash3_leaf",
                      "limbs_to_nodes", "nodes_to_limbs")}


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
        (hashing.hash2(a, b),
         poseidon.nodes_to_limbs(poseidon.hash2_nodes(na, nb))),
        (poseidon_cuda.permute_n(torch.stack([na, nb, na]), 3),
         poseidon.permute_n(torch.stack([na, nb, na]), 3)),
    ]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert torch.equal(got, want), i


def _coop_widths(dev) -> list:
    c = poseidon_cuda.coop_lanes(dev)
    return [1, 2, 31, 33, 2048, 4096, c - 1, c, c + 1, 2 * c]


def test_hash_kernels_both_paths_equal_plain(cuda):
    """hash2 and hash3 at widths on both sides of the crossover (the
    cooperative kernels at most ``coop_lanes``, one thread a lane above)
    bit for bit against the plain version, with 0, p - 1 and 2^256 - 1
    (hash3's limbs; reduced mod p as hash2's nodes) among the lanes; a
    launch writes its output's 8 x width words and nothing past them."""
    for width in _coop_widths(cuda):
        a, b, c = (_limbs(s, width, cuda) for s in (21, 22, 23))
        for x in (a, b, c):
            x[:, width // 2] = 0
        na, nb = poseidon.limbs_to_nodes(a), poseidon.limbs_to_nodes(b)
        want = poseidon.hash2_nodes(na, nb)
        assert torch.equal(poseidon_cuda.hash2_nodes(na, nb), want), width
        assert torch.equal(poseidon_cuda.hash3_leaf(a, b, c),
                           poseidon.hash3_leaf(a, b, c)), width
        out = torch.full((8 * width + 64,), -1, dtype=torch.int32,
                         device=cuda)
        lib = poseidon_cuda._lib_for(cuda)
        assert lib.imt_hash2_nodes(
            ctypes.c_void_p(na.data_ptr()), ctypes.c_void_p(nb.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), width,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) == 0
        assert torch.equal(out[:8 * width].view(8, width), want), width
        assert bool((out[8 * width:] == -1).all()), width


def test_coop_launches_are_counted(cuda):
    """``cuda.<entry point>.coop`` counts the hash launches that take the
    cooperative kernels: every one at or below the crossover, none above;
    ``cuda.<entry point>`` counts them all."""
    c = poseidon_cuda.coop_lanes(cuda)
    assert c == 96 * torch.cuda.get_device_properties(
        cuda).multi_processor_count
    names = [f"cuda.{n}{s}" for n in ("hash2_nodes", "hash3_leaf")
             for s in ("", ".coop")]
    for width, coop in ((1, 1), (c, 1), (c + 1, 0)):
        limbs = _limbs(24, width, cuda)
        nodes = poseidon.limbs_to_nodes(limbs)
        start = {n: observability.total(n) for n in names}
        poseidon_cuda.hash2_nodes(nodes, nodes)
        poseidon_cuda.hash3_leaf(limbs, limbs, limbs)
        got = {n: observability.total(n) - start[n] for n in names}
        assert got == {"cuda.hash2_nodes": 1, "cuda.hash2_nodes.coop": coop,
                       "cuda.hash3_leaf": 1, "cuda.hash3_leaf.coop": coop}, \
            width


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
    start = _launched()
    for b in batches:
        assert gpu.insert_batch(b).tolist() == cpu.insert_batch(b).tolist()
    assert _launched(start)["hash3_leaf"] == len(batches)
    assert _launched(start)["hash2_nodes"] > 0
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


@pytest.mark.parametrize("name", ["mul", "mod4"])
def test_roofline_edge_values_bit_for_bit(cuda, name):
    """The f32 bodies on signed zeros, infinities, NaN, denormals, -0.5,
    +-(2^22 +- 1), +-2^23, +-(2^23 + 1) and those over d (so x * d meets
    the floor's edges), compared as int32 views, any NaN equal to any
    NaN."""
    x = vpu_roofline.edge_values(name).to(cuda)
    for k in (1, 2, 7, 64):
        got = vpu_roofline_cuda.roofline(name, x, k)
        want = vpu_roofline.plain(name, x, k)
        torch.cuda.synchronize()
        assert vpu_roofline.same_bits(got, want), k


@pytest.mark.parametrize("name", list(vpu_roofline.BODIES))
def test_roofline_odd_sizes_offsets_and_k(cuda, name):
    """The remainder of the unrolled k loop (k = 0, 1, 7, 64), a ragged
    tail (an odd numel) and a start 4 bytes past a 16-byte boundary (the
    scalar paths), one launch per call."""
    base = vpu_roofline.seeded_input(name, 5, 203, seed=4, device=cuda)
    views = [base, base.view(-1)[:1001], base.view(-1)[1:],
             base.view(-1)[3:1004]]
    vpu_roofline_cuda.reset_launch_counts()
    for x in views:
        for k in (0, 1, 7, 64):
            got = vpu_roofline_cuda.roofline(name, x, k)
            torch.cuda.synchronize()
            assert torch.equal(got, vpu_roofline.plain(name, x, k)), \
                (x.storage_offset(), x.numel(), k)
    assert vpu_roofline_cuda.LAUNCHES[name] == 4 * len(views)


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
    start = _launched()
    wg, wc = _fields(gpu.insert_seq(vals)), _fields(cpu.insert_seq(vals))
    assert _launched(start)["hash2_nodes"] >= 6 * len(vals)
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
    start = _launched()
    assert gpu.verify_proofs(leaf, idx, root, proof).all()
    assert _launched(start)["hash2_nodes"] == gpu.depth
    from imt_tpu_torch.ops import gates
    from imt_tpu_torch.tree import merkle
    got = gates.verify_merkle_proof(root, leaf, proof, helpers)
    assert got.device.type == "cuda" and got.tolist() == [True, True]
    assert merkle.verify_proofs(leaf, idx, root, proof).all()
    assert _launched(start)["hash2_nodes"] == 3 * gpu.depth
    tree = IndexedMerkleTree(4)
    tree.insert_batch([9])
    p, _ = tree.get_proof(1)
    leaf1 = indexed.hashing.hash3(*(x[:, 1:2].contiguous() for x in (
        tree.vals, tree.next_vals, tree.next_idxs))).cpu().numpy()
    start = _launched()
    assert tree.verify_proof(leaf1, 1, tree.get_root().cpu().numpy(),
                             p.cpu().numpy())
    assert _launched(start)["hash2_nodes"] == 4


def test_witness_batch_on_cuda_equals_cpu(cuda):
    """Two witness batches (chains, a duplicate of a present value, zero)
    on a dense depth-6 tree: every field of every lane, and the state."""
    gpu = IndexedMerkleTree(6, device=cuda)
    cpu = IndexedMerkleTree(6, device="cpu")
    start = _launched()
    for vals in ([30, 10, 20, 5, 50, 35, 2 ** 200],
                 [50, 50, 7, 0, 120, 119, 31, 6]):
        wg, wc = _fields(gpu.insert_batch(vals, witness=True)), \
            _fields(cpu.insert_batch(vals, witness=True))
        for k in wc:
            assert np.array_equal(np.asarray(wg[k]), np.asarray(wc[k])), k
    assert _launched(start)["hash3_leaf"] == 2
    assert _launched(start)["hash2_nodes"] == 2 * 6
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


@pytest.mark.parametrize("share", [0.0, 0.01, 0.5, 1.0])
def test_true_neighbours_on_the_card_equal_the_full_scans(cuda, share):
    """The planner's lookups at the d40 cell's size, M = 2^22 + 2,048,
    with a random mask and 2,048 sorted random queries (0 and M - 1
    among them): what the M-sized scans give at those positions."""
    m, k = (1 << 22) + 2048, 2048
    g = torch.Generator(device=cuda).manual_seed(17)
    mask = torch.rand(m, generator=g, device=cuda) < share
    pos = torch.randint(0, m, (k,), generator=g, device=cuda)
    pos[:2] = torch.tensor([0, m - 1])
    pos = pos.sort().values
    prv, nxt = indexed._true_neighbours(mask, pos)
    assert torch.equal(prv, indexed._prev_true(mask, -1)[pos])
    assert torch.equal(nxt, indexed._next_true(mask)[pos])


def test_depth40_sparse_tree_on_cuda_equals_cpu(cuda):
    """Aztec's height-40 nullifier tree (the benchmark's
    ``nullifier-d40-2p22``) at a 2^12 prefix: four blocks of 256 through
    insert_batches, with a duplicate across blocks and a zero, then one
    witness batch of 256: masks, every root (28 spine levels each), every
    witness field (proofs 40 deep) and the state bit for bit; a root read
    counts 28 spine launches on either device."""
    from imt_tpu_torch.utils import observability as obs
    gpu = SparseIndexedMerkleTree(40, initial_capacity_log2=12, device=cuda)
    cpu = SparseIndexedMerkleTree(40, initial_capacity_log2=12, device="cpu")
    vals = field.random_limbs(40, 5 * 256).reshape(16, 5, 256) \
        .transpose(1, 0, 2).copy()
    vals[1][:, 0] = vals[0][:, 5]
    vals[2][:, 7] = 0
    masks = []
    for block in vals[:4]:
        masks.append(gpu.insert_batches(block[None])[0])
        assert np.array_equal(masks[-1], cpu.insert_batches(block[None])[0])
        before = obs.total("spine.launches")
        assert gpu.get_root_int() == cpu.get_root_int()
        assert obs.total("spine.launches") - before == 2 * 28
    assert masks[0].all() and masks[3].all()
    assert np.flatnonzero(~masks[1]).tolist() == [0]
    assert np.flatnonzero(~masks[2]).tolist() == [7]
    wg = _fields(gpu.insert_batch(vals[4], witness=True))
    wc = _fields(cpu.insert_batch(vals[4], witness=True))
    assert wg["low_leaf_proof"].shape == (40, 16, 256)
    for k in wc:
        assert np.array_equal(np.asarray(wg[k]), np.asarray(wc[k])), k
    assert gpu.active_depth == cpu.active_depth == 12
    for g, c in zip(gpu.levels + [gpu.vals, gpu.next_vals, gpu.next_idxs],
                    cpu.levels + [cpu.vals, cpu.next_vals, cpu.next_idxs]):
        assert torch.equal(g.cpu(), c)
    assert gpu.get_root_int() == cpu.get_root_int()


def test_witness_walk_graphs_equal_the_cpu_walk(cuda):
    """Witness batches whose walk the tree replays from a CUDA graph equal
    the CPU's op-by-op walk bit for bit, every field, with the levels, the
    state and the root after each batch: four batches of K = 8 on one
    depth-16 tree (s0 moves under one graph), two of K = 5 (a second key),
    a fresh tree, and a sparse tree whose prefix grows across a batch (a
    new key).  A key's first call runs eagerly, its second captures and
    replays; a batch launches as many hash2 as on the CPU; a witness kept
    on the card (``as_numpy=False``) is not changed by later replays."""
    from imt_tpu_torch.utils import observability as obs
    walk = ("walk.eager", "walk.graph_captures", "walk.graph_replays")
    hashes = ("hash2.launches", "hash2.lanes")
    rng = np.random.default_rng(15)
    seen = []

    def batch(k):
        vals = [int(v) for v in rng.integers(1, 1 << 62, k)]
        if k >= 4:
            vals[1], vals[-1] = vals[0], 0      # a duplicate and a zero
            if seen:
                vals[2] = seen[0]               # present in the first tree
        seen.extend(vals)
        return vals

    def step(gpu, cpu, vals, as_numpy=True):
        """One batch on both; returns the card's witness and its walk
        counts (eager, captures, replays)."""
        c0 = {n: obs.total(n) for n in walk + hashes}
        k2 = _launched()
        wg = gpu.insert_batch(vals, witness=True, as_numpy=as_numpy)
        torch.cuda.synchronize()
        got = {n: obs.total(n) - c0[n] for n in walk + hashes}
        k2 = _launched(k2)["hash2_nodes"]
        c1 = {n: obs.total(n) for n in hashes}
        wc = _fields(cpu.insert_batch(vals, witness=True))
        for n in hashes:
            assert got[n] == obs.total(n) - c1[n], n
        assert k2 == got["hash2.launches"] > 0
        fg = _fields(wg)
        for k in wc:
            assert np.array_equal(np.asarray(fg[k]), np.asarray(wc[k])), k
        for g, c in zip(gpu.levels + [gpu.vals, gpu.next_vals,
                                      gpu.next_idxs],
                        cpu.levels + [cpu.vals, cpu.next_vals,
                                      cpu.next_idxs]):
            assert torch.equal(g.cpu(), c)
        assert gpu.get_root_int() == cpu.get_root_int()
        return wg, tuple(got[n] for n in walk)

    eager, capture, replay = (1, 0, 0), (0, 1, 1), (0, 0, 1)
    gpu = IndexedMerkleTree(16, device=cuda)
    cpu = IndexedMerkleTree(16, device="cpu")
    counts = []
    for i in range(4):
        w, c = step(gpu, cpu, batch(8), as_numpy=i != 1)
        counts.append(c)
        if i == 1:
            kept, frozen = w, {k: v.clone() for k, v in vars(w).items()}
    assert counts == [eager, capture, replay, replay]
    assert isinstance(kept.ok, torch.Tensor) and kept.ok.is_cuda
    for k, v in frozen.items():
        assert torch.equal(getattr(kept, k), v), k
    assert [step(gpu, cpu, batch(5))[1] for _ in range(2)] == [eager,
                                                               capture]
    assert step(gpu, cpu, batch(8))[1] == replay    # K = 8's graph is kept

    fresh_g = IndexedMerkleTree(16, device=cuda)
    fresh_c = IndexedMerkleTree(16, device="cpu")
    assert [step(fresh_g, fresh_c, batch(8))[1] for _ in range(2)] == [
        eager, capture]

    sg = SparseIndexedMerkleTree(16, initial_capacity_log2=3, device=cuda)
    sc = SparseIndexedMerkleTree(16, initial_capacity_log2=3, device="cpu")
    counts = []
    for _ in range(5):                          # slots 1..10 of 8, then 16
        counts.append(step(sg, sc, batch(2))[1])
    assert sg.active_depth == sc.active_depth == 4
    assert counts == [eager, capture, replay, eager, capture]


def test_walk_graph_replay_on_the_coop_path_equals_the_eager_walk(cuda):
    """Three witness batches of K = 16 on a depth-12 tree whose walk runs
    eagerly, then is captured and replayed as a CUDA graph, against the
    same batches on a twin whose walk runs eagerly each time (its graphs
    reset before every batch): every field and level equal; each walk's
    hash2 launches (2K = 32 lanes, below the crossover) take the
    cooperative kernel, the replays' counted from their capture."""
    from imt_tpu_torch.tree.batch_witness import WalkGraphs
    names = ("cuda.hash2_nodes", "cuda.hash2_nodes.coop", "walk.eager",
             "walk.graph_replays")
    rng = np.random.default_rng(16)
    graphed = IndexedMerkleTree(12, device=cuda)
    eager = IndexedMerkleTree(12, device=cuda)
    for i in range(3):
        vals = [int(v) for v in rng.integers(1, 1 << 62, 16)]
        vals[3] = 0
        start = {n: observability.total(n) for n in names}
        wg = _fields(graphed.insert_batch(vals, witness=True))
        torch.cuda.synchronize()
        got = {n: observability.total(n) - start[n] for n in names}
        eager._walk_graphs = WalkGraphs()
        we = _fields(eager.insert_batch(vals, witness=True))
        assert got["walk.eager"] == (i == 0)
        assert got["walk.graph_replays"] == (i > 0)
        assert got["cuda.hash2_nodes.coop"] == got["cuda.hash2_nodes"] > 0
        for k in we:
            assert np.array_equal(np.asarray(wg[k]), np.asarray(we[k])), k
        for g, e in zip(graphed.levels, eager.levels):
            assert torch.equal(g, e)
    assert graphed.get_root_int() == eager.get_root_int()


@pytest.mark.parametrize("width", [1, 2, 1000])
def test_hash_fixed_on_the_card_equals_plain(cuda, width):
    """hashing.hash_fixed at arities 1-8 on the card against the plain
    sponge, with p - 1 in every absorbed word of column 2: arity // 2 + 1
    K1 launches a call at every arity through poseidon_cuda.hash_fixed,
    which at arities 2 and 3 equals hash2 and hash3."""
    cols = [_limbs(10 + j, width, cuda) for j in range(8)]
    cols[2] = torch.as_tensor(np.repeat(
        field.int_to_limbs(FIELD_MODULUS - 1)[:, None], width, axis=1),
        device=cuda)
    for n in range(1, 9):
        start = _launched()
        got = poseidon_cuda.hash_fixed(cols[:n])
        torch.cuda.synchronize()
        assert _launched(start)["permute_n"] == n // 2 + 1
        assert _launched(start)["hash2_nodes"] == 0
        assert _launched(start)["hash3_leaf"] == 0
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
                          hashing.hash2(a, b).cpu().numpy())
    assert np.array_equal(oracle.u64_to_limbs(oracle.hash3_u64(*u)),
                          hashing.hash3(a, b, c).cpu().numpy())


def test_sparse_proofs_beyond_the_prefix_on_the_card(cuda):
    """tests/test_torch_port_faults.py's every-slot check on the card: a
    depth-6 sparse tree holding 2^2 slots against the dense tree, each
    proof verifying; and the CPU tree's slot 63 proof equal."""
    sparse = SparseIndexedMerkleTree(faults.DEPTH, faults.CAP, device=cuda)
    dense = IndexedMerkleTree(faults.DEPTH, device=cuda)
    sparse.insert_batch(faults.VALUES)
    dense.insert_batch(faults.VALUES)
    assert sparse.active_depth == faults.CAP
    faults.check_all_proofs(sparse, dense)
    cpu = SparseIndexedMerkleTree(faults.DEPTH, faults.CAP, device="cpu")
    cpu.insert_batch(faults.VALUES)
    for got, want in zip(sparse.get_proof(63), cpu.get_proof(63)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", ["dense", "sparse", "unsharded"])
def test_empty_insert_seq_on_the_card(cuda, kind, request):
    if kind == "unsharded":
        from imt_tpu_torch.parallel.sharded import ShardedIndexedMerkleTree
        mesh = request.getfixturevalue("one_rank_mesh")
        tree = ShardedIndexedMerkleTree(4, mesh, sparse=False, device=cuda)
        assert not tree.is_sharded
    elif kind == "sparse":
        tree = SparseIndexedMerkleTree(4, initial_capacity_log2=1,
                                       device=cuda)
    else:
        tree = IndexedMerkleTree(4, device=cuda)
    faults.check_empty_insert_seq(tree)
    assert tree.insert_seq([]).old_root.device.type == "cuda"
