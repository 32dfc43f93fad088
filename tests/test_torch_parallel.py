"""imt_tpu_torch.parallel on four gloo ranks (CPU).

The counterpart of tests/test_parallel.py.  One spawn of four ranks
(chip_smoke.py's ``start_ranks``: torch.multiprocessing's spawn, a
``file://`` store in the test's directory, a 120 s timeout: a rank that
fails or hangs fails the module)
runs tests/_torch_parallel_ranks.py's ``parallel_ranks``; meanwhile this
process runs the same scenarios on the port's single-device trees (among
them tests/test_torch_chained.py's chain and queries, which that file holds
against imt_tpu's).  Held bit for bit: the meshes (1-D of 4, 2 and 1
ranks, 2 x 2), the data-parallel hashes, the 1-D and 2-D tree builds
against MerkleTree, the sharded container at D = 4 (insert_batch across a
shard boundary with duplicates, a zero and a value >= p; insert; a
witness batch with a duplicate of a present value; insert_seq on its
accepted lanes; non-inclusion witnesses; proofs and leaves; the state), a
sparse tree that grows from replicated to sharded and re-shards, the D = 1
routing to the plain step, checkpoints (saved at D = 4, loaded at D = 2; a
plain snapshot onto the mesh; EngineConfig(mesh_devices=2)).  Tolerance:
exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

import test_torch_chained as chained
from imt_tpu_torch.ops import field, hashing
from imt_tpu_torch.tree.merkle import MerkleTree
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
# the ranks unpickle chip_smoke's rank entry: the root stays on the path
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke  # noqa: E402

RANKS_FILE = os.path.join(HERE, "_torch_parallel_ranks.py")
TIMEOUT = 120.0


def _ranks_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("_torch_parallel_ranks",
                                                  RANKS_FILE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _ranks_module()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ranks"))
    plain = os.path.join(work, "plain.npz")
    snap = R.plain_snapshot(plain)
    ranks = chip_smoke.start_ranks(
        f"{RANKS_FILE}:parallel_ranks", 4,
        dict(work_dir=work, plain_snapshot=plain), work, TIMEOUT)
    try:
        ref = R.parallel_reference(snap)
    except BaseException:
        ranks.kill()
        raise
    return ranks.wait(), ref


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    return a == b


def test_ranks_agree_on_every_replicated_output(run):
    """Every output but a rank's own shard (hashes, its subtree root) is
    the same on the four ranks."""
    ranks = run[0]
    own = {"hash2", "hash3", "own22", "mesh", "g.sharded0", "g.sharded1",
           "g.sharded2", "g.growth"}
    for key, v in ranks[0].items():
        if key not in own:
            assert all(_equal(v, r[key]) for r in ranks[1:]), key


def test_mesh_layouts(run):
    """make_mesh over the world, in blocks of 2 and of 1, and make_mesh2's
    (host, chip) grid: rank 3 sits in the second block of 2 and at (1, 1)."""
    ranks = run[0]
    m4, m2, m1, m22 = ranks[3]["mesh"]
    assert m4 == (("shard",), [0, 1, 2, 3], (3,))
    assert m2 == (("shard",), [2, 3], (1,))
    assert m1 == (("shard",), [3], (0,))
    assert m22 == (("host", "chip"), [[0, 1], [2, 3]], (1, 1))


@pytest.mark.parametrize("name", ["hash2", "hash3"])
def test_sharded_hashes(run, name):
    """Each rank hashes its 2 of 8 columns; in rank order they are the
    single-device hash's."""
    rng = np.random.default_rng(11)
    a, b, c = (torch.as_tensor(field.random_limbs(
        int(rng.integers(1 << 30)), 8, 253)) for _ in range(3))
    want = hashing.hash2(a, b) if name == "hash2" else hashing.hash3(a, b, c)
    got = np.concatenate([r[name] for r in run[0]], axis=1)
    assert np.array_equal(got, want.numpy())


def test_sharded_tree_roots(run):
    """The 1-D build over 4 and over 2 ranks and the 2 x 2 build: the top's
    last column is MerkleTree's root, its first D columns the subtree
    roots; the 2-D build's host-major leaf order is the flat one's."""
    ranks = run[0]
    leaves = field.random_limbs(5, 16, 253)
    root = lambda x: MerkleTree.build(x, device="cpu").get_root_int()
    ints = lambda x: field.limbs_to_ints(x)
    top4, top2 = ranks[0]["top4"], ranks[0]["top2"]
    assert top4.shape == (16, 7) and top2.shape == (16, 3)
    assert ints(top4)[-1] == root(leaves)
    assert ints(top4)[:4] == [root(leaves[:, 4 * i:4 * i + 4])
                              for i in range(4)]
    assert ints(top2)[-1] == root(leaves[:, :8])
    assert ints(ranks[0]["top22"])[-1] == ints(ranks[0]["root22"])[0] \
        == root(leaves)
    assert ranks[0]["top22"].shape == (16, 3)
    assert [ints(r["own22"])[0] for r in ranks] == ints(top4)[:4]


CONTAINER_KEYS = (["c.ok1", "c.root1", "c.root", "c.count", "c.depth",
                   "c.vals", "c.next_vals", "c.next_idxs"]
                  + [f"c.{w}{i}" for w in ("proof", "helpers", "leaf")
                     for i in R.C_PROOFS])


@pytest.mark.parametrize("key", CONTAINER_KEYS)
def test_container_state_matches_single_device(run, key):
    ranks, ref = run
    assert ranks[0]["c.sharded"]
    assert _equal(ranks[0][key], ref[key]), key


@pytest.mark.parametrize("part,name", [
    (p, n) for p in ("insert", "wb") for n in R.INSERT_FIELDS]
    + [("ni", n) for n in R.QUERY_FIELDS])
def test_container_witnesses_match_single_device(run, part, name):
    """insert (a K = 1 witness batch), the witness batch (P + 5, a
    duplicate of 30) and the non-inclusion witnesses (present values,
    zero, a value >= p): every lane."""
    ranks, ref = run
    key = f"c.{part}.{name}"
    assert _equal(ranks[0][key], ref[key]), key


@pytest.mark.parametrize("name", R.INSERT_FIELDS)
def test_insert_seq_matches_sequential_on_accepted_lanes(run, name):
    """insert_seq is the witness batch when sharded: equal to sequential
    inserts on its accepted lanes (42 is present: rejected)."""
    ranks, ref = run
    ok = ref["c.seq.ok"]
    assert ok.tolist() == [True, False, True]
    assert np.array_equal(ranks[0]["c.seq.ok"], ok)
    a, b = ranks[0][f"c.seq.{name}"], ref[f"c.seq.{name}"]
    assert a.shape == b.shape and np.array_equal(a[..., ok], b[..., ok])


def test_growth_crosses_the_sharding_threshold(run):
    """A sparse depth-5 tree from 2 slots over 4 ranks: replicated (the
    plain step, no shard-local program) until it holds 8 slots, then
    sharded, then re-sharded at 16; masks and state equal the single
    device's."""
    ranks, ref = run
    r = ranks[0]
    assert [r[f"g.ad{i}"] for i in range(3)] == [2, 3, 4] == [
        ref[f"g.ad{i}"] for i in range(3)]
    flags = [r[f"g.sharded{i}"] for i in range(3)]
    assert [f[0] for f in flags] == [False, True, True]
    calls = [f[1]["local_insert_batch"] for f in flags]
    assert calls == [1, 2, 3]          # the container's batch, then one each
    for key in [k for k in ref if k.startswith("g.")]:
        assert _equal(r[key], ref[key]), key


def test_growth_moves_only_the_new_slices(run):
    """The re-shard from 2 to 4 slots per rank is point to point, counted
    apart from the batches: rank 0 receives rank 1's old slice, rank 1
    ranks 2's and 3's, ranks 2 and 3 nothing; no rank receives more than
    its new slice ([48, 4] int32), O(N/D) and never the state.  The
    replicated-to-sharded step before it moves nothing."""
    old_slice = 3 * field.LIMBS * 2 * 4
    got = [r["g.growth"] for r in run[0]]
    assert got == [[("slices", old_slice)], [("slices", old_slice)] * 2,
                   [], []]
    assert max(sum(b for _, b in g) for g in got) == 2 * old_slice


def test_one_device_mesh_routes_to_plain_step(run):
    """D = 1 (tests/test_parallel.py:146): no shard-local program runs
    (each raises if called), and the results are the plain tree's."""
    ranks, ref = run
    for r in ranks:
        assert r["one.sharded"] is False
        for key in [k for k in ref if k.startswith("one.")]:
            assert _equal(r[key], ref[key]), key


def test_checkpoint_saved_at_d4_loads_at_d2(run):
    """The sharded snapshot carries the marker; loaded onto a 2-rank mesh
    it is sharded there, with the root and count it was saved with, and
    takes the next batch as the single-device tree does."""
    ranks, ref = run
    r = ranks[0]
    assert r["ck.marker"] == 1
    assert r["ck.kind"] == ("ShardedIndexedMerkleTree", 2, True)
    assert r["ck.count0"] == ref["c.count"] and r["ck.root0"] == ref["c.root"]
    for key in [k for k in ref if k.startswith("ck.")]:
        assert _equal(r[key], ref[key]), key


def test_plain_snapshot_onto_a_mesh(run):
    ranks, ref = run
    r = ranks[0]
    assert r["pk.kind"] == ("ShardedIndexedMerkleTree", 4, True)
    for key in [k for k in ref if k.startswith("pk.")]:
        assert _equal(r[key], ref[key]), key


def test_engine_config_builds_the_sharded_tree(run):
    ranks, ref = run
    for r in ranks:
        assert r["cfg.kind"] == ("ShardedIndexedMerkleTree", 2, True, "cpu")
        for key in [k for k in ref if k.startswith("cfg.")]:
            assert _equal(r[key], ref[key]), key


@pytest.mark.parametrize("key", ["j.oks", "j.root", "j.count", "j.vals",
                                 "j.next_vals", "j.next_idxs", "j.sparse"]
                         + [f"j.ni.{n}" for n in R.QUERY_FIELDS])
def test_chain_and_queries_match_imt_tpu(run, key):
    """The chained insert_batches and the non-inclusion witnesses on a
    sparse depth-6 tree holding 2^4 slots (4 per rank): the sharded tree's
    equal the port's single-device tree's, bit for bit, on every rank.
    The single-device tree's equal imt_tpu's on the same batches and
    queries in tests/test_torch_chained.py
    (test_insert_batches_matches_imt_tpu, test_queries_match_imt_tpu)."""
    ranks, ref = run
    assert (R.J_BATCHES, R.J_QUERIES) == (chained.BATCHES, chained.QUERIES)
    for r in ranks:
        assert _equal(r[key], ref[key]), key


def test_sharded_proofs_beyond_the_prefix(run):
    """get_proof on the sharded depth-6 tree holding 2^4 slots, inside the
    prefix (a collective) and beyond it (the zero spine, no collective):
    equal to the single-device sparse tree's on every rank, and each
    verifies against the root with its slot's leaf (an empty slot's is
    H(0, 0, 0))."""
    from imt_tpu_torch.tree.merkle import verify_proofs
    ranks, ref = run
    for r in ranks:
        for i in R.J_PROOFS:
            for w in ("proof", "helpers"):
                assert _equal(r[f"j.{w}{i}"], ref[f"j.{w}{i}"]), (w, i)
    cols = lambda name: torch.as_tensor(ref[f"j.{name}"][:, list(
        i if i < ref["j.vals"].shape[1] else 0 for i in R.J_PROOFS)]
        .astype(np.int32))
    beyond = torch.tensor([i >= ref["j.vals"].shape[1] for i in R.J_PROOFS])
    vals, nvs, nis = (torch.where(beyond, 0, cols(n))
                      for n in ("vals", "next_vals", "next_idxs"))
    leaves = hashing.hash3(vals, nvs, nis)
    proofs = torch.as_tensor(np.concatenate(
        [ref[f"j.proof{i}"] for i in R.J_PROOFS], axis=-1).astype(np.int32))
    root = torch.as_tensor(field.ints_to_limbs([ref["j.root"]]))
    assert verify_proofs(leaves, list(R.J_PROOFS), root, proofs,
                         "cpu").all()
    for i in R.J_PROOFS:
        assert ref[f"j.helpers{i}"][:, 0].tolist() == [
            int(((i >> d) & 1) == 0) for d in range(R.J_FULL)]
