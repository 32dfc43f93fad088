"""PublicDataTree (Aztec's public data tree, the benchmark's
``public-data-d40-2p22``) on the CPU, held to the benchmark's plain
reference (``imtbench/reference/public_data.py``), which imports nothing of
the program.  There is no counterpart in ``imt_tpu``.

Held: ``write_batches`` at depth 40 and an active prefix of 2^5 over three
blocks of 8 with planted cases (a slot updated across blocks, two and three
writes to one slot in one block, the first an insert and the last
winning, slot 0, value 0, and an update whose leader is the low leaf of an
insert in the same block): outcomes, roots and every leaf column; growth
past the prefix; the leaf hash H4 three ways; the methods that assume a
three-field leaf; the snapshot round trip; the nullifier trees' roots,
masks and launch counts after the zero chain and the planner became the
tree's own; the work count against a brute force; the cell end to end
through ``imtbench.run.run_cell`` at a 2^5 prefix, and three planted faults
of this file's own that each make it not correct; the two readers of the
cell's new metrics.

Hashes are python ints on both sides, as in ``test_torch_sparse_deep.py``:
the port's Poseidon dispatch is pointed at its python-int oracle
(``ops/poseidon_ref.hash_fixed``), the reference's ``Hasher`` permutes each
lane with ``reference/poseidon.permute_int``; only the H4 test runs the
plain torch sponge.  The card twin is
``test_public_data_tree_on_cuda_equals_cpu`` (marked ``cuda``, skips
without a card).  Tolerance: exact.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import field, hashing, poseidon as plain
from imt_tpu_torch.ops.poseidon_ref import hash_fixed
from imt_tpu_torch.ops.poseidon_spec import default_params
from imt_tpu_torch.tree import indexed, public_data
from imt_tpu_torch.tree.public_data import (ZERO_PUBLIC_DATA_LEAF_HASH,
                                            PublicDataTree)
from imt_tpu_torch.utils import checkpoint, checks, observability
from imtbench import harness, run
from imtbench.reference import poseidon, public_data as ref, tree as nref
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
DEPTH, PREFIX, K = 40, 5, 8
SEED = 2 ** 33 + 20
CELL = "pd40-2p22.upsert-2k"
CARD = {"sm_count": 132, "clock_mhz": 1980.0, "power_limit": "700.00 W"}
A, B, C, D, Y = 7 << 200, 3 << 100, 11 << 150, 5 << 180, 9 << 120


class _IntPoseidon:
    """The port's Poseidon entry points, each lane through the python-int
    oracle; nodes are Montgomery words, as on the plain path."""

    @staticmethod
    def _ints(x):
        return [field.node_to_int(c) for c in x.T.numpy()]

    @staticmethod
    def _nodes(ints):
        return torch.as_tensor(np.stack([field.int_to_node(v) for v in ints],
                                        axis=1))

    @classmethod
    def hash2_nodes(cls, a, b):
        p = default_params()
        return cls._nodes([hash_fixed([x, y], p)
                           for x, y in zip(cls._ints(a), cls._ints(b))])

    @classmethod
    def hash_fixed_nodes(cls, cols):
        p = default_params()
        ints = [field.limbs_to_ints(x.numpy()) for x in cols]
        return cls._nodes([hash_fixed(list(v), p) for v in zip(*ints)])

    @classmethod
    def hash3_leaf(cls, a, b, c):
        return cls.hash_fixed_nodes([a, b, c])

    @classmethod
    def nodes_to_limbs(cls, x):
        return torch.as_tensor(field.ints_to_limbs(cls._ints(x)))

    @classmethod
    def limbs_to_nodes(cls, x):
        return cls._nodes(field.limbs_to_ints(x.numpy()))


class _IntHasher(poseidon.Hasher):
    """The reference's ``Hasher`` with each lane permuted by its spec form,
    ``permute_int``: the same Montgomery limbs in and out."""

    def permute(self, s):
        words = [self.to_ints(s[i]) for i in range(3)]
        out = [poseidon.permute_int(list(w)) for w in zip(*words)]
        return torch.stack([torch.tensor(
            [poseidon.int_limbs(o[i] * self.r % self.p) for o in out],
            dtype=torch.int64).T for i in range(3)])


H = _IntHasher(torch.device(CPU))


@pytest.fixture(autouse=True)
def int_poseidon(monkeypatch):
    monkeypatch.setattr(hashing, "_impl", lambda x: _IntPoseidon)
    observability.disable()
    observability.reset()
    yield
    observability.disable()
    observability.reset()


def _limbs(xs) -> np.ndarray:
    return poseidon.ints_to_limbs16([int(x) for x in xs])


def _stream():
    """(slots, values) [16, 24]: three blocks of 8 with the plants.  Block
    0: A inserted then updated, D inserted then updated twice, slot 0.
    Block 1: B updated across blocks, E inserted with value 0, A set to
    value 0, Y inserted.  Block 2: Y + 1 inserted with Y its low leaf
    while Y is updated, C twice more."""
    rnd = [int(v) for v in np.random.default_rng(SEED).integers(
        1, 1 << 62, size=24)]
    e = rnd[0] << 60
    slots = [A, B, A, 0, C, D, D, D,
             B, e, rnd[1] << 40, A, rnd[2] << 30, D, rnd[3] << 50, Y,
             Y, Y + 1, C, rnd[4] << 70, C, B, rnd[5] << 33, rnd[6] << 90]
    values = [v % poseidon.P for v in rnd]
    values[9] = values[11] = 0
    return _limbs(slots), _limbs(values)


def _blocks(x: np.ndarray, k: int = K) -> np.ndarray:
    return np.ascontiguousarray(x.reshape(16, -1, k).transpose(1, 0, 2))


def _tree(prefix: int = PREFIX):
    return PublicDataTree(DEPTH, initial_capacity_log2=prefix, device=CPU)


def _state(tree) -> list:
    return [x.numpy().astype(np.int64) for x in
            (tree.vals, tree.leaf_values, tree.next_vals, tree.next_idxs)]


def _check_state(tree, slots, values):
    """Every column of every slot against the reference's leaf state."""
    want = ref.leaf_state(slots, values)
    n = want[0].shape[1]
    for got, w in zip(_state(tree), want):
        assert np.array_equal(got[:, :n], w)
        assert not got[:, n:].any()


def test_writes_equal_the_reference():
    """Three blocks through write_batches: outcomes, the depth-40 root
    after each block, and the four columns of every slot equal the
    reference's; the plants give the outcomes and values meant."""
    slots, values = _stream()
    want = ref.outcomes(slots).reshape(3, K)
    assert want.tolist() == [[1, 1, 2, 0, 1, 1, 2, 2],
                             [2, 1, 1, 2, 1, 2, 1, 1],
                             [2, 1, 2, 1, 2, 2, 1, 1]]
    tree = _tree()
    for b, (ks, vs) in enumerate(zip(_blocks(slots), _blocks(values))):
        out = tree.write_batches(ks[None], vs[None])
        assert out.dtype == np.int8 and np.array_equal(out[0], want[b]), b
        n = K * (b + 1)
        assert tree.get_root_int() == ref.tree_root(
            H, slots[:, :n], values[:, :n], DEPTH), b
        _check_state(tree, slots[:, :n], values[:, :n])
    assert tree.active_depth == PREFIX and tree.count == 3 * K
    key, val, _, _ = ref.leaf_state(slots, values)
    at = lambda s: int(np.flatnonzero((key == _limbs([s])).all(axis=0))[0])
    last = lambda col: poseidon.limbs16_to_ints(values[:, col:col + 1])[0]
    got = lambda s: poseidon.limbs16_to_ints(val[:, at(s):at(s) + 1])[0]
    assert at(A) == 1 and got(A) == 0 and got(D) == last(13)
    assert got(C) == last(20) and got(B) == last(21) and got(Y) == last(16)
    # Y + 1's low leaf is Y, whose value this block also wrote
    assert _state(tree)[2][:, at(Y)].tolist() == _limbs([Y + 1])[:, 0] \
        .tolist()


def test_growth_past_the_prefix_keeps_the_roots():
    """A tree that starts at a 2^2 prefix grows twice over the three
    blocks (each growth rehashes four columns through H4) and gives the
    reference's roots and state; the growth is counted."""
    slots, values = _stream()
    tree = _tree(2)
    observability.enable()
    for b, (ks, vs) in enumerate(zip(_blocks(slots), _blocks(values))):
        tree.write_batches(ks[None], vs[None])
        n = K * (b + 1)
        assert tree.get_root_int() == ref.tree_root(
            H, slots[:, :n], values[:, :n], DEPTH), b
    assert tree.active_depth == 5
    assert observability.total("sparse.grows") == 2
    _check_state(tree, slots, values)


def test_leaf_hash_three_ways(monkeypatch):
    """H4 of seeded limbs: the reference's sponge on its Hasher, the
    port's plain torch sponge (nodes out and limbs out) and python ints
    agree; the empty leaf is H4(0,0,0,0) on every side, and it is the zero
    chain's first level."""
    monkeypatch.undo()
    rng = np.random.default_rng(4)
    cols = [rng.integers(0, 1 << 16, size=(16, 3)) for _ in range(4)]
    for c in cols:
        c[15] &= (1 << 13) - 1
    cols[0][:, 2] = cols[1][:, 2] = cols[2][:, 2] = cols[3][:, 2] = 0
    want = [poseidon.hash_int(list(v)) for v in zip(
        *[poseidon.limbs16_to_ints(c) for c in cols])]
    assert want[2] == ZERO_PUBLIC_DATA_LEAF_HASH == ref.zero_hashes(0)[0]
    hr = poseidon.Hasher(CPU)
    assert hr.to_ints(ref.leaf_nodes(hr, *cols)) == want
    t = [torch.as_tensor(c, dtype=torch.int32) for c in cols]
    assert field.limbs_to_ints(hashing.dec_nodes(
        hashing.hash_fixed_nodes(t)).numpy()) == want
    assert field.limbs_to_ints(plain.hash_fixed(t).numpy()) == want
    assert indexed._zero_level_roots(3, ZERO_PUBLIC_DATA_LEAF_HASH) == \
        ref.zero_hashes(3)


def test_rebuild_root_reads_the_leaf_kind():
    """checks.rebuild_root hashes the leaves by the tree's own leaf hash
    and folds them over its own zero spine: a public data tree's rebuild
    equals its root, and the same state read as nullifier leaves does
    not."""
    slots, values = _stream()
    tree = _tree(3)
    tree.write_batches(_blocks(slots)[:1], _blocks(values)[:1])
    assert checks.rebuild_root(tree) == tree.get_root_int() \
        == ref.tree_root(H, slots[:, :K], values[:, :K], DEPTH)
    nullifier = SparseIndexedMerkleTree(DEPTH, initial_capacity_log2=3,
                                        device=CPU)
    for name in nullifier.COLUMNS:
        setattr(nullifier, name, getattr(tree, name))
    assert checks.rebuild_root(nullifier) != tree.get_root_int()


def test_three_field_methods_raise():
    tree = _tree()
    for name, args in (("insert", (5,)), ("insert_seq", ([5],)),
                       ("insert_batch", ([5],)), ("insert_batches", ([[5]],)),
                       ("non_inclusion_witness", ([5],)),
                       ("get_leaf_ints", (1,))):
        with pytest.raises(NotImplementedError, match="write_batches"):
            getattr(tree, name)(*args)
    with pytest.raises(ValueError, match="differ in shape"):
        tree.write_batches([[1, 2]], [[1, 2, 3]])
    assert tree.count == 0


def test_snapshot_round_trip(tmp_path):
    """to_arrays carries leaf_values; from_arrays and a checkpoint's load
    give back a PublicDataTree with the same state and root, which takes
    the next block as the original does; a snapshot without leaf_values
    does not load as one."""
    slots, values = _stream()
    ks, vs = _blocks(slots), _blocks(values)
    tree = _tree()
    tree.write_batches(ks[:2], vs[:2])
    arrays = tree.to_arrays()
    assert {"vals", "leaf_values", "next_vals", "next_idxs", "sparse"} \
        <= set(arrays)
    path = str(tmp_path / "pd.npz")
    checkpoint.save(tree, path)
    for back in (PublicDataTree.from_arrays(arrays, device=CPU),
                 checkpoint.load(path, device=CPU)):
        assert type(back) is PublicDataTree and back.count == 2 * K
        for g, w in zip(_state(back), _state(tree)):
            assert np.array_equal(g, w)
        assert back.get_root_int() == tree.get_root_int()
    back.write_batches(ks[2:], vs[2:])
    tree.write_batches(ks[2:], vs[2:])
    assert back.get_root_int() == tree.get_root_int()
    del arrays["leaf_values"]
    with pytest.raises(KeyError):
        PublicDataTree.from_arrays(arrays, device=CPU)


@pytest.mark.parametrize("sparse", [False, True])
def test_nullifier_trees_unchanged(sparse):
    """A dense depth-6 and a sparse depth-40 nullifier tree after the
    tree-owned zero chain and planner: masks and roots the nullifier
    reference's, one hash3 launch a batch and no permutation launch, the
    path update's and the spine's hash2 launches as before, and the zero
    chain of H(0,0,0) wherever no leaf is named."""
    vals = poseidon.ints_to_limbs16(
        [int(v) for v in np.random.default_rng(6).integers(1, 1 << 60, 12)])
    vals[:, 5], vals[:, 9] = vals[:, 1], 0
    depth = 40 if sparse else 6
    tree = SparseIndexedMerkleTree(depth, initial_capacity_log2=5,
                                   device=CPU) if sparse \
        else IndexedMerkleTree(depth, device=CPU)
    assert tree.zero_leaf == indexed.ZERO_LEAF_HASH
    assert tree.COLUMNS == ("vals", "next_vals", "next_idxs")
    observability.enable()
    for b in range(3):
        ok = tree.insert_batches(vals[None, :, 4 * b:4 * b + 4])
        assert np.array_equal(ok[0], nref.accepted(vals)[4 * b:4 * b + 4])
        assert tree.get_root_int() == nref.tree_root(
            H, vals[:, :4 * (b + 1)], depth)
    c = observability.snapshot()["session"]["counts"]
    cross = indexed._crossover(5 if sparse else 6, 4)
    spine = 35 if sparse else 0
    assert (c["hash3.launches"], c["hash3.lanes"]) == (3, 3 * 8)
    assert "perm.launches" not in c
    assert c["hash2.launches"] == 3 * (2 * cross + (tree.active_depth - cross)
                                       + spine)
    assert c.get("spine.launches", 0) == 3 * spine
    assert indexed._zero_level_roots(4) == nref.zero_hashes(4)
    assert indexed._zero_level_roots(4) == indexed._zero_level_roots(
        4, indexed.ZERO_LEAF_HASH)


def test_public_data_launches():
    """A block of 8 at prefix 2^5: the dirty leaves as one H4 sponge of
    width 16 (three permutation launches, no hash3), the path update's
    hash2 as a nullifier tree's, and its root's 35 spine launches; the
    ``upsert`` span sits beside ``sort``, ``link`` and ``leaf_hash`` and
    the outcomes are counted."""
    slots, values = _stream()
    tree = _tree()
    observability.enable()
    tree.write_batches(_blocks(slots)[:1], _blocks(values)[:1])
    tree.get_root_int()
    s = observability.snapshot()["session"]
    c = s["counts"]
    assert (c["perm.launches"], c["perm.lanes"]) == (3, 3 * 16)
    assert "hash3.launches" not in c
    cross = indexed._crossover(PREFIX, K)
    assert c["hash2.launches"] == 2 * cross + (PREFIX - cross) + 35
    assert c["spine.launches"] == 35
    assert (c["writes.inserted"], c["writes.updated"],
            c["writes.rejected"]) == (4, 3, 1)
    spans = s["spans"]
    names = [sp["name"] for sp in spans]
    parent = spans[names.index("upsert")]["parent"]
    assert spans[parent]["name"] == "write_batches"
    assert {"sort", "link", "leaf_hash"} <= {
        sp["name"] for sp in spans if sp["parent"] == parent}
    out = tree.write_batches(_blocks(slots)[1:2], _blocks(values)[1:2],
                             as_numpy=False)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int8
    assert observability.total("writes.submitted") == K


@pytest.mark.parametrize("cut", [0, 3, 8, 16])
def test_needed_perms_against_brute_force(cut):
    """The work count: 3 permutations a leaf whose preimage changes, 2 a
    distinct ancestor up to the prefix root and 2 a spine level, by
    comparing the leaf states before and after."""
    slots, values = _stream()
    before = np.stack(ref.leaf_state(slots[:, :cut], values[:, :cut]))
    after = np.stack(ref.leaf_state(slots, values))
    padded = np.zeros_like(after)
    padded[:, :, :before.shape[2]] = before
    changed = [s for s in range(after.shape[2])
               if not np.array_equal(padded[:, :, s], after[:, :, s])]
    nodes = {(d, s >> d) for s in changed for d in range(1, 6)}
    assert ref.needed_perms(slots[:, :cut], slots[:, cut:], 5, 9) == \
        3 * len(changed) + 2 * (len(nodes) + 4)


def _cell(seed=SEED, trace=False):
    """The cell at a 2^5 prefix, blocks of 8 (two transactions of 4, two
    fee payers); the traced group is moved into the tree."""
    return run.run_cell(CELL, seed, 0.01, trace, device=CPU, overrides={
        "config": {"capacity_log2": PREFIX},
        "traffic": {"block_size": K, "tx_size": 4, "fee_payers": 2,
                    "warm_groups": 1, "sampled_groups": 1, "trace_units": 1,
                    "trace_group": 1}})


def test_cell_end_to_end_on_the_cpu():
    """The cell at depth 40 with its prefix cut to 2^5: the line is
    correct and reports the cell's end-to-end metrics; the pool holds
    updates and no transaction repeats a slot."""
    cfg = harness.resolve(harness.manifest(), CELL)[2]
    assert (cfg["depth"], cfg["capacity_log2"], cfg["sparse"],
            cfg["leaf"]) == (DEPTH, 22, True, "public_data")
    line = _cell()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"inserts_per_s", "setup_s"}
    assert set(line["checks"]) == {"outcomes_wrong", "roots_wrong",
                                   "roots_differing_across_trees",
                                   "leaves_wrong"}
    upsert = harness.load_module(harness.BENCH_DIR + "/drivers/upsert.py")
    tr = harness.resolve(harness.manifest(), CELL)[3]
    slots, _ = upsert.write_pool(SEED, 40, dict(tr, block_size=64))
    assert (ref.outcomes(slots) == ref.UPDATED).mean() > 0.3
    txs = nref.keys(slots).reshape(-1, 64)
    assert all(len(set(t)) == 64 for t in txs)


_UPSERT = public_data._upsert


def _first_write_wins(leaf_values, keys, values, sort, prev_slot, ok,
                      slab_start, k):
    """``_upsert`` with the first write of each slot's group winning."""
    _, _, accepted, pos_new = sort
    nonzero = ~field.is_zero(keys)
    first = nonzero & (ok | accepted[(pos_new - 1).clamp(min=0)])
    leader = torch.where(ok, slab_start + torch.arange(k), prev_slot)
    out = _UPSERT(leaf_values, keys, values, sort, prev_slot, ok, slab_start,
                  k)
    leaf_values[:, leader[first]] = values[:, first]
    return out


def _dropped_value(leaf_values, keys, values, sort, prev_slot, ok,
                   slab_start, k):
    """``_upsert`` whose updates leave their leader's value as it was."""
    before = leaf_values.clone()
    out = _UPSERT(leaf_values, keys, values, sort, prev_slot, ok, slab_start,
                  k)
    lead = prev_slot[out == public_data.UPDATED]
    leaf_values[:, lead] = before[:, lead]
    return out


def _previous_root(monkeypatch):
    """Each root read answers with the root the previous read gave."""
    real, seen = PublicDataTree.get_root_int, {}

    def get_root_int(self):
        root, prev = real(self), seen.get(id(self))
        seen[id(self)] = root
        return root if prev is None else prev
    monkeypatch.setattr(PublicDataTree, "get_root_int", get_root_int)


@pytest.mark.parametrize("fault", ["first_write_wins", "dropped_value",
                                   "previous_root"])
def test_planted_faults_are_not_correct(fault, monkeypatch):
    """Each planted fault fails the cell: the first write of a slot
    winning, an update's value dropped, and each root read a group late
    (``imtbench/control.py`` patches the nullifier tree's methods only)."""
    if fault == "previous_root":
        _previous_root(monkeypatch)
    else:
        monkeypatch.setattr(public_data, "_upsert", {
            "first_write_wins": _first_write_wins,
            "dropped_value": _dropped_value}[fault])
    line = _cell()
    assert line["correct"] is False, (fault, line["checks"])


def _view(units: int, card: dict):
    return harness.TraceView(1.0, 0.5, {}, units, {}, card)


def test_upsert_readers_read_the_session():
    """The two readers over a profiled block at prefix 2^5: host ms of
    the ``upsert`` span a block, and 100 x updated / (updated + inserted);
    None without a card, and None over a nullifier tree's block."""
    slots, values = _stream()
    host_ms = harness.metric_reader("upsert_host_ms_per_block.pd40")
    pct = harness.metric_reader("updated_writes_pct.pd40")
    tree = _tree()
    with profile(activities=[ProfilerActivity.CPU]):
        tree.write_batches(_blocks(slots)[:1], _blocks(values)[:1])
        tree.get_root_int()
    sess = observability.snapshot()["session"]
    up = [sp for sp in sess["spans"] if sp["name"] == "upsert"]
    assert sess["profiled"] and len(up) == 1
    want_ms = 1e-6 * (up[0]["end_ns"] - up[0]["start_ns"])
    assert host_ms.read(_view(1, CARD)) == pytest.approx(want_ms, rel=1e-12)
    assert host_ms.read(_view(2, CARD)) == pytest.approx(want_ms / 2,
                                                         rel=1e-12)
    assert pct.read(_view(1, CARD)) == pytest.approx(100.0 * 3 / 7)
    assert host_ms.read(_view(1, {})) is None and pct.read(_view(1, {})) \
        is None
    observability.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        IndexedMerkleTree(4, device=CPU).insert_batches([[5, 9, 5, 0]])
    assert host_ms.read(_view(1, CARD)) is None
    assert pct.read(_view(1, CARD)) is None


@pytest.mark.cuda
def test_public_data_tree_on_cuda_equals_cpu(monkeypatch):
    """Depth 40 at a 2^10 prefix: four blocks of 256 writes (updates
    across and within blocks, slot 0, value 0) through write_batches on
    the card and on the CPU's plain path: outcomes, every root, the four
    columns and every level bit for bit.  The card's leaf hash is three K1
    launches a block and no hash3; the fourth block grows the prefix to
    2^11, whose rehash of every leaf is three K1 launches more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.undo()
    gpu = PublicDataTree(DEPTH, initial_capacity_log2=10, device="cuda")
    cpu = PublicDataTree(DEPTH, initial_capacity_log2=10, device=CPU)
    rng = np.random.default_rng(40)
    keys = field.random_limbs(41, 4 * 256).reshape(16, 4, 256) \
        .transpose(1, 0, 2).copy()
    vals = field.random_limbs(42, 4 * 256).reshape(16, 4, 256) \
        .transpose(1, 0, 2).copy()
    for b in range(1, 4):                  # rewrites of earlier blocks
        pick = rng.choice(256 * b, size=100, replace=False)
        keys[b][:, :100] = keys[:b].transpose(1, 0, 2).reshape(16, -1)[:,
                                                                      pick]
    keys[2][:, 200:210] = keys[2][:, 190:200]    # repeats within a block
    keys[3][:, 7] = 0
    vals[1][:, 3] = 0
    start = {n: observability.total("cuda." + n)
             for n in ("permute_n", "hash3_leaf")}
    for b in range(4):
        og = gpu.write_batches(keys[b][None], vals[b][None])
        assert np.array_equal(og, cpu.write_batches(keys[b][None],
                                                    vals[b][None]))
        assert gpu.get_root_int() == cpu.get_root_int()
    assert gpu.active_depth == cpu.active_depth == 11
    assert observability.total("cuda.permute_n") - start["permute_n"] == 15
    assert observability.total("cuda.hash3_leaf") == start["hash3_leaf"]
    assert (og == 2).any() and (og == 0).any()
    for g, c in zip(gpu.levels + list(gpu._columns()),
                    cpu.levels + list(cpu._columns())):
        assert torch.equal(g.cpu(), c)
