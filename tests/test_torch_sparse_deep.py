"""SparseIndexedMerkleTree at depth 40 (Aztec's later nullifier-tree height,
the benchmark's ``nullifier-d40-2p22``) on the CPU, held to the benchmark's
plain reference (``imtbench/reference/tree.py``), which imports nothing of
the program, and block by block to ``imt_tpu``'s SparseIndexedMerkleTree.

Values are ``imtbench.values.field_values`` from a seed, with a duplicate
and a zero planted.  Held: the masks and roots of ``insert_batches`` block
by block at an active prefix of 2^5; the same tree grown past its prefix;
every value and helper field of ``insert_batch(witness=True)`` and the
four insert_leaf folds; the tracer's ``spine`` span and counters (35
launches a root at prefix 2^5, nothing on a dense tree) and ``grow``; the
sync cell end to end through ``imtbench.run.run_cell`` at a 2^5 prefix,
with the check's control and planted faults; the two readers of the
spine.

Hashes are python ints on both sides.  The port's Poseidon dispatch
(``ops/hashing.py``) is pointed at its python-int oracle
(``ops/poseidon_ref.hash_fixed``, which the plain and the CUDA paths are
held to bit for bit elsewhere), and the reference's ``Hasher`` hashes each
lane with its own spec form (``reference/poseidon.hash_int``): the plain
torch paths cost ~0.3 s a launch whatever the width, and a depth-40 root
at prefix 2^5 is 35 launches.  The card test
``tests/test_torch_cuda.py::test_depth40_sparse_tree_on_cuda_equals_cpu``
runs the kernels at this depth.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imt_tpu.tree.sparse import SparseIndexedMerkleTree as JaxSparseTree
from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import field, hashing
from imt_tpu_torch.ops.poseidon_ref import hash_fixed
from imt_tpu_torch.ops.poseidon_spec import default_params
from imt_tpu_torch.utils import observability
from imtbench import control, harness, run
from imtbench.reference import poseidon, tree as ref
from imtbench.values import field_values
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
DEPTH, PREFIX, K = 40, 5, 4
SEED = 2 ** 33 + 40
CELL = "d40-2p22.sync-2k"
CARD = {"sm_count": 132, "clock_mhz": 1980.0, "power_limit": "700.00 W"}
VALUE_FIELDS = ("low_leaf_val", "low_leaf_next_val", "low_leaf_next_idx",
                "new_leaf_val", "new_leaf_next_val", "new_leaf_next_idx",
                "new_leaf_index", "is_new_leaf_largest")


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
    def hash3_leaf(cls, a, b, c):
        p = default_params()
        cols = [field.limbs_to_ints(x.numpy()) for x in (a, b, c)]
        return cls._nodes([hash_fixed(list(v), p) for v in zip(*cols)])

    @classmethod
    def nodes_to_limbs(cls, x):
        return torch.as_tensor(field.ints_to_limbs(cls._ints(x)))

    @classmethod
    def limbs_to_nodes(cls, x):
        return cls._nodes(field.limbs_to_ints(x.numpy()))


class _IntHasher(poseidon.Hasher):
    """The reference's ``Hasher`` with each lane hashed by its spec form,
    ``hash_int``: the same Montgomery limbs in and out."""

    def _sponge(self, words):
        cols = [self.to_ints(w) for w in words]
        out = [poseidon.hash_int(list(v)) for v in zip(*cols)]
        return torch.tensor(
            [poseidon.int_limbs(v * self.r % self.p) for v in out],
            dtype=torch.int64, device=self.device).reshape(-1, poseidon.N).T


H = _IntHasher(torch.device(CPU))


@pytest.fixture(autouse=True)
def int_poseidon(monkeypatch):
    monkeypatch.setattr(hashing, "_impl", lambda x: _IntPoseidon)
    observability.disable()
    observability.reset()
    yield
    observability.disable()
    observability.reset()


def _stream(n: int = 3 * K) -> np.ndarray:
    """int64 [16, n] seeded field values: value 6 repeats value 1 (a
    duplicate across blocks), value 3 repeats value 2 (within a block),
    value 9 is zero."""
    s = field_values(SEED, n).astype(np.int64)
    s[:, 6], s[:, 3], s[:, 9] = s[:, 1], s[:, 2], 0
    return s


def _blocks(s: np.ndarray) -> np.ndarray:
    """[16, B * K] -> B blocks [B, 16, K], in stream order."""
    return np.ascontiguousarray(s.reshape(16, -1, K).transpose(1, 0, 2))


def _tree(prefix: int = PREFIX):
    return SparseIndexedMerkleTree(DEPTH, initial_capacity_log2=prefix,
                                   device=CPU)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def test_blocks_equal_the_reference():
    """(a) Three blocks of 4 through insert_batches at prefix 2^5: every
    mask is the set semantics', every root the reference's depth-40
    root."""
    s = _stream()
    want = ref.accepted(s).reshape(3, K)
    assert not want.all()                       # the plants are rejected
    tree = _tree()
    for b, block in enumerate(_blocks(s)):
        ok = tree.insert_batches(block[None])
        assert np.array_equal(ok[0], want[b]), b
        assert tree.get_root_int() == ref.tree_root(
            H, s[:, :K * (b + 1)], DEPTH), b
    assert tree.active_depth == PREFIX and tree.tree_depth == DEPTH


def test_blocks_equal_the_jax_tree():
    """(a) The same three blocks through ``imt_tpu``'s
    SparseIndexedMerkleTree(40, initial_capacity_log2=5): masks and roots
    equal the port's block by block.  One chained program and one root
    fold compile on the CPU, ~20 s, once for the module."""
    blocks = _blocks(_stream())
    port = _tree()
    jax_tree = JaxSparseTree(DEPTH, initial_capacity_log2=PREFIX)
    for b, block in enumerate(blocks):
        ok = port.insert_batches(block[None])
        assert np.array_equal(
            ok, jax_tree.insert_batches(block[None].astype(np.uint32))), b
        assert port.get_root_int() == jax_tree.get_root_int(), b
    assert jax_tree.active_depth == port.active_depth == PREFIX


def test_growth_past_the_prefix_keeps_the_roots():
    """(b) The tree of (a) given a block of 20 more values grows its
    prefix to 2^6 (one ``sparse.grows``, its ``grow`` span inside the
    call); its root is still the reference's.  A tree that starts at 2^2
    grows twice over (a)'s blocks and gives (a)'s roots."""
    s = _stream(3 * K + 20)
    tree = _tree()
    tree.insert_batches(_blocks(s[:, :3 * K]))
    observability.enable()
    ok = tree.insert_batches(s[None, :, 3 * K:])
    assert np.array_equal(ok[0], ref.accepted(s)[3 * K:])
    assert tree.active_depth == PREFIX + 1
    sess = observability.snapshot()["session"]
    assert sess["counts"]["sparse.grows"] == 1
    names = [sp["name"] for sp in sess["spans"]]
    grow = sess["spans"][names.index("grow")]
    assert sess["spans"][grow["parent"]]["name"] == "insert_batches"
    assert tree.get_root_int() == ref.tree_root(H, s, DEPTH)

    small, roots = _tree(2), []
    for b, block in enumerate(_blocks(s[:, :3 * K])):
        small.insert_batches(block[None])
        roots.append(small.get_root_int())
    assert small.active_depth == 4
    assert observability.total("sparse.grows") == 1 + 2
    assert roots == [ref.tree_root(H, s[:, :K * (b + 1)], DEPTH)
                     for b in range(3)]


def test_witness_batch_at_depth_40():
    """(c) insert_batch(witness=True) after a first block: the proofs are
    40 deep; every value and index field and both helper rows equal the
    sequential semantics on the accepted lanes, ok equals it on all, and
    the four insert_leaf folds of every accepted lane hold against the
    witness's roots."""
    s = _stream()
    pre, block = s[:, :K], s[:, K:2 * K]
    tree = _tree()
    tree.insert_batches(pre[None])
    w = {k: _np(v) for k, v in vars(tree.insert_batch(block,
                                                       witness=True)).items()}
    e = ref.insert_expect(pre, block)
    m = e["ok"]
    assert np.array_equal(w["ok"].astype(bool), m) and not m.all()
    assert w["low_leaf_proof"].shape == (DEPTH, field.LIMBS, K)
    for name in VALUE_FIELDS:
        assert np.array_equal(w[name][..., m], _np(e[name])[..., m]), name
    for name, slots in (("low_leaf_proof_helper", e["low_slot"]),
                        ("new_leaf_proof_helper", e["new_leaf_index"])):
        assert np.array_equal(w[name][:, m],
                              ref.helper_bits(slots, DEPTH)[:, m]), name
    assert (w["low_leaf_proof_helper"][PREFIX:] == 1).all()
    roots = ref.insert_leaf_roots(H, w)
    assert (roots["old"][:, m] == w["old_root"][:, m]).all()
    assert (roots["interim"][:, m] == roots["slot"][:, m]).all()
    assert (roots["new"][:, m] == w["new_root"][:, m]).all()
    last = np.flatnonzero(m)[-1]
    assert poseidon.limbs16_to_ints(w["new_root"][:, last:last + 1]) == [
        ref.tree_root(H, s[:, :2 * K], DEPTH)]


def test_spine_counts_and_spans():
    """(d) A root read at prefix 2^5 folds 35 levels: one ``spine`` span
    inside ``get_root``, ``spine.launches`` 35 and ``spine.lanes`` 35,
    each launch a hash2 too.  A dense tree's calls record no ``spine``
    span and no ``spine.*`` or ``sparse.*`` count."""
    tree = _tree()
    tree.insert_batches(_blocks(_stream())[:1])
    observability.enable()
    tree.get_root_int()
    sess = observability.snapshot()["session"]
    spans = sess["spans"]
    assert [sp["name"] for sp in spans] == ["get_root", "spine", "wait"]
    assert spans[1]["parent"] == 0
    c = sess["counts"]
    assert c["spine.launches"] == DEPTH - PREFIX == 35
    assert c["spine.lanes"] == 35 and c["hash2.launches"] == 35

    observability.reset()
    observability.enable()
    dense = IndexedMerkleTree(3, device=CPU)
    dense.insert_batches([[5, 9]])
    dense.insert_batch([7, 7], witness=True)
    dense.get_root_int()
    dense.non_inclusion_witness([8])
    sess = observability.snapshot()["session"]
    assert "spine" not in {sp["name"] for sp in sess["spans"]}
    assert not [n for n in observability.snapshot()["totals"]
                if n.startswith(("spine.", "sparse."))]


def _cell(seed=SEED):
    """The cell at a 2^5 prefix and blocks of 4; the traced group is
    moved into the tree, as the driver asks."""
    return run.run_cell(CELL, seed, 0.01, False, device=CPU, overrides={
        "config": {"capacity_log2": PREFIX},
        "traffic": {"block_size": K, "warm_groups": 1, "sampled_groups": 1,
                    "trace_units": 1, "trace_group": 1}})


def test_cell_end_to_end_on_the_cpu():
    """(e) The sync cell at depth 40 with its prefix cut to 2^5 and
    blocks of 4: the line is correct and reports the cell's end-to-end
    metrics."""
    cfg = harness.resolve(harness.manifest(), CELL)[2]
    assert (cfg["depth"], cfg["capacity_log2"], cfg["sparse"]) == \
        (DEPTH, 22, True)
    line = _cell()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"inserts_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("kind", control.KINDS)
def test_cell_control_and_faults_are_not_correct(kind):
    """(e) The check's control and planted faults fail the depth-40
    cell."""
    with control.patched(kind):
        line = _cell()
    assert line["correct"] is False, (kind, line["checks"])


def _view(units: int, card: dict):
    return harness.TraceView(1.0, 0.5, {}, units, {}, card)


def _profiled_block(tree, block):
    with profile(activities=[ProfilerActivity.CPU]):
        tree.insert_batches(block[None])
        tree.get_root_int()
    return observability.snapshot()["session"]


def test_spine_readers_read_the_session():
    """(f) The two readers over a profiled sync block at prefix 2^5: 35
    launches a block, and the host ms of the ``spine`` span; None without
    a card, and None over a dense tree's block."""
    blocks = _blocks(_stream())
    launches = harness.metric_reader("spine_launches_per_block.d40")
    host_ms = harness.metric_reader("spine_host_ms_per_block.d40")
    sess = _profiled_block(_tree(), blocks[0])
    assert sess["profiled"]
    spine = [sp for sp in sess["spans"] if sp["name"] == "spine"]
    assert len(spine) == 1
    want_ms = 1e-6 * (spine[0]["end_ns"] - spine[0]["start_ns"])
    assert launches.read(_view(1, CARD)) == 35.0
    assert host_ms.read(_view(1, CARD)) == pytest.approx(want_ms, rel=1e-12)
    assert host_ms.read(_view(2, CARD)) == pytest.approx(want_ms / 2,
                                                         rel=1e-12)
    assert launches.read(_view(1, {})) is None
    assert host_ms.read(_view(1, {})) is None
    observability.reset()
    _profiled_block(IndexedMerkleTree(4, device=CPU), blocks[0])
    assert launches.read(_view(1, CARD)) is None
    assert host_ms.read(_view(1, CARD)) is None
