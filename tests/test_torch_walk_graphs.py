"""The witness walk's CUDA graphs (``tree/batch_witness.py`` ``WalkGraphs``)
on the CPU: what engages them and what they count.

A CPU walk always runs op by op and counts ``walk.eager`` once a call.  A
graph's key changes with K and with any level tensor replaced (a sparse
tree's growth, ``insert_batches``' rebuilt levels), and stays put across
witness batches, which change only s0 and the per-call tensors.  The
cache's order (eager, capture, replay; at most ``_MAX_GRAPHS`` graphs,
least recently used first out) runs with a stand-in for the recorded
graph, which replays by running the walk.  The recorded graphs themselves
need the card: ``tests/test_torch_cuda.py``.  The benchmark's reader of
the replayed share (``imtbench/metrics/walk_graph_replay_pct.py``) reads
those counts from a profiled session.  Poseidon is stubbed to zeros of the
right shape (``_torch_lanes``): no count or key depends on a hash's value.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.tree import batch_witness, indexed
from imt_tpu_torch.utils import observability
from imtbench import harness
from _torch_inference import inference_mode  # noqa: F401
import _torch_lanes

torch.set_num_threads(1)

CPU = "cpu"
WALK = ("walk.eager", "walk.graph_captures", "walk.graph_replays")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    _torch_lanes.shape_only(monkeypatch)
    observability.reset()
    yield
    observability.reset()


def _walk_counts() -> dict:
    return {name: observability.total(name) for name in WALK}


def test_cpu_walk_counts_eager_once_a_call():
    tree = IndexedMerkleTree(4, device=CPU)
    for i, vals in enumerate(([5, 9], [7, 3], [11, 2])):
        tree.insert_batch(vals, witness=True)
        assert _walk_counts() == {"walk.eager": i + 1,
                                  "walk.graph_captures": 0,
                                  "walk.graph_replays": 0}
    assert observability.total("hash2.launches") == 3 * 4   # one a level
    tree.insert_batch([13, 14])                  # no witness: no walk
    assert observability.total("walk.eager") == 3


def test_key_follows_k_and_the_level_tensors():
    tree = IndexedMerkleTree(4, device=CPU)
    key = batch_witness.WalkGraphs.key
    k2 = key(tree.levels, 2)
    for vals in ([5, 9], [7, 3]):                # s0 and the inputs move
        tree.insert_batch(vals, witness=True)
        assert key(tree.levels, 2) == k2
    assert key(tree.levels, 3) != k2
    # insert_batches rebuilds the levels above the crossover as new tensors
    assert indexed._crossover(tree.active_depth, 2) < tree.active_depth
    tree.insert_batches([[11, 12]])
    assert key(tree.levels, 2) != k2
    k2 = key(tree.levels, 2)
    tree.levels[1] = tree.levels[1].clone()
    assert key(tree.levels, 2) != k2


def test_key_changes_when_a_sparse_tree_grows():
    tree = SparseIndexedMerkleTree(8, initial_capacity_log2=2, device=CPU)
    key = batch_witness.WalkGraphs.key
    tree.insert_batch([5], witness=True)         # into slot 1 of 0..3
    k1 = key(tree.levels, 1)
    for v in (6, 8):                             # slots 2 and 3
        tree.insert_batch([v], witness=True)
        assert key(tree.levels, 1) == k1
    tree.insert_batch([7], witness=True)         # slot 4: the prefix grows
    assert tree.active_depth == 3 and key(tree.levels, 1) != k1


class _Stand:
    """The recorded graph's stand-in: keeps its levels and replays by
    running the walk on them."""

    made: list = []

    def __init__(self, levels, inputs):
        self.levels = levels
        _Stand.made.append(len(inputs[1]))
        observability.count("walk.graph_captures")

    def replay(self, inputs):
        observability.count("walk.graph_replays")
        return batch_witness._witness_walk(self.levels, *inputs)


def _walker(monkeypatch):
    """walk(k, s0): a witness walk of K = k from slot s0 through one
    WalkGraphs on a depth-5 CPU tree, with ``_Stand`` for the graph."""
    monkeypatch.setattr(batch_witness, "_Graph", _Stand)
    _Stand.made = []
    tree = IndexedMerkleTree(5, device=CPU)
    graphs = batch_witness.WalkGraphs()

    def walk(k, s0):
        slots = s0 + torch.arange(k)
        upd = torch.zeros((8, 2 * k), dtype=torch.int32)
        return graphs.walk(tree.levels, slots, slots, slots[0], upd)
    return walk, graphs


def test_eager_then_capture_then_replay(monkeypatch):
    """The first call with a key runs eagerly, the second captures and
    replays, later ones replay; the least recently used of more than
    _MAX_GRAPHS graphs is dropped, and runs eagerly when it comes back."""
    walk, graphs = _walker(monkeypatch)

    for i in range(3):
        walk(2, 1 + 2 * i)
    assert _walk_counts() == {"walk.eager": 1, "walk.graph_captures": 1,
                              "walk.graph_replays": 2}
    for k in (1, 3, 4, 5):                      # four more keys, captured
        walk(k, 1)
        walk(k, 1)
    assert _Stand.made == [2, 1, 3, 4, 5]
    assert len(graphs._graphs) == batch_witness._MAX_GRAPHS
    walk(2, 7)                                   # K = 2's graph was dropped
    assert _walk_counts() == {"walk.eager": 6, "walk.graph_captures": 5,
                              "walk.graph_replays": 6}
    walk(5, 1)                                   # still kept: a replay
    assert observability.total("walk.graph_replays") == 7


def test_the_card_path_is_chosen_by_device_and_access(monkeypatch):
    """``witness_walk`` hands a walk to the tree's graphs only on the card
    and without `access`: a CPU walk given graphs runs op by op."""
    called = []
    monkeypatch.setattr(batch_witness.WalkGraphs, "walk",
                        lambda self, *a: called.append(a))
    tree = IndexedMerkleTree(3, device=CPU)
    slots = torch.tensor([1, 2])
    batch_witness.witness_walk(tree.levels, slots, slots, slots[0],
                               torch.zeros((8, 4), dtype=torch.int32),
                               graphs=batch_witness.WalkGraphs())
    assert not called and observability.total("walk.eager") == 1


def test_replay_share_reader(monkeypatch):
    """``walk_graph_replay_pct``: 100 x replays / (replays + eager walks)
    over the profiled session; None without a card, without a session, or
    where no walk ran (a parent without these counters)."""
    walk, _ = _walker(monkeypatch)
    reader = harness.metric_reader("walk_graph_replay_pct.prove")
    view = lambda card: harness.TraceView(1.0, 0.5, {}, 4, {}, card)
    card = {"sm_count": 132}
    with profile(activities=[ProfilerActivity.CPU]):
        for s0 in (1, 3, 5, 7):                 # eager, capture, 2 replays
            walk(2, s0)
    assert reader.read(view(card)) == pytest.approx(100 * 3 / 4)
    assert reader.read(view({})) is None
    observability.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        observability.count("queries", 1)
    assert reader.read(view(card)) is None
    observability.reset()
    assert reader.read(view(card)) is None
