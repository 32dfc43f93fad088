"""imt_tpu_torch's tracer (``utils/observability.py``) on the CPU.

Off by default: no profiler range opened, nothing recorded, the counters'
totals still kept.  Under a CPU ``torch.profiler``: the ``imt.*`` ranges
nest as the layers do (``walk`` inside ``insert_batch``, the walk's hash2
launches inside ``walk``), every span of a call shares its id, and one
profiled stretch is one session, a new one each stretch.  ``enable()``,
``snapshot()`` and ``reset()``.  Trees of depth 3, with the Poseidon
implementations replaced by stand-ins that return zeros of the right shape
(``_torch_lanes``): a span's place and a launch's width do not depend on a
hash's value, and the profiler records the plain hash's thousands of
operations a launch slowly.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import hashing
from imt_tpu_torch.utils import observability
from _torch_inference import inference_mode  # noqa: F401
import _torch_lanes

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    _torch_lanes.shape_only(monkeypatch)
    observability.disable()
    observability.reset()
    yield
    observability.disable()
    observability.reset()


def _session() -> dict:
    return observability.snapshot()["session"]


def _names(session) -> list:
    return [s["name"] for s in session["spans"]]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_off_records_nothing_and_counts_totals(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range was opened: {name}")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    tree = IndexedMerkleTree(2, device=CPU)
    a = torch.zeros((8, 3), dtype=torch.int32)
    with observability.span("outside"):
        hashing.hash2_nodes(a, a)
    assert tree.get_root_int() == tree.get_root_int()
    snap = observability.snapshot()
    assert snap["session"] is None
    assert snap["totals"]["hash2.launches"] == 1
    assert snap["totals"]["hash2.lanes"] == 3
    assert observability.span("x") is observability.span("y")


def test_profiled_witness_batch_nests_and_shares_one_call(monkeypatch):
    """The walk's hash2 launches run with ``walk`` the innermost open
    span; ``walk`` and every other span of the call sit inside the
    ``insert_batch`` span and carry its call id."""
    inner = []

    class Seen(_torch_lanes._Shapes):
        @staticmethod
        def hash2_nodes(a, b):
            s, i = observability._open[-1]
            inner.append(s.spans[i][0])
            return torch.zeros_like(a)
    monkeypatch.setattr(hashing, "_impl", lambda x: Seen)
    tree = IndexedMerkleTree(3, device=CPU)
    w, prof = _profiled(lambda: tree.insert_batch([5, 9], witness=True))
    assert w.ok.tolist() == [True, True]
    assert inner == ["walk"] * 3
    sess = _session()
    assert sess["profiled"] and sess["dropped"] == 0
    spans = sess["spans"]
    assert _names(sess) == ["insert_batch", "stage", "sort", "temporal",
                            "link", "leaf_hash", "walk", "finish", "wait"]
    assert {s["call"] for s in spans} == {spans[0]["call"]}
    assert spans[0]["parent"] is None
    assert all(s["parent"] == 0 for s in spans[1:])
    top = spans[0]
    for s in spans[1:]:
        assert top["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= top["end_ns"]
    assert sess["counts"] == {"hash3.launches": 1, "hash3.lanes": 4,
                              "hash2.launches": 3, "hash2.lanes": 12,
                              "walk.eager": 1, "plan.rank_scans": 2,
                              "plan.rank_queries": 4,
                              "nodes_to_limbs.launches": 1,
                              "nodes_to_limbs.lanes": 16,
                              "inserts.accepted": 2, "inserts.rejected": 0}
    ranges = {e.name: e for e in prof.events() if e.name.startswith("imt.")}
    assert set(ranges) == {"imt." + n for n in _names(sess)}
    outer, walk = ranges["imt.insert_batch"], ranges["imt.walk"]
    assert outer.time_range.start <= walk.time_range.start \
        <= walk.time_range.end <= outer.time_range.end


def test_one_session_a_profiled_stretch():
    """Two profiled stretches with a call between them out of the
    profiler: two sessions, each with its own stretch's calls only; the
    call between them is recorded nowhere."""
    tree = IndexedMerkleTree(3, device=CPU)
    _profiled(lambda: tree.insert_batches([[11, 12]]))
    first = _session()
    assert first["profiled"]
    assert [n for n in _names(first) if n in ("insert_batches", "paths",
                                              "rebuild")] == \
        ["insert_batches", "paths", "rebuild"]
    tree.get_root_int()
    assert _session() == first
    _profiled(tree.get_root_int)
    second = _session()
    assert second["profiled"] and _names(second) == ["get_root", "wait"]
    assert second["counts"] == {"nodes_to_limbs.launches": 1,
                                "nodes_to_limbs.lanes": 1}
    assert second["spans"][0]["call"] != first["spans"][0]["call"]


def test_planner_counts_its_rank_scans():
    """One count scan a plain block (the link), two a witness batch (the
    temporal planning and the link), each looking up the block's K new
    entries."""
    tree = IndexedMerkleTree(4, device=CPU)
    observability.enable()
    tree.insert_batches([[11, 12, 13], [14, 15, 16]])
    assert _session()["counts"]["plan.rank_scans"] == 2
    assert _session()["counts"]["plan.rank_queries"] == 2 * 3
    observability.enable()
    tree.insert_batch([21, 22], witness=True)
    assert _session()["counts"]["plan.rank_scans"] == 2
    assert _session()["counts"]["plan.rank_queries"] == 2 * 2
    assert observability.total("plan.rank_scans") == 4


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_root_read_counts_one_decode_after_the_spine(monkeypatch, sparse):
    """get_root adds one nodes_to_limbs launch of one lane to the totals,
    on a sparse tree after the hash2 launches of its spine (one a level
    above the prefix), and nothing else."""
    calls = []

    class Seen(_torch_lanes._Shapes):
        @staticmethod
        def hash2_nodes(a, b):
            calls.append("hash2")
            return torch.zeros_like(a)

        @staticmethod
        def nodes_to_limbs(x):
            calls.append("nodes_to_limbs")
            return _torch_lanes._Shapes.nodes_to_limbs(x)
    tree = SparseIndexedMerkleTree(8, initial_capacity_log2=3, device=CPU) \
        if sparse else IndexedMerkleTree(3, device=CPU)
    monkeypatch.setattr(hashing, "_impl", lambda x: Seen)
    before = dict(observability.snapshot()["totals"])
    assert tree.get_root().shape == (16, 1)
    added = {n: v - before.get(n, 0)
             for n, v in observability.snapshot()["totals"].items()
             if v != before.get(n, 0)}
    spine = 5 if sparse else 0
    assert calls == ["hash2"] * spine + ["nodes_to_limbs"]
    want = {"nodes_to_limbs.launches": 1, "nodes_to_limbs.lanes": 1}
    if sparse:
        want.update({"hash2.launches": 5, "hash2.lanes": 5,
                     "spine.launches": 5, "spine.lanes": 5})
    assert added == want


@pytest.mark.parametrize("name, arity, want", [
    ("hash2", 2, {"limbs_to_nodes": 2, "hash2": 1, "nodes_to_limbs": 1}),
    ("hash3", 3, {"hash3": 1, "nodes_to_limbs": 1}),
    ("hash_fixed", 5, {"perm": 3})])
def test_limb_hashes_count_their_conversions(name, arity, want):
    """A hash of canonical limbs counts the node conversions it dispatches
    around its kernels, each launch at the call's width; the sponge of
    other arities counts its permutations alone (on the card its
    conversions are counted where they launch)."""
    cols = [torch.zeros((16, 3), dtype=torch.int32)] * arity
    before = dict(observability.snapshot()["totals"])
    getattr(hashing, name)(*(cols if name != "hash_fixed" else [cols]))
    added = {n: v - before.get(n, 0)
             for n, v in observability.snapshot()["totals"].items()
             if v != before.get(n, 0)}
    assert added == {f"{kind}.{what}": n * (3 if what == "lanes" else 1)
                     for kind, n in want.items()
                     for what in ("launches", "lanes")}


def test_enable_snapshot_reset():
    """enable() records without the profiler; a profiled stretch while
    enabled is a session of its own, and the spans after it start another;
    disable() stops recording; reset() zeroes the totals."""
    tree = IndexedMerkleTree(2, device=CPU)
    observability.enable()
    tree.get_root_int()
    observability.count("queries", 3)
    sess = _session()
    assert not sess["profiled"] and _names(sess) == ["get_root", "wait"]
    assert sess["spans"][1]["parent"] == 0
    assert sess["counts"] == {"nodes_to_limbs.launches": 1,
                              "nodes_to_limbs.lanes": 1, "queries": 3}
    _profiled(tree.get_root_int)
    assert _session()["profiled"] and _names(_session()) == ["get_root",
                                                             "wait"]
    tree.get_root_int()
    after = _session()
    assert not after["profiled"] and _names(after) == ["get_root", "wait"]
    observability.disable()
    tree.get_root_int()
    assert _session() == after
    assert observability.total("queries") == 3
    observability.reset()
    assert observability.snapshot() == {"totals": {}, "session": None}


def test_held_counts_are_recorded_nowhere():
    """Counts made inside held_counts go to its dict alone (a CUDA graph's
    capture keeps them there, and each replay adds them)."""
    observability.enable()
    observability.count("queries", 2)
    with observability.held_counts() as held:
        observability.count("hash2.launches")
        observability.count("hash2.lanes", 8)
        observability.count("hash2.launches")
    assert held == {"hash2.launches": 2, "hash2.lanes": 8}
    assert _session()["counts"] == {"queries": 2}
    assert observability.snapshot()["totals"] == {"queries": 2}
    for name, n in held.items():
        observability.count(name, n)
    assert observability.total("hash2.lanes") == 8


def test_trace_is_a_span():
    observability.enable()
    with observability.trace("unit"):
        pass
    assert _names(_session()) == ["unit"]
