"""The per-layer readers of the program's spans and counters, on sessions
recorded on the CPU.

For each cell, a profiled stretch like the driver's traced units: one
``insert_batch(witness=True)`` block (prove), or one ``insert_batches``
group of two blocks and its ``get_root_int`` (sync), into a depth-4 tree.
Each reader gets a ``harness.TraceView`` with a stub card and must return
the figure computed here from the session's spans and counters; with no
card, or with no session, it returns None.  The Poseidon implementations
are stand-ins that return zeros of the right shape: where a span opens and
how wide a launch is do not depend on a hash's value.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imt_tpu_torch import IndexedMerkleTree
from imt_tpu_torch.ops import field, hashing
from imt_tpu_torch.utils import observability
from imtbench import harness

CARD = {"sm_count": 132, "clock_mhz": 1980.0, "power_limit": "700.00 W"}
PLAN = {"sort", "link", "temporal", "leaf_hash"}
LAUNCHES = ("hash2.launches", "hash3.launches", "perm.launches")
LANES = ("hash2.lanes", "hash3.lanes", "perm.lanes")
READERS = [m["name"] for m in harness.manifest()["per_layer"]
           if m["source"] in ("program_span", "program_counter")]


class _Zeros:
    @staticmethod
    def hash2_nodes(a, b):
        return torch.zeros_like(a)

    @staticmethod
    def hash3_leaf(a, b, c):
        return a.new_zeros((field.WORDS, a.shape[1]))

    @staticmethod
    def nodes_to_limbs(x):
        return x.new_zeros((field.LIMBS, x.shape[1]))


def _record(cell: str):
    """Profile one traced unit of `cell`'s calls; (session, blocks)."""
    tree = IndexedMerkleTree(4, device="cpu")
    rng = np.random.default_rng(5)
    vals = [int(v) for v in rng.choice(1 << 40, size=8, replace=False) + 1]
    with torch.inference_mode(), \
            profile(activities=[ProfilerActivity.CPU]):
        if cell == "prove":
            tree.insert_batch(vals[:4], witness=True)
            blocks = 1
        else:
            tree.insert_batches([vals[:4], vals[4:]])
            tree.get_root_int()
            blocks = 2
    return observability.snapshot()["session"], blocks


def _host_ms(session, names) -> float:
    spans = session["spans"]
    got = [s for s in spans if s["name"] in names]
    assert got
    for s in got:                      # the program does not nest them
        p = s["parent"]
        while p is not None:
            assert spans[p]["name"] not in names
            p = spans[p]["parent"]
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in got)


def _expected(quantity: str, session, blocks: int) -> float:
    c = session["counts"]
    launches = sum(c.get(n, 0) for n in LAUNCHES)
    spans = {"plan_host_ms_per_block": PLAN,
             "walk_host_ms_per_block": {"walk", "finish"},
             "paths_host_ms_per_block": {"paths", "rebuild"},
             "device_wait_ms_per_block": {"wait"}}
    if quantity in spans:
        return _host_ms(session, spans[quantity]) / blocks
    if quantity == "hash_launches_per_block":
        return launches / blocks
    assert quantity == "hash_lanes_per_launch"
    return sum(c.get(n, 0) for n in LANES) / launches


def _view(blocks: int, card: dict):
    return harness.TraceView(1.0, 0.5, {}, blocks, {}, card)


def test_every_program_metric_has_a_case():
    assert len(READERS) == 10
    assert {m.split(".")[1] for m in READERS} == {"prove", "sync"}


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_the_session(metric, monkeypatch):
    monkeypatch.setattr(hashing, "_impl", lambda x: _Zeros)
    observability.reset()
    quantity, cell = metric.split(".")
    session, blocks = _record(cell)
    assert session["profiled"]
    reader = harness.metric_reader(metric)
    got = reader.read(_view(blocks, CARD))
    assert got is not None and got > 0
    assert got == pytest.approx(_expected(quantity, session, blocks),
                                rel=1e-12)
    assert reader.read(_view(blocks, {})) is None
    observability.reset()
    assert reader.read(_view(blocks, CARD)) is None
