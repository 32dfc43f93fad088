"""imt_tpu_torch's shard-local planner on two gloo ranks (CPU).

The counterpart of tests/test_local_plan.py.  One spawn of two ranks
(chip_smoke.py's ``start_ranks``: torch.multiprocessing's spawn, a
``file://`` store, a 120 s timeout: a rank that fails or hangs fails the
module) runs
tests/_torch_parallel_ranks.py's ``local_plan_ranks``: two witness batches
into a sparse depth-6 tree holding 2^4 slots (8 per rank; the second
batch has an intra-batch duplicate, a zero and 50, a duplicate of a value
the first inserted, through the witness program), a plain batch whose
slots 15..18 grow the tree and straddle the new shard boundary (a value
>= p, a duplicate), a chain of three (a duplicate across batches, a zero,
a value >= p), then the byte audit at depths 3 and 5, clean and with a
full-state gather slipped into the insert program.  Meanwhile this process
runs the scenario on the port's single-device tree; the witness batches
are tests/test_torch_batch_witness.py's, which holds that tree's witness
batches against imt_tpu's.
Without a spawn: ``_rank_plan`` against imt_tpu's on seeded inputs,
the hash lanes of a chain over D ranks (each rank run in turn, shape-only)
against imt_tpu's ``hash_count``, and the masked scatter.  Tolerance:
exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

import test_torch_batch_witness as batch_witness
from imt_tpu.parallel import local_plan as jlocal_plan
from imt_tpu_torch.ops import field
from imt_tpu_torch.parallel import collective_audit, local_plan
from _torch_inference import inference_mode  # noqa: F401
import _torch_lanes

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
    ranks = chip_smoke.start_ranks(f"{RANKS_FILE}:local_plan_ranks", 2, {},
                                   work, TIMEOUT)
    try:
        ref = R.planner(R.SparseIndexedMerkleTree(R.W_FULL, R.W_CAP,
                                                  device=R.CPU))
    except BaseException:
        ranks.kill()
        raise
    return ranks.wait(), ref


def test_witness_inputs_are_the_imt_tpu_held_ones():
    """The witness batches are tests/test_torch_batch_witness.py's, which
    holds the port's single-device tree against imt_tpu's on them
    (test_witness_batch_matches_imt_tpu, every field of every lane;
    test_masks_state_and_root_match_imt_tpu): what the tests below hold
    the sharded program to is imt_tpu's result."""
    assert (R.W_FULL, R.W_CAP, R.W_B1, R.W_B2) == (
        batch_witness.FULL, batch_witness.ACTIVE, batch_witness.B1,
        batch_witness.B2)


def _equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("batch", [0, 1])
@pytest.mark.parametrize("name", R.INSERT_FIELDS)
def test_witness_batches_match_imt_tpu(run, batch, name):
    """Every lane, rejected ones included, of both witness batches: the
    sharded program's equal the port's single device's (imt_tpu's, as
    test_witness_inputs_are_the_imt_tpu_held_ones says) on both ranks."""
    ranks, ref = run
    key = f"w{batch}.{name}"
    assert _equal(ranks[0][key], ref[key]), key
    assert _equal(ranks[1][key], ref[key]), key


def test_duplicate_of_a_present_value_through_the_witness_program(run):
    """50, inserted by the first batch, is rejected by the second, as are
    its own duplicate and the zero."""
    ok = run[0][0]["w1.ok"]
    assert ok.tolist() == [False, False, True, False, True, True, True]


@pytest.mark.parametrize("key", ["w.vals", "w.next_vals", "w.next_idxs",
                                 "w.count", "w.root", "w.depth", "w.sparse"])
def test_state_after_the_witness_batches_matches_imt_tpu(run, key):
    ranks, ref = run
    for r in ranks:
        assert _equal(r[key], ref[key]), key


@pytest.mark.parametrize("key", ["l.ok", "l.ad", "l.root", "l.oks", "l.vals",
                                 "l.next_vals", "l.next_idxs", "l.count",
                                 "l.root"])
def test_growth_straddle_and_chain_match_single_device(run, key):
    """The batch that grows the prefix from 16 to 32 slots (8 -> 16 per
    rank) with slots 15..18 across the new boundary, then the chain of
    three: masks, active depth and state equal the single device's."""
    ranks, ref = run
    assert ref["l.ad"] == 5 and ref["l.ok"].tolist() == [True, True, True,
                                                          False]
    assert ref["l.oks"].tolist() == [[True, True], [False, False],
                                     [True, True]]
    for r in ranks:
        assert _equal(r[key], ref[key]), key


def test_insert_programs_move_the_expected_bytes(run):
    """The plain batch (K = 4) and the chain (3 x K = 2) moved exactly
    exchange_bytes over two ranks: the candidates, the dirty-leaf hashes,
    the subtree roots."""
    calls = run[0][0]["calls"]
    # candidates 2 x D x K x 72, hashes 2K x 32, roots D x 32
    assert sum(b for _, b in calls["insert_batch"]) == \
        local_plan.exchange_bytes(2, 4, 1) == 1152 + 256 + 64
    assert sum(b for _, b in calls["insert_batches"]) == \
        local_plan.exchange_bytes(2, 2, 3)
    assert not [c for c in calls if c not in (
        "insert_batch", "insert_batches", "insert_batch_witness", "growth",
        "gather_state", "build")], calls


def test_growth_moves_only_the_new_slices(run):
    """The doubling from 8 to 16 slots per rank, counted apart from the
    batches: rank 1's old slice goes to rank 0, whose new one it completes
    ([48, 8] int32), and rank 1, whose new slice no old one reaches,
    receives nothing.  No rank receives more than its new slice: O(N/D),
    not the state."""
    ranks = run[0]
    new_slice = 3 * field.LIMBS * 16 * 4
    assert ranks[0]["calls"]["growth"] == [("slices", new_slice // 2)]
    assert ranks[1]["calls"].get("growth", []) == []


def test_byte_audit_passes(run):
    """Every program makes as many calls at depth 5 as at depth 3; only
    the one psum of the sharded levels grows, by two levels of node
    columns (K for the queries, 2K for the witness batch)."""
    passed, summary, programs = run[0][0]["audit"]
    assert passed, summary
    assert [p[0] for p in programs] == list(collective_audit.PROGRAMS)
    counts = {name: (len(small), len(big)) for name, small, big in programs}
    assert counts == {"insert_batch": (3, 3), "insert_batches": (5, 5),
                      "non_inclusion_witness": (2, 2),
                      "insert_batch_witness": (2, 2)}
    k, node = 2, field.WORDS * 4
    grows = {"non_inclusion_witness": 2 * k * node,
             "insert_batch_witness": 2 * 2 * k * node}
    for name, small, big in programs:
        assert sum(b for _, b in big) - sum(b for _, b in small) == \
            grows.get(name, 0), name
        assert [c for c in small if c[0] == "candidates"] == \
            [c for c in big if c[0] == "candidates"], name


def test_byte_audit_fails_on_a_full_state_gather(run):
    failed, summary = run[0][0]["leaky"]
    assert failed == ["insert_batch"], summary
    assert "GROWS WITH N" in summary


# -- without a spawn ---------------------------------------------------------

def _rank_plan_inputs(seed: int, k: int = 16):
    """A consistent seeded planning problem: participants (slot 0 = 0 and
    distinct values), K queries with duplicates, zeros and present values;
    below1 / above1 by brute force; qpos the (value, index) rank."""
    rng = np.random.default_rng(seed)
    part = [0] + sorted({int(v) for v in rng.integers(1, 1 << 40, 12)})
    q = [int(v) for v in rng.integers(1, 1 << 40, k)]
    q[3], q[9], q[5], q[12] = q[1], 0, part[4], q[1]
    lo = [max(i for i, v in enumerate(part) if v <= x) for x in q]
    hi = [min([i for i, v in enumerate(part) if v > x], default=-1)
          for x in q]
    limbs = lambda vs: np.array([[(v >> (16 * i)) & 0xFFFF for v in vs]
                                 for i in range(16)], dtype=np.uint32)
    slots_of = rng.permutation(np.arange(1, 40))[:len(part)]
    slots_of[0] = 0
    qpos = np.empty(k, np.int32)
    qpos[np.lexsort((np.arange(k), np.array(q, dtype=np.uint64)))] = \
        np.arange(k) * 3 + 1
    return dict(
        new_vals=limbs(q), slots=(20 + np.arange(k)).astype(np.int32),
        qpos=qpos, blo_v=limbs([part[i] for i in lo]),
        blo_s=slots_of[lo].astype(np.int32), blo_f=np.ones(k, bool),
        bhi_v=limbs([part[i] if i >= 0 else 0 for i in hi]),
        bhi_s=np.where(np.array(hi) >= 0, slots_of[hi], 0).astype(np.int32),
        bhi_f=np.array(hi) >= 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_plan_matches_imt_tpu(seed):
    """The port's _rank_plan against imt_tpu's on the same seeded inputs
    (K = 16), on every field both return (imt_tpu's low_val is dropped)."""
    import jax.numpy as jnp
    x = _rank_plan_inputs(seed)
    want = jlocal_plan._rank_plan(*(jnp.asarray(v) for v in x.values()),
                                  k=16)
    port = lambda v: torch.as_tensor(v if v.dtype == bool else v.astype(
        np.int64 if v.ndim == 1 else np.int32))
    got = local_plan._rank_plan(*(port(v) for v in x.values()), k=16)
    assert set(got) == set(want) - {"low_val"}
    for name in got:
        a, b = np.asarray(want[name]), got[name].numpy()
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name
    assert not got["ok"].numpy()[[3, 9, 12]].any()     # dups and the zero


@pytest.mark.parametrize("depth,k,d,b", [
    (6, 4, 2, 1), (6, 4, 4, 3), (8, 16, 2, 2), (8, 3, 4, 1), (21, 65536, 4, 8),
    (24, 4096, 8, 1), (12, 256, 8, 4)])
def test_hash_count_matches_imt_tpu(depth, k, d, b, monkeypatch):
    """imt_tpu's hash_count counts the top rebuild above the D subtree
    roots (D - 1 hashes) once; every rank runs it, so the mesh dispatches
    (D - 1)^2 lanes more."""
    got = _torch_lanes.mesh_lanes(monkeypatch, depth, k, d, b)
    assert got == jlocal_plan.hash_count(depth, k, d, b) + (d - 1) ** 2


def test_put_kept_writes_only_kept_lanes():
    """The masked scatter: kept lanes land, dropped ones (out of range,
    negative, or not kept) change nothing, including when none is kept."""
    rng = np.random.default_rng(4)
    for none in (False, True):
        x = torch.as_tensor(rng.integers(0, 1000, (8, 10)), dtype=torch.int32)
        want = x.clone()
        idx = torch.tensor([3, -2, 12, 7, 0, 5])
        keep = torch.tensor([True, False, False, True, True, False]) & \
            (not none)
        val = torch.as_tensor(rng.integers(0, 1000, (8, 6)),
                              dtype=torch.int32)
        for i in range(6):
            if keep[i]:
                want[:, idx[i]] = val[:, i]
        local_plan._put_kept(x, idx, keep, val)
        assert torch.equal(x, want)
