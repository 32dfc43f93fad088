#!/usr/bin/env python3
"""Randomized differential soak of imt_tpu_torch's indexed trees, and the
kill-resume drill.

    python tools/soak_indexed_torch.py [--rounds 30] [--seed 0]
        [--device cuda|cpu] [--depth D]

The port of ``tools/soak_indexed.py``.  Each round drives a random workload
through a dense ``IndexedMerkleTree`` and a ``SparseIndexedMerkleTree`` of
the same depth (4, 5, 6 or 8, or `--depth`) on `--device` (the card unless
"cpu" is asked for) beside the python-int ``OracleIndexedTree``: insert
batches of 2-7 adversarial values (duplicates, neighbours of inserted
values, 0, 1, 2, p-1, p-2), sequential witnessed inserts whose witnesses
must pass ``insert_leaf``, and non-inclusion queries, with the acceptance
masks and both roots checked against the oracle after every step, then a
checkpoint round trip of the sparse tree.  It prints ``SOAK PASSED`` only
at its end; any failure raises and exits non-zero.

``kill_resume`` is the kill-resume drill (the port of
``tests/test_soak.py::test_soak_kill_resume``): a worker process, written
to a temporary directory, inserts a seeded stream batch by batch into a
sparse tree built by ``EngineConfig`` and checkpoints after each batch; it
is SIGKILLed after its third checkpoint, the last snapshot is loaded and
the remaining batches replayed, and the root and count must equal those of
a second worker that ran the same stream uninterrupted, alongside.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the drill: the worker is killed after this many checkpoints; its stream's
# seed (tests/test_soak.py's); how long a worker may take
KILL_AFTER, DRILL_SEED, DRILL_TIMEOUT_S = 3, 0x50AC, 600.0


def soak(rounds: int, seed: int, device: str,
         depth: int | None = None) -> None:
    """`rounds` rounds of the differential stream; raises AssertionError at
    the first disagreement."""
    from imt_tpu_torch.ops import field
    from imt_tpu_torch.tree.indexed import IndexedMerkleTree, insert_leaf
    from imt_tpu_torch.tree.reference_oracle import Leaf, OracleIndexedTree
    from imt_tpu_torch.tree.sparse import SparseIndexedMerkleTree
    from imt_tpu_torch.utils import checkpoint

    def oracle_from_engine(dense):
        """An oracle holding the engine's exact leaf state and slot cursor
        (after rejected inserts, which consume a slot that the oracle's
        replay would not)."""
        vals, nvs, nis = (field.limbs_to_ints(x.cpu().numpy()) for x in
                          (dense.vals, dense.next_vals, dense.next_idxs))
        o = OracleIndexedTree(dense.tree_depth)
        o.preimages = [Leaf(*t) for t in zip(vals, nvs, nis)]
        o.count = dense.count
        o._rebuild()
        return o

    rng = random.Random(seed)
    for rnd in range(rounds):
        d = depth or rng.choice([4, 5, 6, 8])
        dense = IndexedMerkleTree(d, device=device)
        sparse = SparseIndexedMerkleTree(d, initial_capacity_log2=2,
                                         device=device)
        oracle = OracleIndexedTree(d)
        inserted: list[int] = []
        budget = (1 << d) - 2

        def rand_val() -> int:
            mode = rng.random()
            if mode < 0.15 and inserted:          # exact duplicate
                return rng.choice(inserted)
            if mode < 0.3 and inserted:           # a neighbour, mod p: p-1
                # + 1 wraps to 0, the rejected sentinel, as the engine
                # reduces python ints mod p
                return max(1, rng.choice(inserted) + rng.choice([-1, 1])) \
                    % field.P
            if mode < 0.35:
                return rng.choice([1, 2, field.P - 1, field.P - 2])
            return rng.randrange(1, field.P)

        for _ in range(rng.randrange(2, 5)):
            # The engine rejects duplicate and zero inserts; the oracle
            # replays the reference planner, which has no rejection.  So
            # acceptance is computed here, and after a rejection (a slot
            # consumed) the oracle is re-seeded from the engine's state.
            kind = rng.random()
            if kind < 0.55 and budget >= 4:       # batched insert
                k = min(rng.choice([2, 3, 4, 7]), budget)
                vals = [rand_val() for _ in range(k)]
                expect, seen = [], set(inserted)
                for v in vals:
                    expect.append(v != 0 and v not in seen)
                    if expect[-1]:
                        seen.add(v)
                okd = dense.insert_batch(vals).tolist()
                oks = sparse.insert_batch(list(vals)).tolist()
                assert okd == oks == expect, (rnd, vals, okd, oks, expect)
                budget -= k
                if all(expect):
                    for v in vals:
                        assert oracle.insert(v)["ok"]
                    inserted += vals
                else:
                    oracle = oracle_from_engine(dense)
                    inserted = [v for v, a in zip(vals, expect) if a] + \
                        inserted
            elif kind < 0.8 and budget >= 1:      # witnessed sequential
                v = rand_val()
                dup = v == 0 or v in inserted
                wd, ws = dense.insert(v), sparse.insert(v)
                assert bool(wd.ok.all()) == bool(ws.ok.all()) == (not dup)
                if dup:
                    oracle = oracle_from_engine(dense)
                else:
                    assert oracle.insert(v)["ok"]
                    for w in (wd, ws):
                        ok = insert_leaf(
                            w.old_root, w.low_leaf_val, w.low_leaf_next_val,
                            w.low_leaf_next_idx, w.low_leaf_proof,
                            w.low_leaf_proof_helper, w.new_root,
                            w.new_leaf_val, w.new_leaf_next_val,
                            w.new_leaf_next_idx, w.new_leaf_index,
                            w.new_leaf_proof, w.new_leaf_proof_helper,
                            w.is_new_leaf_largest)
                        assert bool(ok.all()), (rnd, v)
                    inserted.append(v)
                budget -= 1
            else:                                 # non-inclusion queries
                qs = [rand_val() for _ in range(3)]
                w = dense.non_inclusion_witness(qs)
                expect = [q != 0 and q not in inserted for q in qs]
                assert w.ok.tolist() == expect, (rnd, qs, inserted)
            root = oracle.get_root()
            assert dense.get_root_int() == root, rnd
            assert sparse.get_root_int() == root, rnd

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "t.npz")
            checkpoint.save(sparse, path)
            back = checkpoint.load(path, device=device)
            assert back.get_root_int() == oracle.get_root(), rnd
            assert isinstance(back, SparseIndexedMerkleTree), rnd
        print(f"round {rnd}: depth={d} inserts={len(inserted)} OK",
              file=sys.stderr, flush=True)


# -- the kill-resume drill ----------------------------------------------------

WORKER = r"""
import json, os, random, sys
import torch
from imt_tpu_torch.ops import _build
from imt_tpu_torch.utils import checkpoint
from imt_tpu_torch.utils.config import EngineConfig

ckpt, progress, device = sys.argv[1], sys.argv[2], sys.argv[3]
seed, depth, cap, k, n_batches = map(int, sys.argv[4:9])
if device == "cpu":
    torch.set_num_threads(1)
rng = random.Random(seed)
stream = [rng.randrange(1, 1 << 250) for _ in range(k * n_batches)]
tree = EngineConfig(tree_depth=depth, initial_capacity_log2=cap,
                    sparse=True, device=device).build_tree()
for b in range(n_batches):
    if not tree.insert_batch(stream[b * k:(b + 1) * k]).all():
        sys.exit(f"batch {b} rejected a value")
    if b == 0:
        print("BUILT " + json.dumps(sorted(_build.build_seconds)),
              flush=True)
    checkpoint.save(tree, ckpt)           # atomic: write a temp, rename
    with open(progress + ".tmp", "w") as f:
        f.write(str(b + 1))
    os.replace(progress + ".tmp", progress)
print("DONE " + json.dumps({"root": tree.get_root_int(),
                            "count": tree.count}), flush=True)
"""


def drill_stream(seed: int, k: int, n_batches: int) -> list:
    """The worker's stream: k * n_batches distinct nonzero values."""
    rng = random.Random(seed)
    return [rng.randrange(1, 1 << 250) for _ in range(k * n_batches)]


def _lines(out: str, tag: str) -> list:
    return [json.loads(line[len(tag) + 1:]) for line in out.splitlines()
            if line.startswith(tag + " ")]


def kill_resume(workdir: str, device: str, depth: int, capacity_log2: int,
                k: int, n_batches: int) -> dict:
    """Run the drill in `workdir` (a temporary directory: the worker script,
    the snapshots and the progress files go there) on `device`.  Raises
    AssertionError unless the resumed tree ends on the uninterrupted
    worker's root and count and neither worker built a kernel.  Returns
    the batches the killed worker had checkpointed, the root and count,
    and the seconds from the start to the kill and of the resume."""
    from imt_tpu_torch.utils import checkpoint

    worker = os.path.join(workdir, "kill_resume_worker.py")
    with open(worker, "w") as f:
        f.write(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def start(name):
        args = [os.path.join(workdir, f"{name}.npz"),
                os.path.join(workdir, f"{name}.progress"), device,
                *map(str, (DRILL_SEED, depth, capacity_log2, k, n_batches))]
        return subprocess.Popen([sys.executable, worker, *args], env=env,
                                cwd=workdir, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    killed, whole = start("killed"), start("whole")
    try:
        progress = os.path.join(workdir, "killed.progress")
        deadline = time.monotonic() + DRILL_TIMEOUT_S
        while True:
            if os.path.exists(progress):
                with open(progress) as f:
                    if int(f.read() or 0) >= KILL_AFTER:
                        break
            if killed.poll() is not None:
                raise AssertionError("the worker ended before its kill: "
                                     + killed.communicate()[1][-2000:])
            if time.monotonic() > deadline:
                raise AssertionError(f"the worker never reached checkpoint "
                                     f"{KILL_AFTER}")
            time.sleep(0.01)
        killed.send_signal(signal.SIGKILL)
        out_killed = killed.communicate(timeout=60)[0]
        kill_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        resumed = checkpoint.load(os.path.join(workdir, "killed.npz"),
                                  device=device)
        if resumed.count % k:
            raise AssertionError(f"the snapshot holds {resumed.count} "
                                 f"values, not whole batches of {k}")
        done = resumed.count // k
        if not KILL_AFTER <= done < n_batches:
            raise AssertionError(f"the worker was killed after {done} of "
                                 f"{n_batches} batches")
        stream = drill_stream(DRILL_SEED, k, n_batches)
        for b in range(done, n_batches):
            if not resumed.insert_batch(stream[b * k:(b + 1) * k]).all():
                raise AssertionError(f"replayed batch {b} rejected a value")
        root = resumed.get_root_int()
        resume_s = time.perf_counter() - t1

        out_whole, err_whole = whole.communicate(timeout=DRILL_TIMEOUT_S)
        if whole.returncode != 0:
            raise AssertionError("the uninterrupted worker failed: "
                                 + err_whole[-2000:])
    finally:
        for p in (killed, whole):
            if p.poll() is None:
                p.kill()
                p.communicate()
    want = _lines(out_whole, "DONE")[0]
    if (root, resumed.count) != (want["root"], want["count"]):
        raise AssertionError(
            f"resumed root {root:#x} / count {resumed.count} differ from the "
            f"uninterrupted run's {want['root']:#x} / {want['count']}")
    built = _lines(out_killed, "BUILT") + _lines(out_whole, "BUILT")
    if len(built) != 2 or any(built):
        raise AssertionError(f"a worker built kernels: {built}")
    return {"batches_done": done, "root": root, "count": resumed.count,
            "kill_s": kill_s, "resume_s": resume_s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depth", type=int, default=None,
                    help="every round at this depth (default: 4, 5, 6 or 8 "
                    "at random)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    t0 = time.time()
    soak(args.rounds, args.seed, args.device, args.depth)
    print(f"SOAK PASSED: {args.rounds} rounds on {args.device} in "
          f"{time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
