"""The rank programs of tests/test_torch_parallel.py and
tests/test_torch_local_plan.py, and the scenarios they share with the
single-device trees those tests hold them against.

Each scenario is a function of a tree (or a mesh) that returns its
outputs as numpy; the ranks run it on ``ShardedIndexedMerkleTree``s over
gloo (chip_smoke.py's ``start_ranks``), the tests run it on the port's
single-device trees and compare.  The programs and references run under
``torch.inference_mode``: the plain hashes are thousands of tiny tensor
ops, and without autograd's bookkeeping each op dispatches faster (the
same bits).  This file imports neither jax nor imt_tpu: the ranks load
it.
"""

from __future__ import annotations

import os
from unittest import mock

import numpy as np
import torch

from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.ops import field
from imt_tpu_torch.tree import indexed

CPU = "cpu"
P = field.P
INSERT_FIELDS = list(indexed.InsertWitness.__dataclass_fields__)
QUERY_FIELDS = list(indexed.NonInclusionWitness.__dataclass_fields__)
PROGRAMS = ("local_insert_batch", "local_insert_batches",
            "local_insert_batch_witness", "local_non_inclusion_witness")


def packed(values) -> np.ndarray:
    """Values (< 2^256, stored raw: p and above stay as they are) ->
    uint32 limbs [16, K]."""
    return np.array([[(int(v) >> (16 * i)) & 0xFFFF for v in values]
                     for i in range(field.LIMBS)], dtype=np.uint32)


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.asarray(x)
    return x if x.dtype == bool else x.astype(np.int64)


def fields(prefix: str, w, names) -> dict:
    return {f"{prefix}.{n}": np_(getattr(w, n)) for n in names}


def state(tree, prefix: str) -> dict:
    """The tree's snapshot arrays and root."""
    out = {f"{prefix}.{k}": np_(v) for k, v in tree.to_arrays().items()}
    out[f"{prefix}.root"] = tree.get_root_int()
    return out


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

# the container (dense depth 4): the first batch's slots 1..4 straddle the
# boundary of a 4-slot shard; duplicates, a zero, values >= p
C_DEPTH = 4
C_B1 = [30, 10, 10, 0]
C_INSERT = 42
C_B2 = [P + 5, 7, 30, 12]            # >= p, new, a duplicate of 30, new
C_SEQ = [5, 42, 8]                    # 42 is present
C_QUERIES = [11, 30, 0, P + 5, 2 ** 200]
C_PROOFS = (0, 3, 4, 9)


def container(tree) -> dict:
    out = {"c.ok1": np_(tree.insert_batch(packed(C_B1)))}
    out["c.root1"] = tree.get_root_int()
    out.update(fields("c.insert", tree.insert(C_INSERT), INSERT_FIELDS))
    out.update(fields("c.wb", tree.insert_batch(packed(C_B2), witness=True),
                      INSERT_FIELDS))
    out.update(fields("c.seq", tree.insert_seq(C_SEQ), INSERT_FIELDS))
    out.update(fields("c.ni", tree.non_inclusion_witness(packed(C_QUERIES)),
                      QUERY_FIELDS))
    for i in C_PROOFS:
        proof, helpers = tree.get_proof(i)
        out[f"c.proof{i}"] = np_(proof)
        out[f"c.helpers{i}"] = np_(helpers)
        out[f"c.leaf{i}"] = np.array(tree.get_leaf_ints(i), dtype=object)
    out.update(state(tree, "c"))
    return out


# growth: a sparse depth-5 tree from 2 slots; over 4 ranks it is replicated
# until 8 slots are held, then sharded (2, then 4 slots per rank)
G_DEPTH, G_CAP = 5, 1
G_BATCHES = ([9, 3, 9], [1, 2, 40, 4], [50, 0, 45, 44])


def growth(tree, sharded=None) -> dict:
    out = {}
    for i, b in enumerate(G_BATCHES):
        out[f"g.ok{i}"] = np_(tree.insert_batch(b))
        out[f"g.ad{i}"] = tree.active_depth
        if sharded is not None:
            out[f"g.sharded{i}"] = sharded(tree)
    out.update(state(tree, "g"))
    return out


# D = 1: the plain step, whatever the entry point
ONE_B = [30, 10, 20]


def one_device(tree) -> dict:
    out = {"one.ok": np_(tree.insert_batch(ONE_B))}
    out.update(fields("one.insert", tree.insert(25), INSERT_FIELDS))
    out.update(fields("one.ni", tree.non_inclusion_witness([21, 20]),
                      QUERY_FIELDS))
    out.update(state(tree, "one"))
    return out


# a snapshot's resumed tree takes one more batch
RESUME_B = [99, 100]


def resumed(tree, prefix: str) -> dict:
    out = {f"{prefix}.count0": tree.count, f"{prefix}.root0":
           tree.get_root_int()}
    out[f"{prefix}.ok"] = np_(tree.insert_batch(RESUME_B))
    out.update(state(tree, prefix))
    return out


# tests/test_torch_chained.py's chain and queries (a sparse depth-6 tree
# holding 2^4 slots), which that file holds against imt_tpu's
J_FULL, J_CAP = 6, 4
J_BATCHES = [[30, 10, 2 ** 250, 10], [2 ** 250, 50, 35, 0]]
J_QUERIES = [11, 30, 0, 2 ** 250 + 1]
# proofs inside the prefix (on ranks 0 and 2) and beyond it (the zero
# spine, slots 32 and 63 with the prefix root folded one level up)
J_PROOFS = (0, 9, 16, 31, 32, 63)


def chain_and_queries(tree) -> dict:
    out = {"j.oks": np_(tree.insert_batches(np.stack(
        [packed(b) for b in J_BATCHES])))}
    out.update(fields("j.ni", tree.non_inclusion_witness(packed(J_QUERIES)),
                      QUERY_FIELDS))
    for i in J_PROOFS:
        proof, helpers = tree.get_proof(i)
        out[f"j.proof{i}"], out[f"j.helpers{i}"] = np_(proof), np_(helpers)
    out.update(state(tree, "j"))
    return out


# the planner (test_torch_local_plan.py): imt_tpu's witness program
# (tests/test_torch_batch_witness.py's shape: a sparse depth-6 tree holding
# 2^4 slots; the second batch meets values of the first, 50 among them),
# then plain batches that grow the tree across a shard boundary, and a
# chain of three
W_FULL, W_CAP = 6, 4
W_B1 = [30, 10, 20, 5, 50, 35, 2 ** 200]
W_B2 = [50, 50, 7, 0, 120, 119, 31]
L_B = [P + 1, 33, 36, 33]           # slots 15..18: 8 -> 16 slots per rank
L_CHAIN = [[121, 3], [3, 0], [2 ** 255, 122]]


def witness_part(tree) -> dict:
    out = {}
    for i, b in enumerate((W_B1, W_B2)):
        out.update(fields(f"w{i}", tree.insert_batch(b, witness=True),
                          INSERT_FIELDS))
    out.update(state(tree, "w"))
    return out


@torch.inference_mode()
def planner(tree) -> dict:
    out = witness_part(tree)
    out["l.ok"] = np_(tree.insert_batch(packed(L_B)))
    out["l.ad"] = tree.active_depth
    out["l.root"] = tree.get_root_int()
    out["l.oks"] = np_(tree.insert_batches(np.stack(
        [packed(b) for b in L_CHAIN])))
    out.update(state(tree, "l"))
    return out


PLAIN_SNAPSHOT_B = [3, 1, 4]


def plain_snapshot(path: str):
    """A single-device tree, saved to `path` for the ranks to load onto a
    mesh; returned."""
    from imt_tpu_torch.utils import checkpoint
    snap = IndexedMerkleTree(C_DEPTH, device=CPU)
    snap.insert_batch(PLAIN_SNAPSHOT_B)
    checkpoint.save(snap, path)
    return snap


@torch.inference_mode()
def parallel_reference(snap) -> dict:
    """test_torch_parallel.py's scenarios on the port's single-device
    trees (`snap`: the plain snapshot's tree)."""
    tree = IndexedMerkleTree(C_DEPTH, device=CPU)
    out = container(tree)
    out.update(resumed(tree, "ck"))
    out.update(growth(SparseIndexedMerkleTree(G_DEPTH, G_CAP, device=CPU)))
    out.update(one_device(IndexedMerkleTree(C_DEPTH, device=CPU)))
    out.update(state(snap, "pk"))
    out.update(state(IndexedMerkleTree(C_DEPTH, device=CPU), "cfg"))
    out.update(chain_and_queries(SparseIndexedMerkleTree(J_FULL, J_CAP,
                                                         device=CPU)))
    return out


# ---------------------------------------------------------------------------
# the rank programs
# ---------------------------------------------------------------------------

def _counting(module):
    """Patch the four shard-local programs of `module` to count their
    calls: (the patchers, the counts)."""
    counts = dict.fromkeys(PROGRAMS, 0)

    def wrap(name):
        fn = getattr(module, name)

        def counted(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return counted
    return [mock.patch.object(module, n, wrap(n)) for n in PROGRAMS], counts


@torch.inference_mode()
def parallel_ranks(rank: int, world: int, work_dir: str,
                   plain_snapshot: str) -> dict:
    """tests/test_torch_parallel.py's program, on 4 ranks."""
    from imt_tpu_torch.parallel import collectives, local_plan, sharded
    from imt_tpu_torch.parallel.sharded import ShardedIndexedMerkleTree
    from imt_tpu_torch.utils import checkpoint
    from imt_tpu_torch.utils.config import EngineConfig

    m4 = sharded.make_mesh(device_type=CPU)
    m2 = sharded.make_mesh(2, device_type=CPU)
    m1 = sharded.make_mesh(1, device_type=CPU)
    m22 = sharded.make_mesh2(2, 2, device_type=CPU)
    out = {"mesh": [(m.mesh_dim_names, m.mesh.tolist(), m.get_coordinate())
                    for m in (m4, m2, m1, m22)]}

    rng = np.random.default_rng(11)
    a, b, c = (field.random_limbs(int(rng.integers(1 << 30)), 8, 253)
               for _ in range(3))
    out["hash2"] = np_(sharded.sharded_hash2(a, b, m4, device=CPU))
    out["hash3"] = np_(sharded.sharded_hash3(a, b, c, m4, device=CPU))
    leaves = field.random_limbs(5, 16, 253)
    out["top4"] = np_(sharded.sharded_tree_root(leaves, m4, device=CPU)[1])
    out["top2"] = np_(sharded.sharded_tree_root(leaves[:, :8], m2,
                                                device=CPU)[1])
    own, top = sharded.sharded_tree_root2(leaves, m22, device=CPU)
    out["own22"], out["top22"] = np_(own), np_(top)
    out["root22"] = np_(sharded.sharded_root2(leaves, m22, device=CPU))

    patches, counts = _counting(local_plan)
    for p in patches:
        p.start()
    tree = ShardedIndexedMerkleTree(C_DEPTH, m4, sparse=False, device=CPU)
    out["c.sharded"] = tree.is_sharded
    out.update(container(tree))
    collectives.reset_counts()
    out.update(growth(ShardedIndexedMerkleTree(
        G_DEPTH, m4, sparse=True, initial_capacity_log2=G_CAP, device=CPU),
        sharded=lambda t: (t.is_sharded, dict(counts))))
    out["g.growth"] = list(collectives.CALLS.get("growth", []))
    for p in patches:
        p.stop()

    # D = 1: every entry point takes the plain step
    fail = mock.Mock(side_effect=AssertionError(
        "the shard-local planner ran on a 1-device mesh"))
    with mock.patch.multiple(local_plan, **dict.fromkeys(PROGRAMS, fail)):
        one = ShardedIndexedMerkleTree(C_DEPTH, m1, device=CPU)
        out["one.sharded"] = one.is_sharded
        out.update(one_device(one))

    # checkpoint: save at D = 4, load at D = 2; a plain snapshot onto the
    # mesh; EngineConfig(mesh_devices=2)
    path = os.path.join(work_dir, "sharded.npz")
    checkpoint.save(tree, path)
    with np.load(path) as z:
        out["ck.marker"] = int(z["sharded"])
    back = checkpoint.load(path, device=CPU, mesh=m2)
    out["ck.kind"] = (type(back).__name__, back.mesh.size(), back.is_sharded)
    out.update(resumed(back, "ck"))
    plain = checkpoint.load(plain_snapshot, device=CPU, mesh=m4)
    out["pk.kind"] = (type(plain).__name__, plain.mesh.size(),
                      plain.is_sharded)
    out.update(state(plain, "pk"))
    cfg = EngineConfig(tree_depth=C_DEPTH, sparse=False, mesh_devices=2,
                       device=CPU).build_tree()
    out["cfg.kind"] = (type(cfg).__name__, cfg.mesh.size(), cfg.is_sharded,
                       str(cfg.device))
    out.update(state(cfg, "cfg"))

    out.update(chain_and_queries(ShardedIndexedMerkleTree(
        J_FULL, m4, sparse=True, initial_capacity_log2=J_CAP, device=CPU)))
    return out


@torch.inference_mode()
def local_plan_ranks(rank: int, world: int) -> dict:
    """tests/test_torch_local_plan.py's program, on 2 ranks: the planner
    scenario, then the byte audit, clean and with a full-state gather
    slipped into the insert program."""
    from imt_tpu_torch.parallel import (collective_audit, collectives,
                                        local_plan, sharded)
    from imt_tpu_torch.parallel.sharded import ShardedIndexedMerkleTree

    mesh = sharded.make_mesh(device_type=CPU)
    collectives.reset_counts()
    tree = ShardedIndexedMerkleTree(W_FULL, mesh, sparse=True,
                                    initial_capacity_log2=W_CAP, device=CPU)
    out = planner(tree)
    out["calls"] = dict(collectives.CALLS)
    audit = collective_audit.audit_local_plan(mesh, depth=3, k=2, chain=2,
                                              device=CPU)
    out["audit"] = (audit.failures == [], audit.summary(),
                    [(p.name, p.calls, p.calls_big) for p in audit.programs])

    real = local_plan._exchange

    def leaky(shard, queries, group):
        collectives.all_gather(shard.vals, group)   # the whole state
        return real(shard, queries, group)
    with mock.patch.object(local_plan, "_exchange", leaky):
        bad = collective_audit.audit_local_plan(
            mesh, depth=3, k=2, chain=2, device=CPU,
            programs=("insert_batch",))
    out["leaky"] = ([p.name for p in bad.failures], bad.summary())
    return out
