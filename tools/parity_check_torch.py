"""On-card bit-exactness spot check of imt_tpu_torch's tree paths.

The port of ``tools/tpu_parity_check.py``.  It replays the reference
insertion sequence (src/indexed_merkle_tree.rs:679-803), a batched insert
into a depth-32 sparse tree and a witness batch on the card (the CUDA
kernels), and holds them against the port's python-int oracle
(``tree/reference_oracle.py``, ``ops/poseidon_ref.py``).  ``bench_torch.py
--artifact`` runs it first, so that the artifact's numbers carry an
on-card parity bit (``"parity": true``).

The depth-32 comparison uses the sparse-prefix discipline: the oracle
replays the values on the active prefix (the leftmost 2^5 slots, the only
occupied ones) and folds the prefix root up the zero-subtree spine, as
``tree/sparse.py`` does on the card.

Usage: python3 tools/parity_check_torch.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

SEQUENCE = [30, 10, 20, 5, 50, 35]


def spine_fold_oracle(root: int, depth: int, full_depth: int, params) -> int:
    """Active-prefix root -> full-depth root over the zero-subtree spine
    (host twin of tree/indexed._spine_fold)."""
    from imt_tpu_torch.ops.poseidon_ref import hash_fixed
    zs = [hash_fixed([0, 0, 0], params)]
    for _ in range(full_depth - 1):
        zs.append(hash_fixed([zs[-1], zs[-1]], params))
    for lvl in range(depth, full_depth):
        root = hash_fixed([root, zs[lvl]], params)
    return root


def run_parity(device: str = "cuda") -> dict:
    """Run the parity checks on `device`; returns a result dict for the
    bench artifact.  Raises on any mismatch, and on a request for the card
    where there is none."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_parity(device='cuda') needs a CUDA device")
    from imt_tpu_torch.ops.poseidon_ref import generate_params
    from imt_tpu_torch.tree import indexed
    from imt_tpu_torch.tree.reference_oracle import OracleIndexedTree
    from imt_tpu_torch.tree.sparse import SparseIndexedMerkleTree

    params = generate_params()
    checks = {}

    # 1. sequential reference replay (the 6-round loop,
    #    src/indexed_merkle_tree.rs:683-690): every intermediate root
    t = indexed.IndexedMerkleTree(3, device=device)
    o = OracleIndexedTree(depth=3, params=params)
    for v in SEQUENCE:
        w = t.insert(v)
        o.insert(v)
        assert bool(w.ok.all()), v
        assert t.get_root_int() == o.get_root(), f"root mismatch at {v}"
    checks["sequential_replay_d3"] = True
    print(f"sequential replay (6 rounds, depth 3): bit-exact on {device}")

    # 2. batched insert into a depth-32 SPARSE tree against the prefix
    #    oracle and the zero-spine fold
    rng = random.Random(3)
    vals = [rng.randrange(1, 1 << 253) for _ in range(16)]
    tb = SparseIndexedMerkleTree(32, initial_capacity_log2=5, device=device)
    assert tb.insert_batch(vals).all()
    ob = OracleIndexedTree(depth=5, params=params)
    for v in vals:
        ob.insert(v)
    want = spine_fold_oracle(ob.get_root(), 5, 32, params)
    assert tb.get_root_int() == want, "batched sparse root mismatch"
    checks["batched_sparse_d32"] = True
    print(f"batched sparse insert (16 values, depth 32): bit-exact on "
          f"{device}")

    # 3. witness batch: every accepted bundle satisfies insert_leaf
    tw = indexed.IndexedMerkleTree(8, device=device)
    wb = tw.insert_batch(vals, witness=True)
    assert wb.ok.all()
    indexed.check_insert_witness(wb)
    checks["witness_batch_predicate"] = True
    print(f"witness batch (16 values): predicate-verified on {device}")

    name = torch.cuda.get_device_name(torch.device(device)) \
        if torch.device(device).type == "cuda" else "cpu"
    return {"parity": True, "device": name, "checks": checks}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    print(json.dumps(run_parity(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
