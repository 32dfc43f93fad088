#!/usr/bin/env python3
"""10M-pair property fuzz of imt_tpu_torch's limb comparators.

    python tools/fuzz_compare_10m_torch.py [--rounds 160] [--device cuda|cpu]

The port of ``tools/fuzz_compare_10m.py``.  The reference validates its
128-bit-limb comparison formula on 10M random pairs (test_limbs_logic,
src/indexed_merkle_tree.rs:597-630); random 128-bit halves are practically
never equal, so each round of 2^16 pairs mixes in DELIBERATE equal-limb
structure: equal values, equal high halves, equal low halves and
off-by-one (the same ``_rand_pairs`` and seed as the JAX tool, but for one
repair: there the off-by-one pairs change limb 0 of an otherwise random b,
which leaves them random; here b is a with limb 0 plus one, so a
comparator that skips limb 0 fails).  160 rounds are about 10.5M pairs.
The reference's typo (`a_r == b_q` at :617) is fixed in ``gates.py`` and
not sought here: in that expansion it changes a result only where a's low
half equals b's high half, which no class above produces.

Checked on `--device` (the card unless "cpu" is asked for) against
python-int ground truth: ``field.less_than``, ``field.eq``,
``field.is_zero`` (of each value, and of the pair's limb-wise XOR, which is
zero exactly on equal pairs) and ``gates.less_than_254``, which goes
through ``gates.split_128``.  These are plain torch ops (XLA's work on the
TPU): no kernel is involved.  It prints ``PASS`` with the pair count and
wall time, or ``FAIL`` and exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 1 << 16
ROUNDS = 160            # ~10.5M pairs total
SEED = 0x1337


def _rand_pairs(rng, n):
    """n pairs with adversarial structure mixed in (uint32[16, n] limbs,
    16 bits each, values below 2^254)."""
    a = rng.randint(0, 1 << 16, size=(16, n), dtype=np.uint32)
    b = rng.randint(0, 1 << 16, size=(16, n), dtype=np.uint32)
    # canonicalize below p by clearing the top two limbs' high bits
    a[15] &= 0x2FFF
    b[15] &= 0x2FFF
    k = n // 8
    b[:, :k] = a[:, :k]                       # equal values
    b[8:, k:2 * k] = a[8:, k:2 * k]           # equal high halves
    b[:8, 2 * k:3 * k] = a[:8, 2 * k:3 * k]   # equal low halves
    b[:, 3 * k:4 * k] = a[:, 3 * k:4 * k]     # off-by-one in limb 0
    b[0, 3 * k:4 * k] = (a[0, 3 * k:4 * k] + 1) & 0xFFFF
    return a, b


def _ints(x: np.ndarray) -> np.ndarray:
    """uint32[16, n] limbs -> object[n] of python ints."""
    return sum(x[i].astype(object) << (16 * i) for i in range(16))


def check_round(a: np.ndarray, b: np.ndarray, device: str) -> list[str]:
    """The comparators on one batch of pairs against python ints; returns
    the names of those that disagree on some pair."""
    import torch

    from imt_tpu_torch.ops import field, gates

    av, bv = _ints(a), _ints(b)
    want = {"field.less_than": av < bv, "field.eq": av == bv,
            "gates.less_than_254": av < bv,
            "field.is_zero(a)": av == 0, "field.is_zero(b)": bv == 0,
            "field.is_zero(a ^ b)": av == bv}
    at = torch.as_tensor(a.astype(np.int32), device=device)
    bt = torch.as_tensor(b.astype(np.int32), device=device)
    got = {"field.less_than": field.less_than(at, bt),
           "field.eq": field.eq(at, bt),
           "gates.less_than_254": gates.less_than_254(at, bt),
           "field.is_zero(a)": field.is_zero(at),
           "field.is_zero(b)": field.is_zero(bt),
           "field.is_zero(a ^ b)": field.is_zero(at ^ bt)}
    return [name for name, w in want.items()
            if not np.array_equal(got[name].cpu().numpy(), w.astype(bool))]


def fuzz(rounds: int = ROUNDS, device: str = "cuda", batch: int = BATCH,
         seed: int = SEED, log=print) -> dict:
    """`rounds` rounds of `batch` pairs; raises AssertionError at the first
    round that disagrees.  Returns the pair count and the wall seconds."""
    rng = np.random.RandomState(seed)
    total = 0
    t0 = time.perf_counter()
    for r in range(rounds):
        a, b = _rand_pairs(rng, batch)
        bad = check_round(a, b, device)
        if bad:
            raise AssertionError(f"round {r}: {', '.join(bad)} disagree with "
                                 "python ints")
        total += batch
        if r % 40 == 0:
            log(f"  {total:,} pairs ok ({time.perf_counter() - t0:.1f} s)")
    return {"pairs": total, "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    try:
        out = fuzz(args.rounds, args.device,
                   log=lambda s: print(s, flush=True))
    except AssertionError as e:
        print(f"FAIL: {e}")
        return 1
    print(f"PASS: {out['pairs']:,} pairs (field + gates comparators) on "
          f"{args.device}, {out['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
