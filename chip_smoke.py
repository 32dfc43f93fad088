#!/usr/bin/env python3
"""Smoke run of imt_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the CUDA kernels from ``imt_tpu_torch/ops/csrc`` (one nvcc per
source, in parallel), holds every entry point bit for bit against its plain
torch version on the card, drives the port's paths and checks what comes
out, then times the paths and the kernels.  Phases, in order; any failure
raises and the exit code is not 0:

1. device: CUDA present; the card's name, power limit and SM clock; the
   least multiply-adds per permutation that the bounds count, beside the
   kernels' own;
2. build: nvcc, with the build times, the ptxas register report (no spill
   in K1 or the hash kernels), and the SASS census per permutation of K1
   (permute_kernel) and of the hash kernels' sparse core (instructions by
   opcode, the multiply-adds counted in the built library against the
   source's count);
3. Poseidon kernel vs plain, bit for bit, at a ragged width of 65537 lanes
   with edge values and at the main path's own widths (config 5's hash3
   over 2^17 leaves, down to the sequential path's 2 and 1; K1 with
   n_perms 1 and 3), hash3 at
   2^21 and hash2 at 2^20 lanes (phase 7's rebuild), and the H(0,0,0) and
   poseidonperm_x5_254_3 anchors;
3b. every probe body (``csrc/vpu_roofline.cu``) vs plain, bit for bit, at
   [48, 65537] with k = 64 and k = 1, and at [48, 65536] with k = 4;
4. the batched path: four depth-24 batches of 4096 values with planted
   duplicates and zeros (acceptance against set semantics, root against a
   full rebuild, the linked list walked in order, launch counts), then a
   depth-6 replay against the python-int oracle;
4b. the sequential witness path on that depth-24 tree: insert_seq of 64
   values (duplicates, zeros, present values; every accepted witness passes
   insert_leaf, the roots chain, the root equals a full rebuild),
   non_inclusion_witness of 4096 queries (ok = absent, verify_non_inclusion
   true on every ok lane and false once a sibling is flipped), MerkleTree of
   2^16 leaves (proofs verify, a corrupted one fails), and the depth-6
   golden path [30, 10, 20, 5, 50, 35] through insert against the oracle;
6. the sparse tree and the witness batches.  Config 5's shape
   (bench.py:453-484): a depth-32 SparseIndexedMerkleTree holding 2^21
   slots takes 16 batches of K = 65536 with planted duplicates and zeros
   through insert_batches in groups of 8 (ok against set semantics on numpy
   rows; the root against a dense depth-24 twin fed the same batches and a
   rebuild of the prefix, both folded over the zero spine with python ints;
   the list walked in order).  Config 3w's shape: 8 witness batches of
   K = 4096 into a depth-16 tree, then one into a depth-32 tree that grows
   from 2^10 slots (every accepted lane passes insert_leaf, a flipped
   sibling fails, the roots chain, the state equals a twin's through
   insert_batch), and a K = 256 witness batch equal to insert_seq on its
   accepted lanes; the config-5 tree is then checkpointed;
7. operations: the config-5 snapshot loaded on the card (root and count
   equal phase 6's, the rebuild's launches counted), check_tree of 64
   slots (passes, then catches one flipped bit), one more pipelined group
   of 8 x 65536 through Watchdog(interval=8).insert_batches(as_numpy=
   False) under observability.trace and the card's sync debug mode (ok a
   CUDA tensor equal to set semantics and to an as_numpy=True twin's, the
   trace naming the hash2 kernel, the watchdog auditing on its 8th call),
   the kill-resume drill on the card (a worker SIGKILLed after its third
   checkpoint, resumed to an uninterrupted worker's root and count), and
   tools/soak_indexed_torch.py's 12 rounds on the card;
8. the sharded path (``imt_tpu_torch/parallel``).  8a: NCCL at world size
   1 on the card: a ShardedIndexedMerkleTree at phase 4's shape takes the
   plain step (no shard-local program runs) to phase 4's root, and
   sharded_tree_root over NCCL equals MerkleTree.build.  8b: four gloo
   ranks sharing the card (a correctness run of the sharded code on the
   real kernels, its collectives through the host, not a multi-GPU rate):
   config 5's stream, regenerated in each rank from phase 6's seed,
   through insert_batches on a depth-32 tree sharded 2^19 slots per rank
   (ok masks and root equal phase 6's, bit for bit), a K = 4096 witness
   batch and 4096 non-inclusion witnesses equal a single-device twin's,
   sharded_tree_root of 2^20 leaves, a sharded checkpoint's round trip,
   and the candidate exchange's bytes per call equal at depth 32 and at
   depth 24 (the byte audit on the card); each rank's launches and bytes
   per call are printed;
9. the native oracle, hash_fixed, the fuzz.  9a: the port's C++ oracle
   (``imt_tpu_torch/native``, built with g++) reproduces H(0,0,0), and its
   hash2 and hash3 of 65537 seeded pairs and triples equal the card's hash
   kernels bit for bit through the limb bridge; its single-core hashes/s
   as ``bench.py --oracle`` measures it, beside the host CPU's model.  9b:
   two witness batches of K = 4096 at depth 16 (config 3w's) on the card
   against the C++ tree's inserts one by one: ok on every lane, every
   witness field on the accepted lanes, the roots.  9c: hashing.hash_fixed
   on the card at arities 1-8, widths 65537 (edge values, p - 1 columns)
   and 2, arity 4 also at 2^17, each call's K1 launches n // 2 + 1,
   against the plain version bit for bit; arities 2 and 3 through K1 equal
   hash2 and hash3.  9d: tools/fuzz_compare_10m_torch.py's comparator
   fuzz, 16 rounds of 2^16 pairs on the card;
5. numbers: depth-24 inserts/s (batched and sequential), non-inclusion
   witnesses/s, phase 6's sparse chained inserts/s and witness-batch
   inserts/s, the probe's rates per body (its own path), and each
   kernel's time beside its plain version's and its bound, the Poseidon
   entry points also at a width that fills the card, K1 per permutation
   (n_perms 1 and 2, with both bounds' shares) against hash2 per
   permutation at widths 2, 8192, 66560 and 2^17, and hash_fixed of arity
   4 and 8 at 2^17 (ms a call beside the plain version's, K1 launches a
   call, ms per permutation against K1 alone).

Phases 6, 7, 8 and 9 run before phase 5, which prints its numbers.  The
line before the last is the kernels' JSON record (each kernel with its
launches per path); the last line is ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import platform
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEPTH, K, N_BATCHES = 24, 4096, 4
RAGGED = 65537
TIMING_WIDTH = 8192
SEQ_WIDTH = 2                 # a sequential insert's hash2 launches
FILL_WIDTH = 1 << 17          # 132 SMs x ~8 blocks of 128 lanes
BENCH_WIDTH = 66560           # bench.py's perms/s batch (bench.py:36-41)
SEQ_VALUES = 64
QUERIES = 4096
MERKLE_LEAVES = 1 << 16
GOLDEN = [30, 10, 20, 5, 50, 35]
PROBE_SHAPE = (48, 65536)
PROBE_K = 64                  # k of the probe bodies' kernel-vs-plain times
SEED = 20260601
# phase 6: config 5's shape (bench.py:453-484: depth 32, K = 65536, 16
# batches in groups of 8, 2^21 slots held as bench.py:405 sizes it), its
# dense depth-24 twin, and config 3w's (depth 16, witness batches of 4096)
C5_DEPTH, C5_CAPACITY, C5_K, C5_BATCHES, C5_GROUP = 32, 21, 65536, 16, 8
C5_DENSE_DEPTH = 24
# phase 8: the sharded path, 4 gloo ranks on the one card (a witness batch,
# half-present queries, the leaves of sharded_tree_root, the audit's dense
# depth), each rank and the join under one timeout (s)
SHARD_RANKS, SHARD_TIMEOUT = 4, 600
S_W_K, S_Q, S_ROOT_LEAVES, S_AUDIT_DEPTH = 4096, 4096, 1 << 20, 24
W_DEPTH, W_K, W_BATCHES, W_SEQ = 16, 4096, 8, 256
# phase 3: config 5's (hash3 over 2 * C5_K leaves, hash2 over the C5_K low
# leaves), its sharded path's on each of 4 ranks (hash3 over 2 * C5_K / 4
# leaves, hash2 over the first slab window and the C5_K rewrite lanes), a
# ragged width, the batched and witness paths' (2K, K), the sequential
# one's (2)
PHASE3_WIDTHS = (2 * C5_K, C5_K + C5_K // 2 + 1, RAGGED, C5_K, C5_K // 2,
                 2 * K, K, K // 2 + 1, 129, SEQ_WIDTH, 1)
# phase 3, the resume's own widths (phase 7): its rebuild runs hash3 over
# every held slot of config 5 and hash2 over the level above.  The plain
# version runs over them in calls of PLAIN_CHUNK lanes (lanes are
# independent): at 2^21 lanes its [16, 16, 3, B, 3] int64 MDS products
# alone would take 38.7 GB of the card.
PHASE3_WIDE = (("hash3_leaf", 1 << C5_CAPACITY),
               ("hash2_nodes", 1 << (C5_CAPACITY - 1)))
PLAIN_CHUNK = 1 << 18
# phase 3: K1's chain lengths (an odd one catches a state carried
# unreduced from one permutation to the next)
K1_CHAINS = (1, 3)
# phase 7: the watchdog's cadence and sample, the follow-up calls that
# complete its cadence, and the kill-resume drill on the card (a depth-32
# tree that grows from 2^10 slots to 2^16 inside the run)
WD_INTERVAL, WD_SAMPLE, WD_SMALL_K = 8, 16, 16
AUDIT_SAMPLE = 64
DRILL = dict(depth=32, capacity_log2=10, k=4096, n_batches=12)
SOAK_ARGS = ("--rounds", "12", "--seed", "7")
# the __global__ function behind imt_hash2_nodes, as a trace names it
HASH2_SYMBOL = "hash2_kernel"

# phase 9: the native oracle's rate as bench.py --oracle measures it
# (bench.py:486-505, :570: 4096 pairs, 32 iterations); witness batches
# against the C++ tree at config 3w's depth and K (W_DEPTH, W_K), two
# batches, the second holding duplicates of the first; hash_fixed's
# arities and widths (the ragged one and a sequential insert's), arity 4
# also at FILL_WIDTH, arities 4 and 8 timed in phase 5; the fuzz's rounds
# of 2^16 pairs
ORACLE_BATCH, ORACLE_ITERS = 4096, 32
NATIVE_BATCHES = 2
FIXED_ARITIES = tuple(range(1, 9))
FIXED_WIDTHS = (RAGGED, SEQ_WIDTH)
FIXED_WIDE_ARITY = 4
FIXED_TIMED = (4, 8)
FUZZ_ROUNDS = 16

ANCHOR_H000 = 1960587138944869480785025106734196872454309951825657414575195034687326603497
TV_PERM_012 = [
    0x115cc0f5e7d690413df64c6b9662e9cf2a3617f2743245519e19607a4417189a,
    0x0fca49b798923ab0239de1c9e7a4a9a2210312b6a2f616d18b5a87f9b628ae29,
    0x0e7ae82e40091e63cbd4f16a6d16310b3729d4b6e138fcf54110e2867045a30c,
]

POSEIDON_SOURCE = "imt_tpu_torch/ops/csrc/poseidon_bn254.cu"
ROOFLINE_SOURCE = "imt_tpu_torch/ops/csrc/vpu_roofline.cu"
# Poseidon entry point -> (TPU code it replaces, the paths that run it).
# hash2 and hash3 are two modes of _hash_fn (pallas_call :1256), permute_n
# is _permute_fn (pallas_call :1216); the TPU ran the conversions as XLA
# around the kernel.
# hash_fixed runs hash2 and hash3 at arities 2 and 3 and K1 at the others.
POSEIDON = {
    "hash3_leaf": ("imt_tpu/ops/poseidon_rns_pallas.py:1240",
                   ("insert_batch", "sequential", "sparse_batches",
                    "witness_batch", "resume", "watchdog_group", "drill",
                    "sharded_nccl1", "sharded", "hash_fixed")),
    "hash2_nodes": ("imt_tpu/ops/poseidon_rns_pallas.py:1240",
                    ("insert_batch", "sequential", "sparse_batches",
                     "witness_batch", "resume", "watchdog_group", "drill",
                     "sharded_nccl1", "sharded", "hash_fixed")),
    "nodes_to_limbs": ("imt_tpu/ops/field_rns.py:262",
                       ("insert_batch", "sequential", "witness_batch",
                        "resume", "watchdog_group", "drill", "sharded",
                        "hash_fixed")),
    "limbs_to_nodes": ("imt_tpu/ops/field_rns.py:249",
                       ("sequential", "hash_fixed")),
    "permute_n": ("imt_tpu/ops/poseidon_rns_pallas.py:1199",
                  ("hash_fixed",)),
}
ROOFLINE_REPLACES = "tools/vpu_roofline.py:83"

# What the port's kernels execute, counted from the source and held against
# their SASS in phase 2.  The sparse core (permute_sparse: hash2_kernel,
# hash3_kernel): a permutation is 600 Montgomery products (8 full rounds x
# 18, 57 partial x 8), each 128 wide (32x32->64-bit) multiply-adds and 8
# 32-bit ones (mont_mul_cc: each row's 8 products as 64-bit multiply-adds).
SPARSE_MONT_PER_PERM = 600
ADDRESSING = 16    # wide multiplies a lane may spend on its addresses
WIDE_PER_MONT, NARROW_PER_MONT = 128, 8

# What the bound counts: the least work of each function among the
# schedules in the repo.  8 x 32-bit limbs: a 256x256-bit product is 64
# wide multiply-adds, a square 36 (each cross product once, doubled by a
# shift), a Montgomery reduction 64 wide and 8 32-bit ones.  An S-box x^5
# is two squares and a product, each reduced; a dot of an MDS row sums its
# three products unreduced and reduces once; the 57 partial rounds take
# imt_tpu's sparse form with lazy column words (permute_opt_lazy,
# imt_tpu/ops/poseidon_opt.py:160) at the refresh period that needs least.
R_F, R_P = 8, 57
PRODUCT, SQUARE, REDC_WIDE, REDC_NARROW = 64, 36, 64, 8


# K1's core (permute_lazy, chained n_perms times in permute_kernel): the
# sparse core's schedule with the least-work arithmetic.  Each dot is
# reduced once (mont_dot3: three products' rows, one reduction row per
# row: 256 wide and 8 32-bit multiply-adds) and each square takes its 36
# products (mont_sqr: 100 wide, 8 32-bit).  An S-box is two squares and a
# product; a full round is three S-boxes and three dots, a partial round
# one S-box, one dot and two products.
K1_DOTS = R_F * 3 + R_P
K1_SQUARES = 2 * K1_DOTS
K1_MONT = K1_DOTS + 2 * R_P
K1_WORK = (K1_MONT * WIDE_PER_MONT + K1_SQUARES * (SQUARE + REDC_WIDE)
           + K1_DOTS * (3 * PRODUCT + REDC_WIDE),
           (K1_MONT + K1_SQUARES + K1_DOTS) * REDC_NARROW)


def least_perm_work(g: int) -> tuple:
    """(wide, 32-bit) multiply-adds of one permutation whose partial rounds
    refresh their column words every g rounds."""
    sbox_w, sbox_n = 2 * SQUARE + PRODUCT + 3 * REDC_WIDE, 3 * REDC_NARROW
    wide = R_F * 3 * (sbox_w + 3 * PRODUCT + REDC_WIDE)
    narrow = R_F * 3 * (sbox_n + REDC_NARROW)
    for start in range(0, R_P, g):
        n = min(g, R_P - start)
        # n S-boxes; row 0 at step d sums 3 + d products (m00 s, v.x and
        # the d combined terms) into one reduction; the two columns take
        # n products each and one reduction each at the refresh
        wide += n * sbox_w + sum(3 + d for d in range(n)) * PRODUCT \
            + n * REDC_WIDE + 2 * n * PRODUCT + 2 * REDC_WIDE
        narrow += n * sbox_n + n * REDC_NARROW + 2 * REDC_NARROW
    return wide, narrow


PERM_WORK = min((least_perm_work(g) for g in range(1, 12)), key=sum)
TO_MONT = (PRODUCT + REDC_WIDE, REDC_NARROW)      # x R^2, reduced
FROM_MONT = (REDC_WIDE, REDC_NARROW)              # x, reduced
LANE_WORK = {
    "permute_n": PERM_WORK,
    "hash2_nodes": tuple(2 * w for w in PERM_WORK),
    "hash3_leaf": tuple(2 * w + 3 * c for w, c in zip(PERM_WORK, TO_MONT)),
    "limbs_to_nodes": TO_MONT, "nodes_to_limbs": FROM_MONT}
# Bytes: each input read once, the output written once.
BYTES_PER_LANE = {"permute_n": 192, "hash2_nodes": 96, "hash3_leaf": 224,
                  "limbs_to_nodes": 96, "nodes_to_limbs": 96}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def seeded_limbs(rng, width: int, bits: int = 254) -> np.ndarray:
    """int32[16, width] random values < 2^bits (some >= p when bits = 254)."""
    x = rng.integers(0, 1 << 16, (16, width), dtype=np.int64)
    top, rem = divmod(bits, 16)
    x[top + 1:] = 0
    if rem:
        x[top] &= (1 << rem) - 1
    return x.astype(np.int32)


def int_limbs(v: int) -> np.ndarray:
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                    dtype=np.int32)


def max_abs_err(a, b):
    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max().item())
    return int((a.long() - b.long()).abs().max().item())


# -- phase 2: the SASS census of the permutation -----------------------------

_SASS_INS = re.compile(
    r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P[0-9T]\s+)?([A-Z0-9_.]+)\s*([^;]*);")


def kernel_instructions(sass: str, kernel: str) -> list:
    """(address, opcode, operands) of each instruction of `kernel`'s SASS."""
    body = sass[sass.index(kernel + "E"):]
    body = body[:body.find("Function :")] if "Function :" in body else body
    ins = []
    for line in body.splitlines():
        m = _SASS_INS.match(line)
        if m:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return ins


def _branches(ins) -> list:
    """(address, target) of every branch with a literal target."""
    out = []
    for addr, op, args in ins:
        if op == "BRA":
            t = re.match(r"\s*(0x[0-9a-f]+)", args)
            if t:
                out.append((addr, int(t.group(1), 16)))
    return out


def _count(ins, a: int, b: int) -> dict:
    """Opcode counts of the instructions at addresses [a, b)."""
    c = {}
    for addr, op, _ in ins:
        if a <= addr < b:
            c[op] = c.get(op, 0) + 1
    return c


def k1_census(sass: str) -> dict:
    """Instructions per permutation of K1, from permute_kernel's SASS.  The
    kernel chains its n_perms permutations in one loop, whose body is one
    permutation of K1's core: a loop of 3 leading full rounds, the last
    leading round, a loop of 57 partial rounds and a loop of 4 trailing
    full rounds.  The perms loop's code outside the round loops counts
    once, each round loop's body its trips.  The wide multiplies
    (IMAD.WIDE.U32 and IMAD.HI.U32) must lie between the source's count
    (K1_WORK; its squares leave the compiler nothing to share) and that
    count plus a lane's addressing, and the 32-bit products (m of each
    reduction row) must all be there.  Returns counts by opcode."""
    ins = kernel_instructions(sass, "permute_kernel")
    loops = sorted((t, a) for a, t in _branches(ins) if t < a)
    if len(loops) != 4:
        raise AssertionError(f"expected 4 loops in permute_kernel's SASS, "
                             f"got {len(loops)}")
    lo, hi = max(loops, key=lambda ta: ta[1])
    rounds = [ta for ta in loops if ta != (lo, hi)]
    if not all(lo <= t and a < hi for t, a in rounds) or any(
            rounds[i][1] >= rounds[i + 1][0] for i in range(2)):
        raise AssertionError("permute_kernel's round loops are not three "
                             "disjoint loops inside the perms loop")
    backs = {a for _, a in loops}
    if any(a not in backs and any(t <= a <= b for t, b in rounds)
           for a, _ in _branches(ins)):
        raise AssertionError("a branch inside a round loop of "
                             "permute_kernel")
    per = _count(ins, lo, hi + 16)
    for (t, a), trips in zip(rounds, (R_F // 2 - 1, R_P, R_F // 2)):
        for k, v in _count(ins, t, a + 16).items():
            per[k] += (trips - 1) * v
    wide = per.get("IMAD.WIDE.U32", 0) + per.get("IMAD.HI.U32", 0)
    want, narrow = K1_WORK
    if not want <= wide <= want + ADDRESSING or per.get("IMAD", 0) < narrow:
        raise AssertionError(
            f"K1: SASS wide multiplies {wide} and IMAD {per.get('IMAD', 0)} "
            f"per permutation, against the source's {want} and {narrow}")
    return per


def sparse_census(sass: str) -> dict:
    """Instructions per permutation of the sparse core, from hash2_kernel's
    SASS.  The kernel runs two permutations, each a loop of 3 leading full
    rounds, the last leading round, a loop of 57 partial rounds and a loop
    of 4 trailing full rounds: six loops without branches inside, in that
    order, the partial ones having the fewest wide multiplies.  Each loop
    body (an innermost backward branch's range) counts its trips, the code
    outside the loops once; the sum is halved.  The source's wide
    multiplies (IMAD.WIDE.U32 and IMAD.HI.U32) are 128 per product, 600
    products per permutation, of which 162 are squares; in a square the
    compiler may share row 0's products a0*aj with the products aj*a0 (7
    per square).  The census fails unless the count lies between that and
    the source's count plus a lane's addressing, and the 32-bit products
    (IMAD: m of each reduction row, 8 per product) are all there.  Returns
    counts by opcode (halves are kept)."""
    ins = kernel_instructions(sass, "hash2_kernel")
    loops = sorted((t, a) for a, t in _branches(ins) if t < a)
    if len(loops) != 6 or any(loops[i][1] >= loops[i + 1][0]
                              for i in range(5)):
        raise AssertionError(f"expected 6 disjoint loops in hash2_kernel's "
                             f"SASS, got {len(loops)}")
    backs = {a for _, a in loops}
    if any(a not in backs and any(t <= a <= b for t, b in loops)
           for a, _ in _branches(ins)):
        raise AssertionError("a branch inside a loop of hash2_kernel")
    wide = lambda c: c.get("IMAD.WIDE.U32", 0) + c.get("IMAD.HI.U32", 0)
    bodies = [_count(ins, t, a + 16) for t, a in loops]
    if sorted(range(6), key=lambda i: wide(bodies[i]))[:2] != [1, 4]:
        raise AssertionError("hash2_kernel's loops are not (full, partial, "
                             "full) twice")
    total = _count(ins, 0, 1 << 62)
    for body, trips in zip(bodies, 2 * (R_F // 2 - 1, R_P, R_F // 2)):
        for k, v in body.items():
            total[k] += (trips - 1) * v
    per = {k: v / 2 for k, v in total.items()}
    want = SPARSE_MONT_PER_PERM * WIDE_PER_MONT
    squares = R_F * 3 * 2 + R_P * 2
    if not want - 7 * squares <= wide(per) <= want + ADDRESSING or \
            per.get("IMAD", 0) < SPARSE_MONT_PER_PERM * NARROW_PER_MONT:
        raise AssertionError(
            f"sparse core: SASS wide multiplies {wide(per)} and IMAD "
            f"{per.get('IMAD', 0)} per permutation, against the source's "
            f"{want} (less up to {7 * squares} shared in squares) and "
            f"{SPARSE_MONT_PER_PERM * NARROW_PER_MONT}")
    return per


def _function_name(mangled: str) -> str:
    """The last component of a mangled nested name (_ZN<len><name>...E)."""
    i, name = mangled.find("_ZN") + 3, mangled
    while 2 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name


def ptxas_report(log: str) -> dict:
    """kernel -> (registers, spill store bytes, spill load bytes), from the
    ptxas -v lines of one build."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = _function_name(m.group(1))
            out[fn] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


# kernels whose ptxas report must show no spills
NO_SPILLS = ("hash2_kernel", "hash3_kernel", "permute_kernel")


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    _build.build()
    secs = {n: round(s, 1) for n, s in _build.build_seconds.items()}
    print(f"phase 2: kernel libraries built (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.1f} s (nvcc s {secs})")
    for name, log in _build.build_log.items():
        report = ptxas_report(log)
        print(f"phase 2: ptxas {name} (registers, spill store and load "
              f"bytes): {report}")
        for k in NO_SPILLS if name == "poseidon" else ():
            if report.get(k, (0, 1, 1))[1:] != (0, 0):
                raise AssertionError(f"{k} spills (or is not in the ptxas "
                                     f"report): {report.get(k)}")
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", _build.library_path("poseidon")],
        capture_output=True, text=True, timeout=300, check=True).stdout
    per = k1_census(sass)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
    print(f"phase 2: SASS census per permutation, K1 (permute_kernel, the "
          f"perms loop's body): {sum(per.values())} instructions "
          f"(IMAD.WIDE.U32 {per.get('IMAD.WIDE.U32', 0)} + IMAD.HI.U32 "
          f"{per.get('IMAD.HI.U32', 0)}: the source's {K1_WORK[0]} wide "
          f"multiply-adds; IMAD {per.get('IMAD', 0)}: at least the source's "
          f"{K1_WORK[1]} 32-bit ones); top: {top}")
    sp = sparse_census(sass)
    top = sorted(sp.items(), key=lambda kv: -kv[1])[:12]
    print(f"phase 2: SASS census per permutation, sparse core "
          f"(hash2_kernel, two permutations halved): {sum(sp.values())} "
          f"instructions = {sum(sp.values()) / sum(per.values()):.4f} of "
          f"K1's, {sum(sp.values()) / SPARSE_MONT_PER_PERM:.1f} per "
          f"product (IMAD.WIDE.U32 {sp.get('IMAD.WIDE.U32', 0)} + "
          f"IMAD.HI.U32 {sp.get('IMAD.HI.U32', 0)}: the source's "
          f"{SPARSE_MONT_PER_PERM} x {WIDE_PER_MONT} wide multiply-adds, "
          f"less the products squares share, with the addressing; IMAD "
          f"{sp.get('IMAD', 0)}: at least the source's "
          f"{SPARSE_MONT_PER_PERM} x {NARROW_PER_MONT} 32-bit ones); top: "
          f"{top}")
    if sum(per.values()) >= sum(sp.values()):
        raise AssertionError("K1 runs no fewer instructions per permutation "
                             "than the hash kernels' sparse core")


# -- phase 3 / 3b: kernels vs plain ------------------------------------------

def phase_kernel_vs_plain(torch, pc, plain, field) -> dict:
    """Every Poseidon entry point against its plain version on CUDA tensors,
    with edge values in the first lanes: at the main paths' own widths
    (config 5's hash3 over its 2 * C5_K dirty leaves and hash2 over its
    C5_K low leaves, the depth-24 path's hash3 over 2K and hash2 over the
    K low leaves and the first slab level, the witness walk's 2K, the root
    decode) and at a ragged width."""
    rng = np.random.default_rng(SEED)
    cols = seeded_limbs(rng, max(PHASE3_WIDTHS))
    for i, v in enumerate(edge_values(field)):
        cols[:, i] = int_limbs(v)
    dev = torch.device("cuda")
    errs = {name: 0 for name in POSEIDON}
    for width in PHASE3_WIDTHS:
        L = [torch.as_tensor(np.roll(cols, s, axis=1)[:, :width], device=dev)
             for s in (0, 7, 101)]
        nodes = [plain.limbs_to_nodes(x) for x in L]   # valid nodes (< p)
        cases = {
            "limbs_to_nodes": (pc.limbs_to_nodes, plain.limbs_to_nodes,
                               (L[0],)),
            "nodes_to_limbs": (pc.nodes_to_limbs, plain.nodes_to_limbs,
                               (nodes[0],)),
            "hash2_nodes": (pc.hash2_nodes, plain.hash2_nodes,
                            (nodes[0], nodes[1])),
            "hash3_leaf": (pc.hash3_leaf, plain.hash3_leaf, tuple(L)),
            "permute_n": (lambda s: chains(pc.permute_n, s),
                          lambda s: chains(plain.permute_n, s),
                          (torch.stack(nodes),)),
        }
        for name, (kern, ref, args) in cases.items():
            got = kern(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            errs[name] = max(errs[name], err)
            if err != 0:
                raise AssertionError(
                    f"{name} width {width}: kernel differs from plain")
    for name, err in errs.items():
        chained = f" n_perms {K1_CHAINS}" if name == "permute_n" else ""
        print(f"phase 3: {name}{chained} widths "
              f"{', '.join(map(str, PHASE3_WIDTHS))}: kernel vs plain "
              f"max_abs_err {err} (tolerance 0, bit-exact)")

    z = torch.zeros((16, 1), dtype=torch.int32, device=dev)
    h = field.limbs_to_int(pc.nodes_to_limbs(pc.hash3_leaf(z, z, z))[:, 0]
                           .cpu())
    if h != ANCHOR_H000:
        raise AssertionError(f"H(0,0,0) = {h:#x}, expected {ANCHOR_H000:#x}")
    st012 = torch.stack([torch.as_tensor(field.int_to_node(v), device=dev)
                         [:, None] for v in (0, 1, 2)])
    out = pc.permute_n(st012, 1).cpu()
    got = [field.node_to_int(out[j, :, 0].numpy()) for j in range(3)]
    if got != TV_PERM_012:
        raise AssertionError("poseidonperm_x5_254_3 vector mismatch")
    print("phase 3: kernel reproduces H(0,0,0) = 0x0455a7...48e9 and the "
          "poseidonperm_x5_254_3 vector")
    return errs


def chains(permute_n, st):
    """permute_n over `st` at each chain length of K1_CHAINS, stacked."""
    import torch
    return torch.stack([permute_n(st, n) for n in K1_CHAINS])


def edge_values(field) -> list:
    """Values phase 3 puts in the first lanes: 0, 1, p - 1, p (which must
    reduce) and the largest 256-bit value."""
    return [0, 1, field.P - 1, field.P, (1 << 256) - 1]


def chunked(fn, args, chunk: int):
    """fn over the lanes (last axis) of `args`, `chunk` lanes per call."""
    import torch
    width = args[0].shape[-1]
    return torch.cat([fn(*(a[..., i:i + chunk].contiguous() for a in args))
                      for i in range(0, width, chunk)], dim=-1)


def phase_wide_kernel_vs_plain(torch, pc, plain, field) -> dict:
    """hash3 and hash2 at the widths of the resume's rebuild (phase 7),
    kernel against plain, bit for bit, with edge values in the first
    lanes; each kernel in one launch over the whole width."""
    rng = np.random.default_rng(SEED + 9)
    dev = torch.device("cuda")
    errs = {}
    for name, width in PHASE3_WIDE:
        cols = [seeded_limbs(rng, width) for _ in range(3)]
        for i, v in enumerate(edge_values(field)):
            cols[0][:, i] = int_limbs(v)
        L = [torch.as_tensor(c, device=dev) for c in cols]
        args = tuple(L) if name == "hash3_leaf" else tuple(
            chunked(plain.limbs_to_nodes, (x,), PLAIN_CHUNK) for x in L[:2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = getattr(pc, name)(*args)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = chunked(getattr(plain, name), args, PLAIN_CHUNK)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        errs[name] = max_abs_err(got, want)
        if errs[name] != 0:
            raise AssertionError(f"{name} width {width}: kernel differs "
                                 "from plain")
        print(f"phase 3: {name} width {width} (phase 7's rebuild): kernel "
              f"vs plain max_abs_err {errs[name]} (tolerance 0, bit-exact); "
              f"kernel {kernel_s} s in one launch (its first at this "
              f"width), plain {plain_s} s in {width // PLAIN_CHUNK} calls of "
              f"{PLAIN_CHUNK} lanes")
        del L, args, got, want
    torch.cuda.empty_cache()
    return errs


def phase_roofline_vs_plain(torch, vr, vc) -> dict:
    """Every probe body, kernel against plain, on the card: tolerance 0 (the
    f32 bodies round each op once in both, the integer bodies wrap)."""
    errs = {}
    for name in vr.BODIES:
        errs[name] = 0
        for rows, b, k in ((48, RAGGED, 64), (48, RAGGED, 1),
                           (PROBE_SHAPE[0], PROBE_SHAPE[1], 4)):
            x = vr.seeded_input(name, rows, b, seed=SEED)
            got = vc.roofline(name, x, k)
            want = vr.plain(name, x, k)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            errs[name] = max(errs[name], err)
            if err != 0 or not torch.equal(got, want):
                raise AssertionError(f"roofline {name} [{rows}, {b}] k={k}: "
                                     f"kernel differs from plain ({err})")
        print(f"phase 3b: roofline {name} [48, {RAGGED}] k=64 and k=1, "
              f"[{PROBE_SHAPE[0]}, {PROBE_SHAPE[1]}] k=4: kernel vs plain "
              f"max_abs_err {errs[name]} (tolerance 0, bit-exact)")
    return errs


# -- phase 4: the batched path -----------------------------------------------

def plant(rng, batch: np.ndarray, prev: np.ndarray | None) -> np.ndarray:
    """Plant intra-batch duplicates, zeros and earlier-batch duplicates."""
    b = batch.copy()
    k = b.shape[1]
    idx = rng.choice(k, size=96, replace=False)
    b[:, idx[:32]] = b[:, idx[32:64]]            # intra-batch duplicates
    b[:, idx[64:80]] = 0                         # zeros
    if prev is not None:                         # duplicates of earlier values
        b[:, idx[80:96]] = prev[:, rng.choice(prev.shape[1], 16)]
    return b


def host_accept(seen: set, values: list[int]) -> list[bool]:
    """Sequential set semantics: accept a nonzero value not seen before."""
    ok = []
    for v in values:
        ok.append(v != 0 and v not in seen)
        if ok[-1]:
            seen.add(v)
    return ok


def full_rebuild_root(field, indexed, tree) -> int:
    """The root of a tree rebuilt from the leaf state alone."""
    hashing = indexed.hashing
    leaves = hashing.hash3_leaf(tree.vals, tree.next_vals, tree.next_idxs)
    full = indexed._build_levels(leaves, tree.tree_depth)
    return field.limbs_to_int(hashing.dec_nodes(full[-1])[:, 0].cpu())


def planted_stream(field, seed: int, n: int, k: int) -> list:
    """n batches [16, k] of random values with planted duplicates, zeros
    and earlier-batch duplicates, from `seed`: phase 4's stream (SEED + 1)
    and config 5's (SEED + 6), which phase 8's ranks regenerate."""
    rng = np.random.default_rng(seed)
    batches, prev = [], None
    for _ in range(n):
        prev = plant(rng, field.random_limbs(int(rng.integers(1 << 31)), k,
                                             253), prev)
        batches.append(prev)
    return batches


def phase_slice(torch, pc, field, indexed, reference_oracle) -> dict:
    dev = torch.device("cuda")
    tree = indexed.IndexedMerkleTree(DEPTH)
    batches = planted_stream(field, SEED + 1, N_BATCHES, K)
    torch.cuda.synchronize()

    seen: set = set()
    times, oks = [], []
    pc.reset_launch_counts()
    for b in batches:
        t0 = time.perf_counter()
        ok = tree.insert_batch(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        oks.append(ok)
    root = tree.get_root_int()
    launches = dict(pc.LAUNCHES)
    print(f"phase 4: depth {DEPTH}, {N_BATCHES} batches of K={K}: launches "
          f"{launches}")
    check_launched("insert_batch", launches)

    for i, (b, ok) in enumerate(zip(batches, oks)):
        want = host_accept(seen, field.limbs_to_ints(b))
        if ok.tolist() != want:
            raise AssertionError(f"batch {i}: ok mask differs from set "
                                 "semantics")
    print(f"phase 4: ok masks equal set semantics ({len(seen)} accepted of "
          f"{N_BATCHES * K})")

    if full_rebuild_root(field, indexed, tree) != root:
        raise AssertionError("root differs from a full rebuild")
    print(f"phase 4: root equals a full rebuild of 2^{DEPTH} leaves "
          f"({root:#x})")

    used = tree.count + 1
    vals, nvs, nis = (field.limbs_to_ints(x[:, :used].cpu().numpy())
                      for x in (tree.vals, tree.next_vals, tree.next_idxs))
    walk, slot = [], 0
    while nvs[slot] != 0:
        nxt = nis[slot]
        if vals[nxt] != nvs[slot]:
            raise AssertionError(f"slot {slot}: next_val != val of next_idx")
        walk.append(vals[nxt])
        slot = nxt
    if walk != sorted(seen) or any(a >= b for a, b in zip(walk, walk[1:])):
        raise AssertionError("linked list is not the accepted values in "
                             "strictly increasing order")
    print(f"phase 4: list walk from slot 0 visits {len(walk)} accepted values "
          "in strictly increasing order")

    replay_small(indexed, reference_oracle, dev)
    print("phase 4: depth-6 replay (3 batches of K=8 with duplicates, zeros, "
          "chains) matches the python-int oracle after every batch")
    return {"launches": launches, "batch_s": times, "tree": tree,
            "seen": seen, "root": root}


def check_launched(path: str, launches: dict) -> None:
    for name, (_, paths) in POSEIDON.items():
        if path in paths and launches[name] == 0:
            raise AssertionError(f"the {path} path never launched {name}")


def replay_small(indexed, reference_oracle, dev, depth: int = 6) -> None:
    """Three K=8 batches (duplicates, zeros, chains) into a tree of `depth`
    (at least 5: 25 slots) on `dev`; after each, the ok mask and the root
    must equal the python-int oracle's.  The oracle's own planner
    (update_idx_leaf) keeps the reference's quirk of taking an empty slot
    as a low leaf, and rejected values leave empty slots behind; so the
    list rule is replayed here on python ints, and the oracle hashes the
    leaves and builds the tree."""
    small = indexed.IndexedMerkleTree(depth, device=dev)
    pre = [reference_oracle.Leaf(0, 0, 0) for _ in range(1 << depth)]
    seen6: set = set()
    slot = 0
    for vals6 in ([30, 10, 20, 5, 50, 35, 10, 0],
                  [31, 31, 0, 4, 36, 51, 2, 30],
                  [6, 7, 8, 9, 1, 5, 52, 3]):
        ok = small.insert_batch(vals6).tolist()
        want = host_accept(seen6, vals6)
        for v, accepted in zip(vals6, want):
            slot += 1                      # a rejected value consumes its slot
            if accepted:
                low = max((i for i, leaf in enumerate(pre)
                           if (i == 0 or leaf.val) and leaf.val < v),
                          key=lambda i: pre[i].val)
                pre[slot] = reference_oracle.Leaf(v, pre[low].next_val,
                                                  pre[low].next_idx)
                pre[low].next_val, pre[low].next_idx = v, slot
        oracle = reference_oracle.OracleTree(
            reference_oracle.hash_preimages(pre))
        if ok != want or small.get_root_int() != oracle.get_root():
            raise AssertionError("depth-6 replay differs from the oracle")


# -- phase 4b: the sequential witness path -----------------------------------

def golden_path(indexed, reference_oracle, field, dev,
                depth: int = 6) -> None:
    """[30, 10, 20, 5, 50, 35] through insert into a tree of `depth` (at
    least 3: 7 slots) on `dev`: after each insert, the root and every
    witness field must equal the python-int oracle's sequential insert
    (reference discipline)."""
    tree = indexed.IndexedMerkleTree(depth, device=dev)
    oracle = reference_oracle.OracleIndexedTree(depth)
    ints = lambda x: field.limbs_to_ints(x.cpu().numpy())
    for v in GOLDEN:
        w, o = tree.insert(v), oracle.insert(v)
        got = dict(
            ok=bool(w.ok[0]), old_root=ints(w.old_root)[0],
            low_leaf=(ints(w.low_leaf_val)[0], ints(w.low_leaf_next_val)[0],
                      ints(w.low_leaf_next_idx)[0]),
            low_leaf_proof=ints(w.low_leaf_proof[:, :, 0].T),
            low_leaf_proof_helper=w.low_leaf_proof_helper[:, 0].tolist(),
            new_root=ints(w.new_root)[0],
            new_leaf=(ints(w.new_leaf_val)[0], ints(w.new_leaf_next_val)[0],
                      ints(w.new_leaf_next_idx)[0]),
            new_leaf_index=int(w.new_leaf_index[0]),
            new_leaf_proof=ints(w.new_leaf_proof[:, :, 0].T),
            new_leaf_proof_helper=w.new_leaf_proof_helper[:, 0].tolist(),
            is_new_leaf_largest=bool(w.is_new_leaf_largest[0]))
        if got != o:
            bad = [key for key in o if got[key] != o[key]]
            raise AssertionError(f"golden path insert {v}: {bad} differ "
                                 "from the python-int oracle")
        if tree.get_root_int() != oracle.get_root():
            raise AssertionError(f"golden path insert {v}: root differs")


def phase_sequential(torch, pc, field, indexed, merkle, reference_oracle,
                     slice_out: dict, dev) -> dict:
    rng = np.random.default_rng(SEED + 3)
    tree, seen = slice_out["tree"], slice_out["seen"]
    present = sorted(seen)
    vals = [int(v) for v in field.limbs_to_ints(
        field.random_limbs(int(rng.integers(1 << 31)), SEQ_VALUES, 253))]
    for i in range(0, 8):                        # duplicates within the run
        vals[8 + i] = vals[i]
    for i in range(16, 20):                      # zeros
        vals[i] = 0
    for i in range(24, 32):                      # values already present
        vals[i] = present[int(rng.integers(len(present)))]
    root0 = tree.get_root_int()
    torch.cuda.synchronize()

    pc.reset_launch_counts()
    w = tree.insert_seq(vals)
    pred = indexed.insert_leaf(
        w.old_root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
        w.low_leaf_proof, w.low_leaf_proof_helper, w.new_root,
        w.new_leaf_val, w.new_leaf_next_val, w.new_leaf_next_idx,
        w.new_leaf_index, w.new_leaf_proof, w.new_leaf_proof_helper,
        w.is_new_leaf_largest).cpu().numpy()
    want = host_accept(seen, vals)
    if w.ok.tolist() != want:
        raise AssertionError("insert_seq ok mask differs from set semantics")
    if not pred[w.ok].all():
        raise AssertionError("an accepted insert_seq witness fails "
                             "insert_leaf")
    old = field.limbs_to_ints(w.old_root.cpu().numpy())
    new = field.limbs_to_ints(w.new_root.cpu().numpy())
    ok = w.ok.tolist()
    chain = [new[i] if ok[i] else old[i] for i in range(len(vals))]
    if old[0] != root0 or chain[:-1] != old[1:] or \
            chain[-1] != tree.get_root_int():
        raise AssertionError("insert_seq roots do not chain")
    seq_root = tree.get_root_int()
    print(f"phase 4b: insert_seq of {len(vals)} values at depth {DEPTH}: ok "
          f"mask equals set semantics ({sum(ok)} accepted), every accepted "
          "witness passes insert_leaf, new_root[i] = old_root[i+1] on "
          "accepted lanes")

    absent = field.random_limbs(int(rng.integers(1 << 31)), QUERIES // 2, 253)
    pres = field.ints_to_limbs([present[int(i)] for i in rng.choice(
        len(present), QUERIES // 2, replace=False)])
    queries = np.concatenate([pres, absent], axis=1)
    nw = tree.non_inclusion_witness(queries)
    is_absent = [v not in seen for v in field.limbs_to_ints(queries)]
    if nw.ok.tolist() != is_absent:
        raise AssertionError("non_inclusion_witness ok differs from absence")
    q = torch.as_tensor(queries, device=dev)
    args = [nw.root, nw.low_leaf_val, nw.low_leaf_next_val,
            nw.low_leaf_next_idx, nw.low_leaf_proof, nw.low_leaf_proof_helper,
            q, nw.is_new_leaf_largest]
    honest = indexed.verify_non_inclusion(*args).cpu().numpy()
    bad_proof = nw.low_leaf_proof.clone()
    bad_proof[3, 0] ^= 1
    args[4] = bad_proof
    flipped = indexed.verify_non_inclusion(*args).cpu().numpy()
    if not honest[nw.ok].all() or flipped[nw.ok].any():
        raise AssertionError("verify_non_inclusion: honest witness rejected "
                             "or flipped sibling accepted")
    print(f"phase 4b: non_inclusion_witness of {QUERIES} queries: ok equals "
          f"absence ({int(nw.ok.sum())} absent), verify_non_inclusion true on "
          "every ok lane and false on each once a proof sibling is flipped")

    leaves = seeded_limbs(rng, MERKLE_LEAVES, 253)
    mt = merkle.MerkleTree.build(leaves, dev)
    idx = rng.choice(MERKLE_LEAVES, 64, replace=False)
    proofs, _ = mt.get_proofs(idx)
    good = mt.verify_proofs(leaves[:, idx], idx, mt.get_root(), proofs)
    bad = proofs.clone()
    bad[5, 2, 7] ^= 1
    corrupted = mt.verify_proofs(leaves[:, idx], idx, mt.get_root(), bad)
    if not good.all() or corrupted[7] or not corrupted[np.arange(64) != 7] \
            .all():
        raise AssertionError("MerkleTree proofs: a good proof fails or the "
                             "corrupted one verifies")
    print(f"phase 4b: MerkleTree.build of {MERKLE_LEAVES} leaves: 64 proofs "
          f"verify, the corrupted one fails (root {mt.get_root_int():#x})")

    golden_path(indexed, reference_oracle, field, dev)
    launches = dict(pc.LAUNCHES)
    print(f"phase 4b: depth-6 golden path {GOLDEN} through insert: roots and "
          f"every witness field equal the python-int oracle's; launches "
          f"{launches}")
    check_launched("sequential", launches)
    if full_rebuild_root(field, indexed, tree) != seq_root:
        raise AssertionError("insert_seq root differs from a full rebuild")
    print(f"phase 4b: the root after insert_seq equals a full rebuild of "
          f"2^{DEPTH} leaves ({seq_root:#x})")
    return {"launches": launches}


# -- phase 6: the sparse tree and the witness batches ------------------------

def set_semantics(stream: np.ndarray) -> np.ndarray:
    """bool[N]: sequential set semantics over the values [16, N] in stream
    order, on numpy rows: a value is accepted iff it is nonzero and its
    first occurrence."""
    rows = np.ascontiguousarray(stream.T.astype(np.int32))
    keys = rows.view(np.dtype((np.void, rows.shape[1] * 4))).ravel()
    ok = np.zeros(rows.shape[0], dtype=bool)
    ok[np.unique(keys, return_index=True)[1]] = True
    return ok & rows.any(axis=1)


def lex_order(cols: np.ndarray) -> np.ndarray:
    """The columns of limbs [16, N] sorted by value (most significant limb
    the primary key)."""
    return np.lexsort(cols.astype(np.int64))


def strictly_increasing(cols: np.ndarray) -> bool:
    """Whether the values [16, N] (limb 0 least significant) strictly
    increase from column to column."""
    c = cols.astype(np.int64)
    lt, eq = np.zeros(c.shape[1] - 1, bool), np.ones(c.shape[1] - 1, bool)
    for limb in range(c.shape[0] - 1, -1, -1):
        lt |= eq & (c[limb, :-1] < c[limb, 1:])
        eq &= c[limb, :-1] == c[limb, 1:]
    return bool(lt.all())


def list_walk(vals: np.ndarray, nvs: np.ndarray, nis: np.ndarray):
    """The linked list from slot 0: the slots it visits, in order.  Raises
    unless each slot's next_val is the value of its next_idx and the values
    strictly increase."""
    nxt = (nis[0].astype(np.int64) | (nis[1].astype(np.int64) << 16)) \
        .tolist()
    more = nvs.any(axis=0).tolist()
    order, slot = [], 0
    while more[slot]:
        slot = nxt[slot]
        order.append(slot)
        if len(order) > len(nxt):
            raise AssertionError("the linked list has a cycle")
    order = np.asarray(order, dtype=np.int64)
    prev = np.concatenate([[0], order[:-1]]).astype(np.int64)
    if not np.array_equal(nvs[:, prev], vals[:, order]):
        raise AssertionError("a next_val differs from the value of its "
                             "next_idx")
    if order.size and not strictly_increasing(
            np.concatenate([np.zeros((16, 1), vals.dtype), vals[:, order]],
                           axis=1)):
        raise AssertionError("the linked list is not in increasing order")
    return order


def zero_roots(depth: int) -> list:
    """Python-int root of an all-empty subtree of each height 0..depth."""
    from imt_tpu_torch.ops.poseidon_ref import hash_fixed
    from imt_tpu_torch.ops.poseidon_spec import default_params
    params = default_params()
    z = [ANCHOR_H000]
    for _ in range(depth):
        z.append(hash_fixed([z[-1], z[-1]], params))
    return z


def fold_int(root: int, depth: int, full_depth: int) -> int:
    """A depth-`depth` root folded, with python ints, over the zero
    subtrees of the levels up to `full_depth`."""
    from imt_tpu_torch.ops.poseidon_ref import hash_fixed
    from imt_tpu_torch.ops.poseidon_spec import default_params
    params, z = default_params(), zero_roots(full_depth)
    for d in range(depth, full_depth):
        root = hash_fixed([root, z[d]], params)
    return root


def check_root_chain(field, w, before: int, after: int) -> None:
    """A witness batch's roots chain: lane 0 starts from the root before
    the batch, each lane from the one before it, and the last lane ends at
    the root after."""
    old = field.limbs_to_ints(w.old_root.cpu().numpy())
    new = field.limbs_to_ints(w.new_root.cpu().numpy())
    if old[0] != before or old[1:] != new[:-1] or new[-1] != after:
        raise AssertionError("the witness batch's roots do not chain")


def root_int(field, indexed, tree, prefix_root) -> int:
    """`tree`'s full-depth root, as get_root_int gives it, from the root
    node of its active prefix."""
    return field.limbs_to_int(indexed.hashing.dec_nodes(indexed._spine_fold(
        prefix_root, tree.active_depth, tree.tree_depth))[:, 0].cpu())


def check_insert_leaf(indexed, w) -> None:
    """Every accepted lane passes insert_leaf in one batched call, and none
    does once a low-leaf proof sibling is flipped."""
    args = [w.old_root, w.low_leaf_val, w.low_leaf_next_val,
            w.low_leaf_next_idx, w.low_leaf_proof, w.low_leaf_proof_helper,
            w.new_root, w.new_leaf_val, w.new_leaf_next_val,
            w.new_leaf_next_idx, w.new_leaf_index, w.new_leaf_proof,
            w.new_leaf_proof_helper, w.is_new_leaf_largest]
    honest = indexed.insert_leaf(*args).cpu().numpy()
    args[4] = w.low_leaf_proof.clone()
    args[4][args[4].shape[0] // 2, 0] ^= 1
    flipped = indexed.insert_leaf(*args).cpu().numpy()
    if not honest[w.ok].all() or flipped[w.ok].any():
        raise AssertionError("insert_leaf: an accepted witness fails or a "
                             "flipped sibling passes")


def same_state(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(
        [a.vals, a.next_vals, a.next_idxs] + a.levels,
        [b.vals, b.next_vals, b.next_idxs] + b.levels))


def phase_sparse(torch, pc, field, indexed, sparse, checkpoint, dev,
                 snap_dir: str) -> dict:
    """Config 5's shape: a depth-32 sparse tree with 2^21 slots held, 16
    batches of K = 65536 through insert_batches in groups of 8; the tree
    is then checkpointed into `snap_dir` for phase 7."""
    batches = planted_stream(field, SEED + 6, C5_BATCHES, C5_K)
    groups = [np.stack(batches[i:i + C5_GROUP])
              for i in range(0, C5_BATCHES, C5_GROUP)]
    tree = sparse.SparseIndexedMerkleTree(
        C5_DEPTH, initial_capacity_log2=C5_CAPACITY, device=dev)
    groups = [torch.as_tensor(g, device=dev) for g in groups]
    torch.cuda.synchronize()
    pc.reset_launch_counts()
    oks, group_s = [], []
    for g in groups:
        t0 = time.perf_counter()
        oks.append(tree.insert_batches(g))
        torch.cuda.synchronize()
        group_s.append(time.perf_counter() - t0)
    launches = dict(pc.LAUNCHES)
    print(f"phase 6: depth {C5_DEPTH}, 2^{C5_CAPACITY} slots held, "
          f"{C5_BATCHES} batches of K={C5_K} in groups of {C5_GROUP} "
          f"(insert_batches): launches {launches}")
    check_launched("sparse_batches", launches)
    if tree.active_depth != C5_CAPACITY:
        raise AssertionError("the config-5 tree grew inside the run")

    stream = np.concatenate(batches, axis=1)
    want = set_semantics(stream)
    got = np.concatenate([o.reshape(-1) for o in oks])
    if not np.array_equal(got, want):
        raise AssertionError("config 5: ok masks differ from set semantics")
    print(f"phase 6: ok masks equal set semantics ({int(want.sum())} "
          f"accepted of {stream.shape[1]})")

    root = tree.get_root_int()
    dense = indexed.IndexedMerkleTree(C5_DENSE_DEPTH, device=dev)
    dense_ok = np.stack([dense.insert_batch(b) for b in batches])
    if not np.array_equal(dense_ok.reshape(-1), got):
        raise AssertionError("config 5: the dense twin's ok masks differ")
    via_dense = fold_int(dense.get_root_int(), C5_DENSE_DEPTH, C5_DEPTH)
    del dense
    leaves = indexed.hashing.hash3_leaf(tree.vals, tree.next_vals,
                                        tree.next_idxs)
    prefix = indexed._build_levels(leaves, tree.active_depth)[-1]
    via_rebuild = fold_int(field.limbs_to_int(
        indexed.hashing.dec_nodes(prefix)[:, 0].cpu()), tree.active_depth,
        C5_DEPTH)
    del leaves, prefix
    if not root == via_dense == via_rebuild:
        raise AssertionError("config 5: the sparse root differs from the "
                             "dense twin's or the rebuilt prefix's, folded "
                             "over the zero spine")
    print(f"phase 6: the depth-{C5_DEPTH} root equals the dense "
          f"depth-{C5_DENSE_DEPTH} twin's root and a rebuild of the "
          f"2^{C5_CAPACITY}-slot prefix, each folded over the zero spine "
          f"with python ints ({root:#x})")

    used = tree.count + 1
    vals, nvs, nis = (x[:, :used].cpu().numpy()
                      for x in (tree.vals, tree.next_vals, tree.next_idxs))
    order = list_walk(vals, nvs, nis)
    accepted = stream[:, want]
    if not np.array_equal(vals[:, order],
                          accepted[:, lex_order(accepted)]):
        raise AssertionError("config 5: the list is not the accepted values")
    print(f"phase 6: list walk from slot 0 visits the {order.size} accepted "
          "values in strictly increasing order")
    path = os.path.join(snap_dir, "config5.npz")
    t0 = time.perf_counter()
    checkpoint.save(tree, path)
    save_s = time.perf_counter() - t0
    count = tree.count
    del tree
    torch.cuda.empty_cache()
    print(f"phase 6: checkpoint.save of the config-5 tree: {save_s} s, "
          f"{os.path.getsize(path)} bytes on disk (2^{C5_CAPACITY} slots, "
          f"{3 * 16 * 4 << C5_CAPACITY} bytes of limbs)")
    return {"launches": launches, "group_s": group_s, "snapshot": path,
            "root": root, "count": count, "save_s": save_s,
            "stream": stream, "oks": got}


def phase_witness(torch, pc, field, indexed, sparse, dev) -> dict:
    """Config 3w's shape: witness batches of K = 4096 into a depth-16
    sparse tree (2^16 slots held, as bench.py sizes it), then one into a
    depth-32 tree grown from the default 2^10 slots; checked against
    insert_leaf, the root chain, a twin through insert_batch, and a
    K = 256 witness batch against insert_seq."""
    rng = np.random.default_rng(SEED + 7)
    batches, prev = [], None
    for _ in range(W_BATCHES + 1):
        b = plant(rng, field.random_limbs(int(rng.integers(1 << 31)), W_K,
                                          253), prev)
        batches.append(torch.as_tensor(b, device=dev))
        prev = b
    tree = sparse.SparseIndexedMerkleTree(
        W_DEPTH, initial_capacity_log2=W_DEPTH, device=dev)
    deep = sparse.SparseIndexedMerkleTree(32, device=dev)
    roots = [tree.get_root_int()]
    deep_root0 = deep.get_root_int()
    torch.cuda.synchronize()
    # the roots after each batch are kept as the prefix's root nodes (a
    # copy, no kernel) and decoded once the counts are read
    pc.reset_launch_counts()
    ws, batch_s, prefix_roots = [], [], []
    for b in batches[:W_BATCHES]:
        t0 = time.perf_counter()
        ws.append(tree.insert_batch(b, witness=True))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        prefix_roots.append(tree.levels[-1].clone())
    t0 = time.perf_counter()
    wd = deep.insert_batch(batches[W_BATCHES], witness=True)
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    launches = dict(pc.LAUNCHES)
    roots += [root_int(field, indexed, tree, r) for r in prefix_roots]
    print(f"phase 6: depth {W_DEPTH}, {W_BATCHES} witness batches of K={W_K}, "
          f"then one at depth 32: launches {launches}")
    check_launched("witness_batch", launches)
    if deep.active_depth != (W_K + 1).bit_length():
        raise AssertionError("the depth-32 tree did not grow to fit")

    seen: set = set()
    twin = sparse.SparseIndexedMerkleTree(
        W_DEPTH, initial_capacity_log2=W_DEPTH, device=dev)
    for i, (b, w) in enumerate(zip(batches, ws)):
        if w.ok.tolist() != host_accept(seen, field.limbs_to_ints(
                b.cpu().numpy())):
            raise AssertionError(f"witness batch {i}: ok differs from set "
                                 "semantics")
        if not np.array_equal(twin.insert_batch(b), w.ok):
            raise AssertionError(f"witness batch {i}: the twin's ok differs")
        check_insert_leaf(indexed, w)
        check_root_chain(field, w, roots[i], roots[i + 1])
    if not same_state(tree, twin):
        raise AssertionError("the witness batches' state differs from the "
                             "twin's through insert_batch")
    if wd.ok.tolist() != host_accept(set(), field.limbs_to_ints(
            batches[W_BATCHES].cpu().numpy())):
        raise AssertionError("depth-32 witness batch: ok differs from set "
                             "semantics")
    check_insert_leaf(indexed, wd)
    check_root_chain(field, wd, deep_root0, deep.get_root_int())
    if wd.low_leaf_proof.shape[0] != deep.tree_depth or not wd.ok.any():
        raise AssertionError("the depth-32 witness batch is not full depth")
    print(f"phase 6: every accepted lane of the {W_BATCHES + 1} witness "
          "batches passes insert_leaf in one call per batch (none once a "
          "sibling is flipped), the roots chain from the root before each "
          "batch to get_root() after it, ok equals set semantics, and the "
          "state equals a twin's through insert_batch(witness=False)")

    # K = 256 against insert_seq, on the depth-32 tree's state
    seq_twin = sparse.SparseIndexedMerkleTree.from_arrays(deep.to_arrays(),
                                                          device=dev)
    present = field.limbs_to_ints(batches[W_BATCHES][:, :8].cpu().numpy())
    vals = field.limbs_to_ints(field.random_limbs(
        int(rng.integers(1 << 31)), W_SEQ, 253))
    vals[8:16] = vals[:8]                        # duplicates within
    vals[16:20] = [0] * 4                        # zeros
    vals[24:32] = present                        # present values
    wb = deep.insert_batch(vals, witness=True)
    wseq = seq_twin.insert_seq(vals)
    if wb.ok.tolist() != wseq.ok.tolist():
        raise AssertionError("K=256: ok differs from insert_seq's")
    acc = torch.as_tensor(wb.ok, device=dev)
    for name in list(indexed.InsertWitness.__dataclass_fields__)[1:]:
        a, b = getattr(wb, name), getattr(wseq, name)
        if a.shape != b.shape or not torch.equal(a[..., acc], b[..., acc]):
            raise AssertionError(f"K=256: {name} differs from insert_seq's "
                                 "on an accepted lane")
    if not same_state(deep, seq_twin):
        raise AssertionError("K=256: the state differs from insert_seq's")
    print(f"phase 6: a K={W_SEQ} witness batch at depth 32 equals insert_seq "
          f"field by field on its {int(wb.ok.sum())} accepted lanes, and the "
          "states agree")
    return {"launches": launches, "batch_s": batch_s, "deep_s": deep_s}


# -- phase 7: operations ----------------------------------------------------

def resume_launches(active_depth: int, full_depth: int) -> tuple:
    """The launches of a resume, then of the root read after it: the load
    rebuilds with one hash3 over the held slots and one hash2 per level of
    the active prefix; the root read folds the prefix root over the zero
    spine (one hash2 per level above the prefix) and decodes it."""
    return ({"hash3_leaf": 1, "hash2_nodes": active_depth},
            {"hash2_nodes": full_depth - active_depth, "nodes_to_limbs": 1})


def launched(pc, since: dict | None = None) -> dict:
    """The entry points launched (nonzero counts), since `since`."""
    since = since or {}
    return {k: v - since.get(k, 0) for k, v in pc.LAUNCHES.items()
            if v - since.get(k, 0)}


def group_semantics(prior: np.ndarray, group: np.ndarray) -> np.ndarray:
    """bool[B, K]: set semantics of the batches `group` [B, 16, K] inserted
    after the stream `prior` [16, N]."""
    b, _, k = group.shape
    stream = np.concatenate([prior, *group], axis=1)
    return set_semantics(stream)[prior.shape[1]:].reshape(b, k)


def trace_kernels(path: str, symbol: str) -> list:
    """The kernel events of a Chrome trace that name `symbol`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") == "kernel" and symbol in e.get("name", "")]


def tool(name: str):
    """tools/<name>.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_operations(torch, pc, field, indexed, sparse_out: dict, dev,
                     work_dir: str) -> dict:
    """The operations layer at config 5's scale: resume phase 6's snapshot,
    audit it and catch a flipped bit, insert one more pipelined group under
    the watchdog and the profiler, then the kill-resume drill and the soak
    on the card."""
    from imt_tpu_torch.utils import checkpoint, observability
    from imt_tpu_torch.utils.health import (TreeCorruption, Watchdog,
                                            check_tree)
    from imt_tpu_torch.utils.observability import GLOBAL_METRICS
    t_phase = time.perf_counter()
    path, launches, out = sparse_out["snapshot"], {}, {}

    # -- resume: the snapshot back on the card, to phase 6's root and count
    torch.cuda.synchronize()
    pc.reset_launch_counts()
    t0 = time.perf_counter()
    resumed = checkpoint.load(path, device=dev)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    load_counts = launched(pc)
    root = resumed.get_root_int()
    root_counts = launched(pc, load_counts)
    launches["resume"] = dict(pc.LAUNCHES)
    check_launched("resume", launches["resume"])
    if (root, resumed.count, resumed.active_depth) != (
            sparse_out["root"], sparse_out["count"], C5_CAPACITY):
        raise AssertionError("the resumed tree differs from phase 6's")
    if (load_counts, root_counts) != resume_launches(resumed.active_depth,
                                                     resumed.tree_depth):
        raise AssertionError(f"resume launches {load_counts} then "
                             f"{root_counts}")
    print(f"phase 7: checkpoint.load of the config-5 snapshot "
          f"({os.path.getsize(path)} bytes): {out['load_s']} s, root "
          f"{root:#x} and count {resumed.count} equal phase 6's; launches: "
          f"the load {load_counts}, the root read after it {root_counts} "
          f"(the resume path's count includes both)")
    # the load's steps, apart: np.load, the dtype cast and host-to-device
    # copy of the three limb arrays, the rebuild of the levels
    t0 = time.perf_counter()
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    np_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [np.ascontiguousarray(arrays[k], dtype=np.int64).astype(np.int32)
            for k in ("vals", "next_vals", "next_idxs")]
    cast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = [torch.as_tensor(h, device=dev) for h in host]
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    levels = indexed._build_levels(indexed.hashing.hash3_leaf(*state),
                                   resumed.active_depth)
    torch.cuda.synchronize()
    out["rebuild_s"] = time.perf_counter() - t0
    if not all(torch.equal(x, y) for x, y in zip(
            state + levels, [resumed.vals, resumed.next_vals,
                             resumed.next_idxs] + resumed.levels)):
        raise AssertionError("the load's steps, apart, give another state")
    del arrays, host, state, levels
    print(f"phase 7: the load apart: np.load {np_s} s, int64/int32 cast "
          f"{cast_s} s, host-to-device copy {copy_s} s, rebuild (hash3 over "
          f"2^{C5_CAPACITY} leaves, {C5_CAPACITY} hash2 levels) "
          f"{out['rebuild_s']} s")

    # -- audit: clean, then a flipped bit of an occupied slot's value
    t0 = time.perf_counter()
    report = check_tree(resumed, sample=AUDIT_SAMPLE)
    out["audit_s"] = time.perf_counter() - t0
    if not report.ok or len(report.checked_slots) != AUDIT_SAMPLE + 1:
        raise AssertionError("the audit of the resumed tree failed")
    slot = next(s for s in report.checked_slots[1:]
                if resumed.get_leaf_ints(s)[0])
    resumed.vals[0, slot] ^= 1
    try:
        check_tree(resumed, sample=AUDIT_SAMPLE)
    except TreeCorruption as e:
        caught = str(e)
    else:
        raise AssertionError("the audit missed a flipped bit")
    finally:
        resumed.vals[0, slot] ^= 1
    if f"({slot}, 'path'" not in caught:
        raise AssertionError(f"the audit did not name slot {slot}'s path: "
                             f"{caught[:200]}")
    print(f"phase 7: check_tree(sample={AUDIT_SAMPLE}) of the resumed tree "
          f"passes in {out['audit_s']} s ({AUDIT_SAMPLE + 1} slots, "
          f"{resumed.tree_depth + 1} python-int hashes each); with one bit "
          f"of slot {slot}'s value "
          "flipped it raises TreeCorruption naming that slot's path")

    # -- one more group, pipelined, under the watchdog and the profiler
    rng = np.random.default_rng(SEED + 8)
    prev, batches = sparse_out["stream"][:, -C5_K:], []
    for _ in range(C5_GROUP):
        prev = plant(rng, field.random_limbs(int(rng.integers(1 << 31)),
                                             C5_K, 253), prev)
        batches.append(prev)
    group = np.stack(batches)
    want = group_semantics(sparse_out["stream"], group)
    twin = checkpoint.load(path, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin_ok = twin.insert_batches(group)
    torch.cuda.synchronize()
    out["twin_group_s"] = time.perf_counter() - t0

    wd = Watchdog(resumed, interval=WD_INTERVAL, sample=WD_SAMPLE)
    trace_dir = os.path.join(work_dir, "trace")
    submitted = GLOBAL_METRICS.inserts_submitted
    pc.reset_launch_counts()
    t_trace = time.perf_counter()
    with observability.trace("config5_group", trace_dir=trace_dir):
        # the profiler has started; a wait for the card inside the call
        # raises
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ok = wd.insert_batches(group, as_numpy=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["queued_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["group_s"] = time.perf_counter() - t0
    out["trace_s"] = time.perf_counter() - t_trace
    group_counts = launched(pc)
    if not (isinstance(ok, torch.Tensor) and ok.device.type == dev.type
            and ok.dtype == torch.bool and ok.shape == want.shape):
        raise AssertionError("as_numpy=False did not leave ok on the card")
    if GLOBAL_METRICS.inserts_submitted - submitted != group.shape[0] * C5_K:
        raise AssertionError("inserts_submitted did not count the group")
    got = ok.cpu().numpy()
    if not np.array_equal(got, want) or not np.array_equal(twin_ok, got):
        raise AssertionError("the group's ok differs from set semantics or "
                             "from the as_numpy=True twin's")
    if not same_state(twin, resumed):
        raise AssertionError("the group's state differs from the twin's")
    del twin
    torch.cuda.empty_cache()
    files = glob.glob(os.path.join(trace_dir, "config5_group.*.json"))
    if len(files) != 1:
        raise AssertionError(f"the trace wrote {files}")
    kern = trace_kernels(files[0], HASH2_SYMBOL)
    if not kern:
        raise AssertionError(f"the trace names no {HASH2_SYMBOL} kernel")
    print(f"phase 7: one group of {C5_GROUP} x K={C5_K} through "
          f"Watchdog(interval={WD_INTERVAL}).insert_batches(as_numpy=False) "
          f"under trace and with the card's sync debug mode at 'error': "
          f"queued in {out['queued_s']} s, done in {out['group_s']} s "
          f"(profiled; the trace's start and export included, "
          f"{out['trace_s']} s); an as_numpy=True group on a twin loaded "
          f"from the snapshot, before it: {out['twin_group_s']} s (not "
          f"profiled); ok is a tensor "
          f"on {ok.device} equal to set semantics ({int(got.sum())} accepted) and "
          f"to the twin's, the states agree, inserts_submitted "
          f"+{group.shape[0] * C5_K}; launches {group_counts}; the trace "
          f"({os.path.getsize(files[0])} bytes) holds {len(kern)} "
          f"{HASH2_SYMBOL} kernel events, "
          f"{sum(e.get('dur', 0) for e in kern) / 1e3} ms of device time")

    # the watchdog's cadence: it audits on the 8th mutating call, not before
    if wd._audits != 0:
        raise AssertionError("the watchdog audited before its cadence")
    small = []
    for _ in range(WD_INTERVAL - 1):
        if wd._audits:
            raise AssertionError("the watchdog audited before its cadence")
        small.append(wd.insert_batch(field.random_limbs(
            int(rng.integers(1 << 31)), WD_SMALL_K, 253), as_numpy=False))
    if wd._audits != 1 or not bool(torch.stack(small).all()):
        raise AssertionError("the watchdog did not audit on its 8th call")
    launches["watchdog_group"] = dict(pc.LAUNCHES)
    check_launched("watchdog_group", launches["watchdog_group"])
    print(f"phase 7: {WD_INTERVAL - 1} more insert_batch(as_numpy=False) "
          f"calls of K={WD_SMALL_K}: the watchdog audited once, on the "
          f"{WD_INTERVAL}th call (sample {WD_SAMPLE}); the path's launches "
          f"{launched(pc)}")
    del wd, resumed
    torch.cuda.empty_cache()

    # -- the kill-resume drill on the card
    drill_dir = os.path.join(work_dir, "drill")
    os.makedirs(drill_dir)
    pc.reset_launch_counts()
    drill = tool("soak_indexed_torch").kill_resume(drill_dir, dev.type,
                                                   **DRILL)
    launches["drill"] = dict(pc.LAUNCHES)
    check_launched("drill", launches["drill"])
    out["drill"] = drill
    print(f"phase 7: kill-resume drill (EngineConfig(tree_depth=32, "
          f"initial_capacity_log2=10), {DRILL['n_batches']} batches of "
          f"K={DRILL['k']}): worker killed after {drill['batches_done']} "
          f"checkpointed batches, {drill['kill_s']} s after its start; "
          f"resumed and replayed in {drill['resume_s']} s to the "
          f"uninterrupted worker's root {drill['root']:#x} and count "
          f"{drill['count']}; neither worker built a kernel; launches "
          f"{launched(pc)}")

    # -- the soak on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, os.path.join(HERE, "tools", "soak_indexed_torch.py"),
         "--device", dev.type, *SOAK_ARGS], capture_output=True, text=True,
        timeout=900, cwd=HERE, env=env)
    out["soak_s"] = time.perf_counter() - t0
    if run.returncode != 0 or "SOAK PASSED" not in run.stdout:
        raise AssertionError(f"the soak failed ({run.returncode}): "
                             f"{run.stderr[-3000:]}")
    print(f"phase 7: tools/soak_indexed_torch.py --device {dev.type} "
          f"{' '.join(SOAK_ARGS)}: {run.stdout.strip().splitlines()[-1]} "
          f"({out['soak_s']} s with its start)")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 7: done in {out['phase_s']:.1f} s")
    return {"launches": launches, **out}


# -- phase 8: the sharded path ------------------------------------------------

def _rank_main(rank: int, target: str, world: int, work_dir: str,
               timeout: float, kwargs: dict) -> None:
    """One rank of ``start_ranks``: it joins the gloo group through a
    file:// store in `work_dir` (no network) with the group timeout
    `timeout`, runs the function `target` ("file.py:name") as
    name(rank=, world=, **kwargs) and pickles what it returns into
    `work_dir`."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    path, name = target.rsplit(":", 1)
    spec = importlib.util.spec_from_file_location("_rank_target", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work_dir, "store"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = getattr(mod, name)(rank=rank, world=world, **kwargs)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Ranks:
    """The gloo ranks ``start_ranks`` started; ``wait`` collects."""

    def __init__(self, context, work_dir: str, timeout: float):
        self.context, self.work_dir, self.timeout = context, work_dir, timeout
        self.deadline = time.monotonic() + timeout

    def kill(self) -> None:
        for p in self.context.processes:
            if p.is_alive():
                p.kill()
            p.join()

    def wait(self) -> list:
        """What the target returned on ranks 0 .. world-1.  Ranks that
        fail raise RuntimeError here, with the traceback of each failed
        rank (the first to fail may not be the first seen); ranks still
        running at the deadline raise TimeoutError; either way every rank
        is stopped."""
        import pickle

        import torch.multiprocessing as mp
        try:
            while not self.context.join(
                    max(self.deadline - time.monotonic(), 0)):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(f"the ranks ran past {self.timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            self.kill()
            errors = []
            for rank, path in enumerate(self.context.error_files):
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        errors.append(f"rank {rank}: {pickle.load(f)}")
            raise RuntimeError("ranks failed:\n" + "\n".join(errors)) from e
        finally:
            self.kill()
        out = []
        for rank in range(len(self.context.processes)):
            with open(os.path.join(self.work_dir, f"rank{rank}.pkl"),
                      "rb") as f:
                out.append(pickle.load(f))
        return out


def start_ranks(target: str, world: int, kwargs: dict, work_dir: str,
                timeout: float) -> Ranks:
    """Start `world` gloo ranks of this host, SPMD, each a fresh process
    (torch.multiprocessing's spawn) running ``_rank_main``, and return at
    once: the caller may work meanwhile, then ``Ranks.wait``."""
    import torch.multiprocessing as mp
    os.makedirs(work_dir, exist_ok=True)
    store = os.path.join(work_dir, "store")
    if os.path.exists(store):
        os.unlink(store)
    context = mp.start_processes(
        _rank_main, args=(target, world, work_dir, timeout, kwargs),
        nprocs=world, join=False, start_method="spawn")
    return Ranks(context, work_dir, timeout)


def phase_nccl_one(torch, pc, field, slice_out: dict, dev, work_dir: str):
    """8a: NCCL at world size 1 on the card.  A ShardedIndexedMerkleTree at
    phase 4's shape takes the plain step (no shard-local program may run,
    as tests/test_parallel.py:146 holds) and reaches phase 4's root; then
    sharded_tree_root of 2^16 leaves over NCCL, device transport, equals
    MerkleTree.build's root."""
    import datetime
    from unittest import mock

    import torch.distributed as dist

    from imt_tpu_torch.parallel import collectives, local_plan, sharded
    from imt_tpu_torch.tree.merkle import MerkleTree
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(work_dir, "nccl_store"),
        world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    try:
        mesh = sharded.make_mesh(device_type="cuda")
        transport = collectives.transport(mesh.get_group())
        tree = sharded.ShardedIndexedMerkleTree(DEPTH, mesh, sparse=False,
                                                device=dev)
        batches = planted_stream(field, SEED + 1, N_BATCHES, K)
        fail = mock.Mock(side_effect=AssertionError(
            "the shard-local planner ran on a 1-device mesh"))
        torch.cuda.synchronize()
        pc.reset_launch_counts()
        with mock.patch.multiple(local_plan, local_insert_batch=fail,
                                 local_insert_batches=fail,
                                 local_insert_batch_witness=fail,
                                 local_non_inclusion_witness=fail):
            for b in batches:
                tree.insert_batch(b)
        torch.cuda.synchronize()
        launches = dict(pc.LAUNCHES)
        check_launched("sharded_nccl1", launches)
        if tree.is_sharded or tree.get_root_int() != slice_out["root"]:
            raise AssertionError("8a: the 1-rank tree is sharded or its root "
                                 "differs from phase 4's")
        del tree
        leaves = seeded_limbs(np.random.default_rng(SEED + 10),
                              MERKLE_LEAVES, 253)
        top = sharded.sharded_tree_root(leaves, mesh, device=dev)[1]
        want = MerkleTree.build(leaves, dev).get_root_int()
        if field.limbs_to_int(top[:, -1].cpu()) != want:
            raise AssertionError("8a: sharded_tree_root over NCCL differs "
                                 "from MerkleTree.build")
        build_calls = list(collectives.CALLS["build"])
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"phase 8a: NCCL, world size 1, {transport} transport: a "
          f"ShardedIndexedMerkleTree({DEPTH}) took the plain step for "
          f"{N_BATCHES} batches of K={K} (no shard-local program ran) to "
          f"phase 4's root; launches {launches}; sharded_tree_root of "
          f"{MERKLE_LEAVES} leaves equals MerkleTree.build's root (NCCL "
          f"calls {build_calls})")
    return {"launches": launches}


def exchange_sizes(calls: list) -> list:
    """The bytes of each candidate exchange among a program's counted
    calls [(what, bytes)], in order."""
    return [b for what, b in calls if what == "candidates"]


def audit_sizes(calls: dict) -> dict:
    """Per program, what its calls carried and their bytes per call
    (sorted, distinct)."""
    return {p: sorted(set(c)) for p, c in sorted(calls.items())}


def sharded_rank(rank: int, world: int, snapshot: str, work_dir: str,
                 oks6: np.ndarray, root6: int, device: str) -> dict:
    """8b, one of four gloo ranks sharing cuda:0: config 5's stream
    (regenerated from phase 6's seed) through insert_batches in groups of
    8 on a depth-32 sparse tree holding 2^21 slots (2^19 per rank), then a
    witness batch and non-inclusion witnesses held against a twin loaded
    from phase 6's snapshot (rank 0), sharded_tree_root of 2^20 leaves, a
    sharded checkpoint's round trip, and a dense depth-24 batch of the
    same K whose candidate exchange must move what depth 32's does."""
    import torch
    import torch.distributed as dist

    from imt_tpu_torch.ops import field
    from imt_tpu_torch.ops import poseidon_cuda as pc
    from imt_tpu_torch.parallel import collectives, sharded
    from imt_tpu_torch.tree import indexed
    from imt_tpu_torch.tree.merkle import MerkleTree
    from imt_tpu_torch.utils import checkpoint
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = sharded.make_mesh(device_type=dev.type)
    group = mesh.get_group()
    out = {"transport": collectives.transport(group)}
    batches = planted_stream(field, SEED + 6, C5_BATCHES, C5_K)
    groups = [torch.as_tensor(np.stack(batches[i:i + C5_GROUP]), device=dev)
              for i in range(0, C5_BATCHES, C5_GROUP)]
    rng = np.random.default_rng(SEED + 11)
    accepted = np.concatenate(batches, axis=1)[:, oks6]
    wvals = plant(rng, field.random_limbs(int(rng.integers(1 << 31)), S_W_K,
                                          253), accepted[:, :S_W_K])
    queries = np.concatenate([accepted[:, rng.choice(
        accepted.shape[1], S_Q // 2, replace=False)], field.random_limbs(
        int(rng.integers(1 << 31)), S_Q // 2, 253)], axis=1)
    tree = sharded.ShardedIndexedMerkleTree(
        C5_DEPTH, mesh, sparse=True, initial_capacity_log2=C5_CAPACITY,
        device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    dist.barrier(group)

    # -- the main path, its launches counted from 0
    collectives.reset_counts()
    pc.reset_launch_counts()
    t0 = time.perf_counter()
    oks = []
    for g in groups:
        oks.append(tree.insert_batches(g))
        out.setdefault("group_s", []).append(time.perf_counter() - t0)
    dist.barrier(group)
    out["groups_s"] = time.perf_counter() - t0
    out["root"] = root = tree.get_root_int()
    nw = tree.non_inclusion_witness(queries)
    w = tree.insert_batch(wvals, witness=True)
    sync()
    out["launches"] = dict(pc.LAUNCHES)
    out["calls"] = {p: list(c) for p, c in collectives.CALLS.items()}
    out["path_s"] = time.perf_counter() - t0

    got = np.concatenate([o.reshape(-1) for o in oks])
    out["oks_equal"] = bool(np.array_equal(got, oks6))
    if not out["oks_equal"] or root != root6:
        raise AssertionError(f"rank {rank}: config 5's ok masks equal "
                             f"phase 6's: {out['oks_equal']}; root "
                             f"{root:#x}, phase 6's {root6:#x}")
    check_insert_leaf(indexed, w)
    out["w_accepted"] = int(w.ok.sum())
    out["ni_ok"] = int(nw.ok.sum())
    if rank == 0:
        twin = checkpoint.load(snapshot, device=dev)
        tnw = twin.non_inclusion_witness(queries)
        tw = twin.insert_batch(wvals, witness=True)
        for a, b, names in ((nw, tnw, indexed.NonInclusionWitness),
                            (w, tw, indexed.InsertWitness)):
            for name in names.__dataclass_fields__:
                x, y = getattr(a, name), getattr(b, name)
                x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
                y = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
                if x.shape != y.shape or not np.array_equal(x, y):
                    raise AssertionError(f"8b: {names.__name__}.{name} "
                                         "differs from the twin's")
        if twin.get_root_int() != tree.get_root_int():
            raise AssertionError("8b: the twin's root differs")
        del twin

    leaves = seeded_limbs(np.random.default_rng(SEED + 12), S_ROOT_LEAVES,
                          253)
    top = sharded.sharded_tree_root(leaves, mesh, device=dev)[1]
    out["root_leaves"] = field.limbs_to_int(top[:, -1].cpu())
    if rank == 0 and out["root_leaves"] != MerkleTree.build(
            leaves, dev).get_root_int():
        raise AssertionError("8b: sharded_tree_root differs from "
                             "MerkleTree.build")

    path = os.path.join(work_dir, "sharded.npz")
    t0 = time.perf_counter()
    checkpoint.save(tree, path)
    out["save_s"] = time.perf_counter() - t0
    count, root = tree.count, tree.get_root_int()
    del tree
    t0 = time.perf_counter()
    back = checkpoint.load(path, device=dev)
    out["load_s"] = time.perf_counter() - t0
    if (back.count, back.get_root_int(), back.is_sharded) != (
            count, root, True):
        raise AssertionError("8b: the sharded snapshot loads to another "
                             "tree")
    del back

    # the audit on the card: a dense depth-24 tree, one batch of C5_K
    dense = sharded.ShardedIndexedMerkleTree(S_AUDIT_DEPTH, mesh,
                                             sparse=False, device=dev)
    collectives.reset_counts()
    dense.insert_batch(batches[0])
    out["calls24"] = list(collectives.CALLS["insert_batch"])
    return out


def phase_sharded(torch, pc, field, sparse_out: dict, work_dir: str,
                  dev) -> dict:
    """8b: four gloo ranks on the one card (``sharded_rank``), each a
    process of its own (``start_ranks``) with a group timeout, joined with
    the same timeout; the kernels are built before any rank starts (phase
    2)."""
    t0 = time.perf_counter()
    ranks = start_ranks(
        f"{os.path.abspath(__file__)}:sharded_rank", SHARD_RANKS,
        dict(snapshot=sparse_out["snapshot"], work_dir=work_dir,
             oks6=sparse_out["oks"], root6=sparse_out["root"],
             device=str(dev)),
        os.path.join(work_dir, "ranks"), SHARD_TIMEOUT).wait()
    wall = time.perf_counter() - t0
    label = (f"{SHARD_RANKS} gloo ranks sharing one card, "
             f"{ranks[0]['transport']} transport")
    launches = {name: sum(r["launches"][name] for r in ranks)
                for name in ranks[0]["launches"]}
    for i, r in enumerate(ranks):
        print(f"phase 8b: rank {i} ({label}): hash2 launches "
              f"{r['launches']['hash2_nodes']}, hash3 "
              f"{r['launches']['hash3_leaf']}; bytes per collective call "
              f"{audit_sizes(r['calls'])}")
        if min(r["launches"]["hash2_nodes"],
               r["launches"]["hash3_leaf"]) == 0:
            raise AssertionError(f"8b: rank {i} launched no hash2 or hash3")
        e32 = exchange_sizes(r["calls"]["insert_batches"])
        e24 = exchange_sizes(r["calls24"])
        if not e32 or set(e32) != set(e24) or len(set(e32)) != 1:
            raise AssertionError(f"8b: rank {i}'s candidate exchange moves "
                                 f"{set(e32)} B per call at depth "
                                 f"{C5_DEPTH}, {set(e24)} at "
                                 f"{S_AUDIT_DEPTH}")
    check_launched("sharded", launches)
    r = ranks[0]
    print(f"phase 8b: {label}: {C5_BATCHES} batches of K={C5_K} through "
          f"insert_batches in groups of {C5_GROUP} (2^{C5_CAPACITY} slots "
          f"held, 2^{C5_CAPACITY - 2} per rank): ok masks and root "
          f"{r['root']:#x} equal phase 6's on every rank; groups done after "
          f"{r['group_s']} s, {r['groups_s']} s with the barrier; the path "
          f"(groups, {S_Q} queries half present, a K={S_W_K} witness batch) "
          f"{r['path_s']} s; launches over the 4 ranks {launches}")
    print(f"phase 8b: the K={S_W_K} witness batch ({r['w_accepted']} "
          f"accepted) and the {S_Q} non-inclusion witnesses ({r['ni_ok']} "
          "ok) equal a single-device twin's loaded from phase 6's snapshot, "
          "field by field, every lane; every accepted lane passes "
          "insert_leaf; the twin's root after the batch equals the sharded "
          "tree's")
    print(f"phase 8b: the candidate exchange moves "
          f"{sorted(set(exchange_sizes(r['calls']['insert_batches'])))} B "
          f"per call at depth {C5_DEPTH} and "
          f"{sorted(set(exchange_sizes(r['calls24'])))} B at depth "
          f"{S_AUDIT_DEPTH} (K={C5_K}, 4 ranks): the audit on the card; "
          f"sharded_tree_root of {S_ROOT_LEAVES} leaves equals "
          f"MerkleTree.build's; the sharded snapshot saved in "
          f"{r['save_s']} s (rank 0 writes) and loaded onto the mesh in "
          f"{r['load_s']} s to the same root and count; the phase's wall "
          f"time {wall} s, process starts included")
    return {"launches": launches, "wall_s": wall}


# -- phase 9: the native oracle, hash_fixed, the fuzz ------------------------

def host_cpu() -> str:
    """The host CPU: its model (lscpu's "Model name", else /proc/cpuinfo's
    "model name", else "model not reported"), the machine type and the
    cores this process sees."""
    try:
        lines = subprocess.run(["lscpu"], capture_output=True, text=True,
                               timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    with open("/proc/cpuinfo") as f:
        lines += f.read().splitlines()
    names = [ln.split(":", 1)[1].strip() for ln in lines
             if ln.lower().startswith("model name")]
    model = names[0] if names else "model not reported"
    return f"{model}, {platform.machine()}, {os.cpu_count()} cores"


def on_host_cores(fn, cols, chunk: int = 4096):
    """An oracle function over the rows of uint64 [N, 4] arrays, `chunk`
    rows a call, on every host core (a ctypes call releases the GIL, and
    the oracle's hashes only read its constants)."""
    from concurrent.futures import ThreadPoolExecutor
    n = cols[0].shape[0]
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        parts = ex.map(lambda i: fn(*(c[i:i + chunk] for c in cols)),
                       range(0, n, chunk))
        return np.concatenate(list(parts))


def oracle_rate(oracle) -> float:
    """Single-core hashes/s of the C++ oracle, as bench.py --oracle measures
    it (bench.py:486-505): hash2 of 4096 seeded pairs, 32 times."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 62, (ORACLE_BATCH, 4), dtype=np.uint64)
    b = rng.integers(0, 1 << 62, (ORACLE_BATCH, 4), dtype=np.uint64)
    oracle.hash2_u64(a[:8], b[:8])
    t0 = time.perf_counter()
    for _ in range(ORACLE_ITERS):
        oracle.hash2_u64(a, b)
    return ORACLE_BATCH * ORACLE_ITERS / (time.perf_counter() - t0)


def phase_oracle(torch, pc, field, oracle, dev) -> None:
    """9a: the port's C++ oracle, built with g++, reproduces H(0,0,0) and
    equals the card's hash kernels bit for bit at the ragged width, phase
    3's edge values in the first lanes, through the limb bridge; then its
    single-core rate."""
    t0 = time.perf_counter()
    h = oracle.hash3([0], [0], [0])
    build_s = time.perf_counter() - t0
    if h != [ANCHOR_H000]:
        raise AssertionError(f"the oracle's H(0,0,0) = {h[0]:#x}")
    rng = np.random.default_rng(SEED + 11)
    base = seeded_limbs(rng, RAGGED)
    for i, v in enumerate(edge_values(field)):
        base[:, i] = int_limbs(v)
    cols = [np.ascontiguousarray(np.roll(base, s, axis=1))
            for s in (0, 7, 101)]
    t = [torch.as_tensor(c, device=dev) for c in cols]
    kernel = {"hash2": pc.hash2(t[0], t[1]).cpu().numpy(),
              "hash3": pc.hash3(*t).cpu().numpy()}
    u = [oracle.limbs_to_u64(c) for c in cols]
    t0 = time.perf_counter()
    native = {"hash2": on_host_cores(oracle.hash2_u64, u[:2]),
              "hash3": on_host_cores(oracle.hash3_u64, u)}
    native_s = time.perf_counter() - t0
    for name, got in native.items():
        if not np.array_equal(oracle.u64_to_limbs(got), kernel[name]):
            raise AssertionError(f"{name}: the oracle differs from the "
                                 "card's kernels")
    rate = oracle_rate(oracle)
    print(f"phase 9a: the C++ oracle (g++, built and loaded in {build_s} s) "
          "reproduces H(0,0,0) = 0x0455a7...48e9; its hash2 and hash3 of "
          f"{RAGGED} seeded pairs and triples (edge values in the first "
          f"lanes; {native_s} s on {os.cpu_count()} host threads) equal the "
          "card's hash kernels bit for bit through the limb bridge")
    print(f"phase 9a: C++ oracle {rate} hashes/s ({2 * rate} perms/s), one "
          f"core, hash2 of {ORACLE_BATCH} pairs x {ORACLE_ITERS} "
          f"(bench.py --oracle's protocol) [host CPU: {host_cpu()}]")


def native_witness_arrays(field, wits: list, depth: int) -> dict:
    """The native tree's witness dicts as arrays in ``InsertWitness``'s
    layout: limbs [16, K], proofs [depth, 16, K], helpers [depth, K]."""
    col = field.ints_to_limbs
    path = lambda key: np.stack([col([w[key][d] for w in wits])
                                 for d in range(depth)])
    bits = lambda key: np.array([w[key] for w in wits]).reshape(
        len(wits), depth).T
    out = {"old_root": col([w["old_root"] for w in wits]),
           "new_root": col([w["new_root"] for w in wits]),
           "low_leaf_proof": path("low_leaf_proof"),
           "low_leaf_proof_helper": bits("low_leaf_proof_helper"),
           "new_leaf_proof": path("new_leaf_proof"),
           "new_leaf_proof_helper": bits("new_leaf_proof_helper"),
           "new_leaf_index": np.array([w["new_leaf_index"] for w in wits]),
           "is_new_leaf_largest": np.array([w["is_new_leaf_largest"]
                                            for w in wits])}
    for leaf in ("low_leaf", "new_leaf"):
        for j, part in enumerate(("val", "next_val", "next_idx")):
            out[f"{leaf}_{part}"] = col([w[leaf][j] for w in wits])
    return out


def check_native_witness(field, w, wits: list, depth: int) -> int:
    """A witness batch (``InsertWitness``) against the native tree's
    witnesses of the same values inserted one by one: ``ok`` equal on
    every lane, every other field on the accepted lanes (on a rejected
    lane the batch reports another low leaf and proof than the native
    tree's slot 0).  Returns the number accepted."""
    ok = np.asarray(w.ok)
    if not np.array_equal(ok, [x["ok"] for x in wits]):
        raise AssertionError("ok differs from the native tree's")
    for name, want in native_witness_arrays(field, wits, depth).items():
        got = getattr(w, name).cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got[..., ok],
                                                          want[..., ok]):
            raise AssertionError(f"{name} differs from the native tree's on "
                                 "an accepted lane")
    return int(ok.sum())


def phase_native_witness(field, indexed, oracle, dev) -> None:
    """9b: witness batches of config 3w's depth and K (planted duplicates
    and zeros, the second batch holding duplicates of the first) into a
    dense tree on the card, the same values one by one into the C++ tree;
    after each batch the witnesses agree (check_native_witness) and so do
    the roots."""
    rng = np.random.default_rng(SEED + 12)
    batches, prev = [], None
    for _ in range(NATIVE_BATCHES):
        prev = plant(rng, field.random_limbs(int(rng.integers(1 << 31)), W_K,
                                             253), prev)
        batches.append(prev)
    tree = indexed.IndexedMerkleTree(W_DEPTH, device=dev)
    nat = oracle.NativeIndexedTree(W_DEPTH)
    native_s, accepted = 0.0, []
    for i, b in enumerate(batches):
        w = tree.insert_batch(b, witness=True)
        t0 = time.perf_counter()
        wits = [nat.insert(v) for v in field.limbs_to_ints(b)]
        native_s += time.perf_counter() - t0
        accepted.append(check_native_witness(field, w, wits, W_DEPTH))
        if tree.get_root_int() != nat.get_root():
            raise AssertionError(f"batch {i}: the root differs from the "
                                 "native tree's")
    rate = NATIVE_BATCHES * W_K / native_s
    print(f"phase 9b: {NATIVE_BATCHES} witness batches of K={W_K} at depth "
          f"{W_DEPTH} on the card equal the C++ tree's inserts one by one: "
          f"ok on every lane, every witness field on the {accepted} "
          "accepted lanes, the roots after each batch; the C++ tree ran "
          f"{rate} inserts/s, witness included [host CPU: {host_cpu()}]")


def fixed_columns(torch, field, width: int, seed: int, dev) -> list:
    """max(FIXED_ARITIES) seeded limb columns on the card, phase 3's edge
    values in the first lanes (shifted by one per column), p - 1 in every
    other lane of column 2 and in all of column 5 (absorbed words at
    p - 1)."""
    rng = np.random.default_rng(seed)
    cols = [seeded_limbs(rng, width) for _ in range(max(FIXED_ARITIES))]
    for j, c in enumerate(cols):
        for i, v in enumerate(edge_values(field)):
            c[:, (i + j) % width] = int_limbs(v)
    cols[2][:, ::2] = int_limbs(field.P - 1)[:, None]
    cols[5][:] = int_limbs(field.P - 1)[:, None]
    return [torch.as_tensor(c, device=dev) for c in cols]


def phase_hash_fixed(torch, pc, plain, hashing, field, dev) -> dict:
    """9c: hashing.hash_fixed on the card at arities 1-8 and the widths of
    FIXED_WIDTHS, arity 4 also at FILL_WIDTH, each call's K1 launches
    counted (n // 2 + 1); arities 2 and 3, which route to hash2 and hash3,
    also through poseidon_cuda.hash_fixed's K1 sponge.  Then every result
    against the plain version, bit for bit, and the two routes of arities
    2 and 3 against each other."""
    cols = {w: fixed_columns(torch, field, w, SEED + 13 + w, dev)
            for w in FIXED_WIDTHS + (FILL_WIDTH,)}
    cases = [(n, w) for w in FIXED_WIDTHS for n in FIXED_ARITIES]
    cases.append((FIXED_WIDE_ARITY, FILL_WIDTH))
    torch.cuda.synchronize()
    pc.reset_launch_counts()
    outs, k1_outs = {}, {}
    for n, w in cases:
        before = dict(pc.LAUNCHES)
        outs[n, w] = hashing.hash_fixed(cols[w][:n])
        if n in (2, 3):
            k1_outs[n, w] = pc.hash_fixed(cols[w][:n])
        got = launched(pc, before)
        want = {"permute_n": n // 2 + 1, "hash2_nodes": int(n == 2),
                "hash3_leaf": int(n == 3)}
        if {k: got.get(k, 0) for k in want} != want:
            raise AssertionError(f"hash_fixed arity {n} width {w}: launches "
                                 f"{got}, expected {want}")
    torch.cuda.synchronize()
    launches = dict(pc.LAUNCHES)
    print(f"phase 9c: hash_fixed, arities {FIXED_ARITIES[0]}-"
          f"{FIXED_ARITIES[-1]} at widths {FIXED_WIDTHS} and arity "
          f"{FIXED_WIDE_ARITY} at {FILL_WIDTH}: launches {launches}, K1 "
          "n // 2 + 1 per call")
    check_launched("hash_fixed", launches)
    err = 0
    for (n, w), got in outs.items():
        want = plain.hash_fixed(cols[w][:n])
        err = max(err, max_abs_err(got, want))
        if not torch.equal(got, want) or ((n, w) in k1_outs and not
                                          torch.equal(k1_outs[n, w], want)):
            raise AssertionError(f"hash_fixed arity {n} width {w}: the "
                                 "card differs from plain")
    print(f"phase 9c: every hash_fixed result equals the plain version's, "
          f"max_abs_err {err} (tolerance 0, bit-exact); arities 2 and 3 "
          "through K1 equal hash2 and hash3")
    return {"launches": launches, "max_abs_err": err}


def phase_fuzz(fuzz_compare) -> None:
    """9d: tools/fuzz_compare_10m_torch.py's rounds on the card."""
    out = fuzz_compare.fuzz(FUZZ_ROUNDS, "cuda",
                            log=lambda s: print(f"phase 9d: {s.strip()}"))
    print(f"phase 9d: the comparator fuzz passed: {out['pairs']} pairs "
          f"({FUZZ_ROUNDS} rounds of {fuzz_compare.BATCH}) on the card in "
          f"{out['seconds']} s wall")


# -- phase 5: numbers ---------------------------------------------------------

def poseidon_bound_ms(name: str, width: int, imad_per_s: float,
                      n: int = 1):
    """(ms, what bounds it): the larger of the least multiply-adds (each one
    IMAD) over the published IMAD rate and the bytes over the HBM rate; n
    chained calls of the function's work on the same bytes (K1's n_perms)."""
    ops_s = n * width * sum(LANE_WORK[name]) / imad_per_s
    bytes_s = width * BYTES_PER_LANE[name] / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def probe_bound_ms(name: str, width: int, ceiling: dict, n: int = 1):
    """The same bound at the probe's measured ceilings: wide steps at the
    cios16 rate, 32-bit IMADs at the imad16 rate, bytes as above."""
    wide, narrow = LANE_WORK[name]
    return max(1e3 * n * width * (wide / ceiling["cios16"]
                                  + narrow / ceiling["imad16"]),
               1e3 * width * BYTES_PER_LANE[name] / HBM_BYTES_PER_S)


def roofline_bound_ms(vr, name: str, n: int, k: int, imad_per_s: float):
    body = vr.BODIES[name]
    peak = vr.F32_PEAK_PER_S if body.peak_kind == "f32" else imad_per_s
    ops_s = n * k * body.peak_ops / peak
    bytes_s = n * 8 / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def phase_numbers(torch, pc, plain, vr, vc, indexed, field, card: str,
                  clock_mhz: float, slice_out: dict, sparse_out: dict,
                  witness_out: dict) -> dict:
    bs = slice_out["batch_s"]
    steady = bs[1:]
    print(f"phase 5: depth {DEPTH} insert_batch K={K} wall s per batch "
          f"{bs} (first includes warm-up); "
          f"{K * len(steady) / sum(steady)} inserts/s over batches 2-"
          f"{len(bs)} [{card}]")
    gs = sparse_out["group_s"]
    print(f"phase 5: depth {C5_DEPTH} sparse (2^{C5_CAPACITY} slots held) "
          f"insert_batches of {C5_GROUP} batches of K={C5_K}: wall s per "
          f"group {gs} (first includes warm-up); "
          f"{C5_GROUP * C5_K / gs[-1]} inserts/s over group 2 [{card}]")
    ws, deep_s = witness_out["batch_s"], witness_out["deep_s"]
    print(f"phase 5: depth {W_DEPTH} insert_batch(witness=True) K={W_K}: wall "
          f"s per batch {ws} (first includes warm-up); "
          f"{W_K * (len(ws) - 1) / sum(ws[1:])} witness inserts/s over "
          f"batches 2-{len(ws)}; depth 32, one batch that grows the tree "
          f"from 2^10 slots: {deep_s} s = {W_K / deep_s} witness inserts/s "
          f"[{card}]")
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    tree = slice_out["tree"]
    seq = field.random_limbs(int(rng.integers(1 << 31)), SEQ_VALUES, 253)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree.insert_seq(seq)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    queries = field.random_limbs(int(rng.integers(1 << 31)), QUERIES, 253)
    # the call is host-bound (a few hundred small launches), so one reading
    # on the host clock spreads: take five and report the median
    ni_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        tree.non_inclusion_witness(queries)
        torch.cuda.synchronize()
        ni_s.append(time.perf_counter() - t0)
    ni_med = sorted(ni_s)[2]
    print(f"phase 5: depth {DEPTH} insert_seq of {SEQ_VALUES} values, witness "
          f"included: {seq_s} s = {SEQ_VALUES / seq_s} sequential inserts/s; "
          f"non_inclusion_witness K={QUERIES}: s per call {ni_s}, median "
          f"{ni_med} s = {QUERIES / ni_med} witnesses/s [{card}]")

    imad_per_s = vr.peak_per_s(
        "imad", torch.cuda.get_device_properties(0).multi_processor_count,
        clock_mhz)
    vc.reset_launch_counts()
    rates = vr.probe(clock_mhz=clock_mhz)
    probe_launches = dict(vc.LAUNCHES)
    for r in rates:
        print(f"phase 5: probe {r['name']:7s} [{r['rows']}, {r['batch']}] "
              f"k {r['k1']}/{r['k2']}: {r['us_per_iter']} us/iter, "
              f"{r['t_ops_per_s']} T census ops/s, {r['t_evals_per_s']} T "
              f"evals/s, {r['peak_ops_per_s'] / 1e12} T {r['peak_kind']}/s = "
              f"{100 * r['share']:.1f}% of {r['peak_per_s'] / 1e12} T/s "
              f"[{card}]")
    for name, n in probe_launches.items():
        if n == 0:
            raise AssertionError(f"the probe path never launched {name}")
    ceiling = {r["name"]: r["peak_ops_per_s"] for r in rates}

    L = [torch.as_tensor(seeded_limbs(rng, FILL_WIDTH), device=dev)
         for _ in range(3)]
    times, bounds = {}, {}
    for width in (TIMING_WIDTH, FILL_WIDTH):
        Lw = [x[:, :width].contiguous() for x in L]
        nodes = [pc.limbs_to_nodes(x) for x in Lw]
        st = torch.stack(nodes)
        cases = {
            "hash2_nodes": (lambda f: f.hash2_nodes(nodes[0], nodes[1])),
            "hash3_leaf": (lambda f: f.hash3_leaf(*Lw)),
            "nodes_to_limbs": (lambda f: f.nodes_to_limbs(nodes[0])),
            "limbs_to_nodes": (lambda f: f.limbs_to_nodes(Lw[0])),
            "permute_n": (lambda f: f.permute_n(st, 1)),
        }
        for name, call in cases.items():
            bound, by = poseidon_bound_ms(name, width, imad_per_s)
            measured = probe_bound_ms(name, width, ceiling)
            if width == FILL_WIDTH:
                k1 = vr.time_ms(lambda: call(pc), 10, 2)
                k2 = vr.time_ms(lambda: call(pc), 10, 0)
                print(f"phase 5: {name} width {width}: kernel ms {k1} {k2}; "
                      f"bound {bound} ms ({by}; published peaks), share "
                      f"{100 * bound / min(k1, k2):.1f}%; bound by the "
                      f"probe's cios16/imad16 ceilings {measured} ms, share "
                      f"{100 * measured / min(k1, k2):.1f}% [{card}]")
                continue
            # plain, kernel, kernel, plain
            p1 = vr.time_ms(lambda: call(plain), 1, 1)
            k1 = vr.time_ms(lambda: call(pc), 20, 3)
            k2 = vr.time_ms(lambda: call(pc), 20, 0)
            p2 = vr.time_ms(lambda: call(plain), 1, 0)
            times[name] = (min(k1, k2), min(p1, p2))
            bounds[name] = (bound, by)
            print(f"phase 5: {name} width {width}: kernel ms {k1} {k2}, "
                  f"plain ms {p1} {p2}; bound {bound} ms ({by}; published "
                  f"peaks), share {100 * bound / min(k1, k2):.1f}%; "
                  f"bound by the probe's cios16/imad16 ceilings {measured} "
                  f"ms, share {100 * measured / min(k1, k2):.1f}% [{card}]")

    # K1 per permutation against hash2 per permutation (hash2 runs two
    # permutations a lane), in turns (K1 at n_perms 1 and 2, hash2, hash2,
    # K1 at 2 and 1), at the sequential path's width, the batched path's
    # widest, the reference bench's headline batch and a width that fills
    # the card
    for width in (SEQ_WIDTH, TIMING_WIDTH, BENCH_WIDTH, FILL_WIDTH):
        nodes = [pc.limbs_to_nodes(x[:, :width].contiguous()) for x in L]
        st = torch.stack(nodes)
        hash2 = lambda: pc.hash2_nodes(nodes[0], nodes[1])
        perm = lambda n: (lambda: pc.permute_n(st, n))
        reps = 10 if width >= BENCH_WIDTH else 20
        k = {n: [vr.time_ms(perm(n), reps, 2)] for n in (1, 2)}
        h = [vr.time_ms(hash2, reps, 2), vr.time_ms(hash2, reps, 0)]
        for n in (2, 1):
            k[n].append(vr.time_ms(perm(n), reps, 0))
        shares = []
        for n in (1, 2):
            bound, by = poseidon_bound_ms("permute_n", width, imad_per_s, n)
            measured = probe_bound_ms("permute_n", width, ceiling, n)
            shares.append(
                f"n_perms {n}: ms {k[n][0]} {k[n][1]}, "
                f"{min(k[n]) / n} per permutation, bound {bound} ms ({by}), "
                f"share {100 * bound / min(k[n]):.1f}%, probe bound "
                f"{measured} ms, share {100 * measured / min(k[n]):.1f}%")
        print(f"phase 5: K1 width {width}: {'; '.join(shares)}; hash2_nodes "
              f"ms {h[0]} {h[1]}, {min(h) / 2} per permutation; K1 / hash2 "
              f"per permutation {min(k[2]) / min(h):.4f} [{card}]")
    k1_alone = min(k[1])

    # hash_fixed at FILL_WIDTH (plain, kernel path, kernel path, plain):
    # its K1 launches a call, and its time per permutation against K1
    # alone at n_perms 1 (the loop's last width), which shows what the
    # conversions and the torch absorptions between launches cost
    cols = L + [torch.as_tensor(seeded_limbs(rng, FILL_WIDTH), device=dev)
                for _ in range(max(FIXED_TIMED) - len(L))]
    for n in FIXED_TIMED:
        call = lambda f: f.hash_fixed(cols[:n])
        before = dict(pc.LAUNCHES)
        call(pc)
        perms = launched(pc, before)["permute_n"]
        p1 = vr.time_ms(lambda: call(plain), 1, 1)
        k1 = vr.time_ms(lambda: call(pc), 10, 2)
        k2 = vr.time_ms(lambda: call(pc), 10, 0)
        p2 = vr.time_ms(lambda: call(plain), 1, 0)
        print(f"phase 5: hash_fixed arity {n} width {FILL_WIDTH}: kernel "
              f"path ms {k1} {k2}, plain ms {p1} {p2}; {perms} K1 launches "
              f"a call, {min(k1, k2) / perms} ms per permutation against "
              f"{k1_alone} for K1 alone at n_perms 1 "
              f"({min(k1, k2) / perms / k1_alone:.4f}) [{card}]")

    for name in vr.BODIES:
        x = vr.seeded_input(name, *PROBE_SHAPE, seed=SEED)
        call = lambda f: f(name, x, PROBE_K)
        p1 = vr.time_ms(lambda: call(vr.plain), 1, 1)
        k1 = vr.time_ms(lambda: call(vc.roofline), 10, 2)
        k2 = vr.time_ms(lambda: call(vc.roofline), 10, 0)
        p2 = vr.time_ms(lambda: call(vr.plain), 1, 0)
        times[name] = (min(k1, k2), min(p1, p2))
        bounds[name] = roofline_bound_ms(vr, name, x.numel(), PROBE_K,
                                         imad_per_s)
        print(f"phase 5: roofline {name} [{PROBE_SHAPE[0]}, "
              f"{PROBE_SHAPE[1]}] k={PROBE_K}: kernel ms {k1} {k2}, plain ms "
              f"{p1} {p2}; bound {bounds[name][0]} ms ({bounds[name][1]}; "
              f"published peaks), share "
              f"{100 * bounds[name][0] / min(k1, k2):.1f}% [{card}]")
    return {"times": times, "bounds": bounds, "probe_launches": probe_launches}


def kernel_record(errs: dict, launches: dict, numbers: dict) -> dict:
    """The kernels' JSON record: every kernel, each on the paths that run it
    (launches: the sum over those paths, each path's run counted from 0,
    with the split under "paths").  No single PyTorch call computes a
    Poseidon permutation or a chained probe body, so library_ms is null."""
    record = {"kernels": []}
    entries = [(n, "cuda", POSEIDON_SOURCE, rep, paths)
               for n, (rep, paths) in POSEIDON.items()]
    entries += [(n, "cuda", ROOFLINE_SOURCE, ROOFLINE_REPLACES, ("probe",))
                for n in numbers["probe_launches"]]
    for name, route, source, rep, paths in entries:
        split = {p: launches[p][name] for p in paths}
        ms, plain_ms = numbers["times"][name]
        bound, by = numbers["bounds"][name]
        record["kernels"].append(
            {"name": name, "route": route, "source": source, "replaces": rep,
             "launches": sum(split.values()), "paths": split,
             "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None})
    return record


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "imt_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1

    from imt_tpu_torch.native import oracle
    from imt_tpu_torch.ops import _build, field, hashing
    from imt_tpu_torch.ops import poseidon as plain
    from imt_tpu_torch.ops import poseidon_cuda as pc
    from imt_tpu_torch.ops import vpu_roofline as vr
    from imt_tpu_torch.ops import vpu_roofline_cuda as vc
    from imt_tpu_torch.tree import indexed, merkle, reference_oracle, sparse
    from imt_tpu_torch.utils import checkpoint

    card = vr.nvidia_smi("name,power.limit")
    clock_mhz = float(vr.nvidia_smi("clocks.max.sm").split()[0])
    print(f"phase 1: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}, "
          f"max SM clock {clock_mhz} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(f"phase 1: least multiply-adds per permutation (bound): wide "
          f"{PERM_WORK[0]}, 32-bit {PERM_WORK[1]}; K1's core: wide "
          f"{K1_WORK[0]}, 32-bit {K1_WORK[1]}; the hash kernels' sparse "
          f"core: {SPARSE_MONT_PER_PERM} products, wide "
          f"{SPARSE_MONT_PER_PERM * WIDE_PER_MONT}, 32-bit "
          f"{SPARSE_MONT_PER_PERM * NARROW_PER_MONT}")

    phase_build(_build)
    errs = phase_kernel_vs_plain(torch, pc, plain, field)
    for name, err in phase_wide_kernel_vs_plain(torch, pc, plain,
                                                field).items():
        errs[name] = max(errs[name], err)
    errs.update(phase_roofline_vs_plain(torch, vr, vc))
    slice_out = phase_slice(torch, pc, field, indexed, reference_oracle)
    seq_out = phase_sequential(torch, pc, field, indexed, merkle,
                               reference_oracle, slice_out,
                               torch.device("cuda"))
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="imt_smoke_") as work_dir:
        t6 = time.perf_counter()
        sparse_out = phase_sparse(torch, pc, field, indexed, sparse,
                                  checkpoint, dev, work_dir)
        witness_out = phase_witness(torch, pc, field, indexed, sparse, dev)
        print(f"phase 6: done in {time.perf_counter() - t6:.1f} s")
        ops_out = phase_operations(torch, pc, field, indexed, sparse_out,
                                   dev, work_dir)
        nccl_out = phase_nccl_one(torch, pc, field, slice_out,
                                  torch.device("cuda", 0), work_dir)
        shard_out = phase_sharded(torch, pc, field, sparse_out, work_dir,
                                  torch.device("cuda", 0))
    del sparse_out["stream"], sparse_out["oks"]
    t9 = time.perf_counter()
    phase_oracle(torch, pc, field, oracle, dev)
    phase_native_witness(field, indexed, oracle, dev)
    fixed_out = phase_hash_fixed(torch, pc, plain, hashing, field, dev)
    errs["permute_n"] = max(errs["permute_n"], fixed_out["max_abs_err"])
    phase_fuzz(tool("fuzz_compare_10m_torch"))
    print(f"phase 9: done in {time.perf_counter() - t9:.1f} s")
    numbers = phase_numbers(torch, pc, plain, vr, vc, indexed, field, card,
                            clock_mhz, slice_out, sparse_out, witness_out)
    launches = {"insert_batch": slice_out["launches"],
                "sequential": seq_out["launches"],
                "sparse_batches": sparse_out["launches"],
                "witness_batch": witness_out["launches"],
                **ops_out["launches"],
                "sharded_nccl1": nccl_out["launches"],
                "sharded": shard_out["launches"],
                "hash_fixed": fixed_out["launches"],
                "probe": numbers["probe_launches"]}

    print(card)
    print(json.dumps(kernel_record(errs, launches, numbers)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
