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
   two cores' own;
2. build: nvcc, with the build times, the ptxas register report, and the
   SASS census of both Poseidon permutation cores, the dense one of
   permute_kernel and the sparse one of the hash kernels (instructions per
   permutation by opcode, the multiply-adds counted in the built library
   against the source's count);
3. Poseidon kernel vs plain, bit for bit, at a ragged width of 65537 lanes
   with edge values and at the main path's own widths (config 5's hash3
   over 2^17 leaves, down to the sequential path's 2 and 1), and the
   H(0,0,0) and poseidonperm_x5_254_3 anchors;
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
   accepted lanes;
5. numbers: depth-24 inserts/s (batched and sequential), non-inclusion
   witnesses/s, phase 6's sparse chained inserts/s and witness-batch
   inserts/s, the probe's rates per body (its own path), and each
   kernel's time beside its plain version's and its bound, the Poseidon
   entry points also at a width that fills the card, and hash2 (the sparse
   core) against permute_n(st, 2) (the dense core) at widths 2, 8192 and
   2^17.

Phase 6 runs before phase 5, which prints its numbers.  The line before the
last is the kernels' JSON record (the paths' kernels, each with its launches
per path, then the entry point no path runs); the last line is ``{"ok": true,
"device": {...}}``.  Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEPTH, K, N_BATCHES = 24, 4096, 4
RAGGED = 65537
TIMING_WIDTH = 8192
SEQ_WIDTH = 2                 # a sequential insert's hash2 launches
FILL_WIDTH = 1 << 17          # 132 SMs x ~8 blocks of 128 lanes
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
W_DEPTH, W_K, W_BATCHES, W_SEQ = 16, 4096, 8, 256
# phase 3: config 5's (hash3 over 2 * C5_K leaves, hash2 over the C5_K low
# leaves), a ragged width, the batched and witness paths' (2K, K), the
# sequential one's (2)
PHASE3_WIDTHS = (2 * C5_K, RAGGED, C5_K, 2 * K, K, K // 2 + 1, 129,
                 SEQ_WIDTH, 1)

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
POSEIDON = {
    "hash3_leaf": ("imt_tpu/ops/poseidon_rns_pallas.py:1240",
                   ("insert_batch", "sequential", "sparse_batches",
                    "witness_batch")),
    "hash2_nodes": ("imt_tpu/ops/poseidon_rns_pallas.py:1240",
                    ("insert_batch", "sequential", "sparse_batches",
                     "witness_batch")),
    "nodes_to_limbs": ("imt_tpu/ops/field_rns.py:262",
                       ("insert_batch", "sequential", "witness_batch")),
    "limbs_to_nodes": ("imt_tpu/ops/field_rns.py:249", ("sequential",)),
    "permute_n": ("imt_tpu/ops/poseidon_rns_pallas.py:1199", ()),
}
ROOFLINE_REPLACES = "tools/vpu_roofline.py:83"

# What the port's kernels execute, counted from the source and held against
# their SASS in phase 2.  The dense core (permute_kernel): a permutation is
# 828 Montgomery products (8 full rounds x 18, 57 partial x 12), each 128
# wide (32x32->64-bit) multiply-adds and 8 32-bit ones (mont_mul).  The
# sparse core (hash2_kernel, hash3_kernel): 600 products (8 full rounds x
# 18, 57 partial x 8), of the same 128 wide and 8 32-bit multiply-adds
# (mont_mul_cc: each row's 8 products as 64-bit multiply-adds).
MONT_PER_PERM = 828
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


def sass_census(sass: str) -> dict:
    """Instructions per permutation in permute_kernel's SASS (the dense
    core): the round loop (the innermost backward branch) runs 65 times,
    and the block its one forward branch skips runs on the 8 full rounds
    (or, were the branch the other way round, the 57 partial ones: the trip
    count that makes the wide multiplies come out at 828 products' worth is
    taken, and if neither does, the census fails).  Returns counts by
    opcode."""
    ins = kernel_instructions(sass, "permute_kernel")
    branches = _branches(ins)
    loops = sorted((a - t, t, a) for a, t in branches if t < a)
    if not loops:
        raise AssertionError("no loop in permute_kernel's SASS")
    _, lo, hi = loops[0]
    skips = [(a, t) for a, t in branches if lo <= a < t <= hi]
    if len(skips) != 1:
        raise AssertionError(f"expected one branch in the round loop, got "
                             f"{len(skips)}")
    s_lo, s_hi = skips[0][0] + 16, skips[0][1]

    every, cond = _count(ins, lo, hi + 16), _count(ins, s_lo, s_hi)
    for k in cond:
        every[k] -= cond[k]
    wide_want = MONT_PER_PERM * WIDE_PER_MONT
    for cond_trips in (8, 57):
        per = {k: 65 * every.get(k, 0) + cond_trips * cond.get(k, 0)
               for k in set(every) | set(cond)}
        wide = per.get("IMAD.WIDE.U32", 0) + per.get("IMAD.HI.U32", 0)
        if wide == wide_want:
            return per
    raise AssertionError(f"SASS wide multiplies per permutation differ from "
                         f"the source's {wide_want}")


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
NO_SPILLS = ("hash2_kernel", "hash3_kernel")


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
    per = sass_census(sass)
    imad = sum(v for k, v in per.items() if k.startswith("IMAD"))
    narrow = per.get("IMAD", 0)
    if narrow < MONT_PER_PERM * NARROW_PER_MONT:
        raise AssertionError(f"SASS 32-bit IMADs per permutation {narrow}, "
                             f"fewer than the source's "
                             f"{MONT_PER_PERM * NARROW_PER_MONT}")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:12]
    print(f"phase 2: SASS census per permutation, dense core "
          f"(permute_kernel): {sum(per.values())} instructions, {imad} of "
          f"the IMAD family (IMAD.WIDE.U32 {per.get('IMAD.WIDE.U32', 0)} + "
          f"IMAD.HI.U32 {per.get('IMAD.HI.U32', 0)} = {MONT_PER_PERM} x "
          f"{WIDE_PER_MONT} wide multiply-adds, as the source counts; IMAD "
          f"{narrow}: the source's {MONT_PER_PERM} x {NARROW_PER_MONT} "
          f"32-bit ones and address arithmetic); top: {top}")
    sp = sparse_census(sass)
    top = sorted(sp.items(), key=lambda kv: -kv[1])[:12]
    print(f"phase 2: SASS census per permutation, sparse core "
          f"(hash2_kernel, two permutations halved): {sum(sp.values())} "
          f"instructions = {sum(sp.values()) / sum(per.values()):.4f} of the "
          f"dense core's, {sum(sp.values()) / SPARSE_MONT_PER_PERM:.1f} per "
          f"product (IMAD.WIDE.U32 {sp.get('IMAD.WIDE.U32', 0)} + "
          f"IMAD.HI.U32 {sp.get('IMAD.HI.U32', 0)}: the source's "
          f"{SPARSE_MONT_PER_PERM} x {WIDE_PER_MONT} wide multiply-adds, "
          f"less the products squares share, with the addressing; IMAD "
          f"{sp.get('IMAD', 0)}: at least the source's "
          f"{SPARSE_MONT_PER_PERM} x {NARROW_PER_MONT} 32-bit ones); top: "
          f"{top}")
    if sum(sp.values()) >= sum(per.values()):
        raise AssertionError("the sparse core runs no fewer instructions per "
                             "permutation than the dense core")


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
    for i, v in enumerate([0, 1, field.P - 1, field.P, (1 << 256) - 1]):
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
            "permute_n": (lambda s: pc.permute_n(s, 2),
                          lambda s: plain.permute_n(s, 2),
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
        print(f"phase 3: {name} widths {', '.join(map(str, PHASE3_WIDTHS))}: "
              f"kernel vs plain max_abs_err {err} (tolerance 0, bit-exact)")

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


def phase_slice(torch, pc, field, indexed, reference_oracle) -> dict:
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    tree = indexed.IndexedMerkleTree(DEPTH)
    batches, prev = [], None
    for _ in range(N_BATCHES):
        b = plant(rng, field.random_limbs(int(rng.integers(1 << 31)), K, 253),
                  prev)
        batches.append(b)
        prev = b
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
            "seen": seen}


def check_launched(path: str, launches: dict) -> None:
    for name, (_, paths) in POSEIDON.items():
        if path in paths and launches[name] == 0:
            raise AssertionError(f"the {path} path never launched {name}")


def replay_small(indexed, reference_oracle, dev) -> None:
    """Three K=8 batches (duplicates, zeros, chains) into a depth-6 tree on
    `dev`; after each, the ok mask and the root must equal the python-int
    oracle's.  The oracle's own planner (update_idx_leaf) keeps the
    reference's quirk of taking an empty slot as a low leaf, and rejected
    values leave empty slots behind; so the list rule is replayed here on
    python ints, and the oracle hashes the leaves and builds the tree."""
    small = indexed.IndexedMerkleTree(6, device=dev)
    pre = [reference_oracle.Leaf(0, 0, 0) for _ in range(1 << 6)]
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

def golden_path(indexed, reference_oracle, field, dev) -> None:
    """[30, 10, 20, 5, 50, 35] through insert into a depth-6 tree on `dev`:
    after each insert, the root and every witness field must equal the
    python-int oracle's sequential insert (reference discipline)."""
    tree = indexed.IndexedMerkleTree(6, device=dev)
    oracle = reference_oracle.OracleIndexedTree(6)
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


def phase_sparse(torch, pc, field, indexed, sparse, dev) -> dict:
    """Config 5's shape: a depth-32 sparse tree with 2^21 slots held, 16
    batches of K = 65536 through insert_batches in groups of 8."""
    rng = np.random.default_rng(SEED + 6)
    batches, prev = [], None
    for _ in range(C5_BATCHES):
        b = plant(rng, field.random_limbs(int(rng.integers(1 << 31)), C5_K,
                                          253), prev)
        batches.append(b)
        prev = b
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
    del tree
    torch.cuda.empty_cache()
    return {"launches": launches, "group_s": group_s}


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


# -- phase 5: numbers ---------------------------------------------------------

def poseidon_bound_ms(name: str, width: int, imad_per_s: float):
    """(ms, what bounds it): the larger of the least multiply-adds (each one
    IMAD) over the published IMAD rate and the bytes over the HBM rate."""
    ops_s = width * sum(LANE_WORK[name]) / imad_per_s
    bytes_s = width * BYTES_PER_LANE[name] / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


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
            # the probe's measured ceilings: wide steps at the cios16 rate,
            # 32-bit IMADs at the imad16 rate (bytes as above)
            wide, narrow = LANE_WORK[name]
            measured = max(1e3 * width * (wide / ceiling["cios16"]
                                          + narrow / ceiling["imad16"]),
                           1e3 * width * BYTES_PER_LANE[name]
                           / HBM_BYTES_PER_S)
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

    # the hash kernels' sparse core against the dense core, in turns (dense,
    # hash2, hash2, dense): hash2 runs two sparse-core permutations per lane,
    # permute_n(st, 2) two dense-core ones; at the sequential path's width,
    # the batched path's widest and a width that fills the card
    for width in (SEQ_WIDTH, TIMING_WIDTH, FILL_WIDTH):
        nodes = [pc.limbs_to_nodes(x[:, :width].contiguous()) for x in L]
        st = torch.stack(nodes)
        hash2 = lambda: pc.hash2_nodes(nodes[0], nodes[1])
        dense = lambda: pc.permute_n(st, 2)
        reps = 10 if width == FILL_WIDTH else 20
        d1 = vr.time_ms(dense, reps, 2)
        h1 = vr.time_ms(hash2, reps, 2)
        h2 = vr.time_ms(hash2, reps, 0)
        d2 = vr.time_ms(dense, reps, 0)
        bound, by = poseidon_bound_ms("hash2_nodes", width, imad_per_s)
        print(f"phase 5: width {width}: hash2_nodes (sparse core) ms {h1} "
              f"{h2}, permute_n(st, 2) (dense core) ms {d1} {d2}: hash2 / "
              f"dense {min(h1, h2) / min(d1, d2):.4f}; hash2 bound {bound} "
              f"ms ({by}), share {100 * bound / min(h1, h2):.2f}% [{card}]")

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
    """The kernels' JSON record: every kernel that a path runs under
    "kernels" (launches: the sum over the paths that run it, each path's
    run counted from 0, with the split under "paths"), the entry point no
    path runs under "off_path_kernels".  No single PyTorch call computes a
    Poseidon permutation or a chained probe body, so library_ms is null."""
    record = {"kernels": [], "off_path_kernels": []}
    entries = [(n, "cuda", POSEIDON_SOURCE, rep, paths)
               for n, (rep, paths) in POSEIDON.items()]
    entries += [(n, "cuda", ROOFLINE_SOURCE, ROOFLINE_REPLACES, ("probe",))
                for n in numbers["probe_launches"]]
    for name, route, source, rep, paths in entries:
        split = {p: launches[p][name] for p in paths}
        ms, plain_ms = numbers["times"][name]
        bound, by = numbers["bounds"][name]
        record["kernels" if paths else "off_path_kernels"].append(
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

    from imt_tpu_torch.ops import _build, field
    from imt_tpu_torch.ops import poseidon as plain
    from imt_tpu_torch.ops import poseidon_cuda as pc
    from imt_tpu_torch.ops import vpu_roofline as vr
    from imt_tpu_torch.ops import vpu_roofline_cuda as vc
    from imt_tpu_torch.tree import indexed, merkle, reference_oracle, sparse

    card = vr.nvidia_smi("name,power.limit")
    clock_mhz = float(vr.nvidia_smi("clocks.max.sm").split()[0])
    print(f"phase 1: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}, "
          f"max SM clock {clock_mhz} MHz; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(f"phase 1: least multiply-adds per permutation (bound): wide "
          f"{PERM_WORK[0]}, 32-bit {PERM_WORK[1]}; the dense core's: wide "
          f"{MONT_PER_PERM * WIDE_PER_MONT}, 32-bit "
          f"{MONT_PER_PERM * NARROW_PER_MONT}; the sparse core's: "
          f"{SPARSE_MONT_PER_PERM} products, wide "
          f"{SPARSE_MONT_PER_PERM * WIDE_PER_MONT}, 32-bit "
          f"{SPARSE_MONT_PER_PERM * NARROW_PER_MONT}")

    phase_build(_build)
    errs = phase_kernel_vs_plain(torch, pc, plain, field)
    errs.update(phase_roofline_vs_plain(torch, vr, vc))
    slice_out = phase_slice(torch, pc, field, indexed, reference_oracle)
    seq_out = phase_sequential(torch, pc, field, indexed, merkle,
                               reference_oracle, slice_out,
                               torch.device("cuda"))
    dev = torch.device("cuda")
    t6 = time.perf_counter()
    sparse_out = phase_sparse(torch, pc, field, indexed, sparse, dev)
    witness_out = phase_witness(torch, pc, field, indexed, sparse, dev)
    print(f"phase 6: done in {time.perf_counter() - t6:.1f} s")
    numbers = phase_numbers(torch, pc, plain, vr, vc, indexed, field, card,
                            clock_mhz, slice_out, sparse_out, witness_out)
    launches = {"insert_batch": slice_out["launches"],
                "sequential": seq_out["launches"],
                "sparse_batches": sparse_out["launches"],
                "witness_batch": witness_out["launches"],
                "probe": numbers["probe_launches"]}

    print(card)
    print(json.dumps(kernel_record(errs, launches, numbers)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
