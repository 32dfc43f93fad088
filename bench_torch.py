#!/usr/bin/env python3
"""The benchmark of imt_tpu_torch on one NVIDIA GPU: prints ONE JSON line.

The port of ``bench.py``: the same functions by name, the same flags, the
same metric strings, shapes, seeds, iteration and round counts.  It
imports ``torch`` and ``imt_tpu_torch``, never ``jax`` or ``imt_tpu``.

Usage:
    python3 bench_torch.py                # headline: K1's permutations/s
    python3 bench_torch.py --smoke        # tiny + quick
    python3 bench_torch.py --config 5     # one config: 2, 3, 3w, 4 or 5
    python3 bench_torch.py --artifact     # parity, then every config ->
                                          #   BENCH_configs_torch.json
    python3 bench_torch.py --oracle       # the C++ oracle on one host core
    python3 bench_torch.py --insert       # batched leaf-inserts/s
    python3 bench_torch.py --device cpu   # the plain torch path (tests)

Protocol.
  * Every time is the host clock around the work, ended by
    ``torch.cuda.synchronize()``.
  * The headline (``bench_perms``) times K1 (``poseidon_cuda.permute_n``)
    at 66,560 lanes: each outer iteration is one launch of CHAIN = 2
    chained permutations, the state derived on the card from the seed
    (limbs iota ^ seed masked to 11 bits, as ``bench.py:104-110``, turned
    into nodes).  The rate comes from the slope between k1 and k2 outer
    iterations; each k is timed HEADLINE_REPS times interleaved and the
    least taken; the result is the median of HEADLINE_ROUNDS rounds, each
    held against the card's own bound (``classify_round``): K1's least
    work (``ops/perm_work.py``) at the published IMAD rate of this card's
    SMs at its maximum clock.  A round above it is an impossible reading.
  * The configs (``config_result``): inputs are staged on the card before
    the timed window, as ``bench.py``'s ``device_put`` does.  A limb
    tensor on the card is range-checked there (``tree/indexed.py``
    ``_checked_limbs``), which reads one flag back per call: that wait is
    inside the timed window, once per ``insert_seq`` chunk, batch or group.
    Each round inserts into a fresh tree, replays the same staged batches
    after a synchronous warm-up insert (``bench.py``'s config 3 has none;
    here it has one, like the others), and the median of the rounds after
    round 0 is reported (``_median_rounds``).
  * Correctness, outside the timed window, on the last round: config 2's
    ``verify_non_inclusion`` on every lane; configs 3 and 3w's masks
    against set semantics, 3w's last batch through ``insert_leaf``;
    configs 4 and 5's masks against set semantics and their root against
    a rebuild from the leaf state.  A false ``correct`` exits non-zero
    after the line is printed.

Each line keeps ``bench.py``'s keys (``metric``, ``value``, ``unit``,
``vs_baseline``) and adds ``device`` (the card's name and power limit from
nvidia-smi, and the card count), ``rounds`` (every round's rate, the
dropped round 0 marked), ``spread``, ``peak_bytes`` and ``correct``.
``vs_baseline`` is null: no number here is a TPU number, and none of the
TPU's targets or bounds is carried over.  A line from ``--device cpu``
says ``"platform": "cpu"``; its rates are the plain torch path's, not the
port's.  ``bench.py --engine`` is not ported: the port has one node form
and one kernel per entry point.
"""

from __future__ import annotations

import argparse
import datetime
import importlib.util
import json
import os
import platform
import random
import statistics
import sys
import time

import numpy as np
import torch

from imt_tpu_torch.native import oracle
from imt_tpu_torch.ops import field, hashing, poseidon, poseidon_cuda
from imt_tpu_torch.ops.perm_work import perm_bound_per_s
from imt_tpu_torch.ops.vpu_roofline import nvidia_smi
from imt_tpu_torch.tree import indexed
from imt_tpu_torch.tree.sparse import SparseIndexedMerkleTree
from imt_tpu_torch.utils.checks import rebuild_root, set_semantics
from imt_tpu_torch.utils.observability import trace

HERE = os.path.dirname(os.path.abspath(__file__))

HEADLINE_ROUNDS = 9      # the median over the valid rounds
HEADLINE_REPS = 3        # timings per k per round, the least taken
HEADLINE_BATCH = 66560   # bench.py's headline batch
HEADLINE_KS = (5, 25)    # outer iterations timed: x CHAIN permutations
SMOKE_KS = (25, 225)     # --smoke, at 2048 lanes
CHAIN = 2                # permutations per K1 launch in the headline
CHECK_LANES = 4          # the headline's lanes held against the plain path
LIMB_MASK = 0x7FF        # bench.py:106


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def classify_round(rate: float, bound: float) -> bool:
    """True iff a measured round is a VALID sample: positive, finite, and
    not above the card's bound (a rate above what the card's IMAD rate
    allows for K1's least work is a corrupted timing, not a fast one)."""
    return 0 < rate <= bound


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def _stage(host, device):
    """Host limbs -> a tensor on `device`, before the timed window."""
    return torch.as_tensor(np.ascontiguousarray(host, dtype=np.int32),
                           device=device)


def device_info(device) -> dict:
    """Where a line's numbers were taken: the card's name and power limit
    as nvidia-smi reports them, and the card count; or the host CPU."""
    if _on_card(device):
        name, power = [x.strip() for x in
                       nvidia_smi("name,power.limit").split(",", 1)]
        return {"platform": "gpu", "name": name, "power_limit": power,
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "name": platform.processor() or
            platform.machine(), "power_limit": None, "count": 1}


def perm_bound(device) -> float | None:
    """K1's least-work rate on this card (perms/s), or None off the card."""
    if not _on_card(device):
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock = float(nvidia_smi("clocks.max.sm").split()[0])
    return perm_bound_per_s(sms, clock)


def headline_limbs(batch: int, seed: int, device):
    """The headline's state as limbs [16, 3 * batch], element j of lane i
    in column j * batch + i: every limb of lane i is (i ^ seed) & 0x7FF
    (``bench.py:104-110``)."""
    lanes = torch.arange(batch, dtype=torch.int32, device=device)
    return ((lanes ^ seed) & LIMB_MASK).repeat(3).expand(16, -1).contiguous()


def _perm_fns(device):
    """(permute_n, the headline's state from a seed) on `device`: the
    kernel on the card, the plain version on the CPU."""
    dev = torch.device(device)
    permute = poseidon_cuda.permute_n if _on_card(dev) \
        else poseidon.permute_n

    def state(batch: int, seed: int):
        nodes = hashing.enc_nodes(headline_limbs(batch, seed, dev))
        return nodes.view(8, 3, batch).transpose(0, 1).contiguous()
    return permute, state


def bench_perms(batch: int, k1: int = 2, k2: int = 6, device="cuda"):
    """K1's permutations/s (``bench.py``'s pallas-chain protocol): returns
    (rate, extras) with the per-round lists for the headline line."""
    dev = torch.device(device)
    permute, state = _perm_fns(dev)

    def run(k: int, seed: int):
        st = state(batch, seed)
        for _ in range(k):
            st = permute(st, CHAIN)
        out = st[..., :CHECK_LANES]
        _sync(dev)
        return out

    card_bound = perm_bound(dev)
    bound = card_bound if card_bound is not None else sys.float_info.max
    for k in (k1, k2):
        t0 = time.perf_counter()
        run(k, 1)
        log(f"k={k}: build+first {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        run(k, 1)
        log(f"k={k}: warm {time.perf_counter() - t0:.3f}s")
    rounds, rejected = [], []
    suspect = False
    for attempt in range(2):          # one full retry if ALL rejected
        for r in range(HEADLINE_ROUNDS):
            times = {k1: [], k2: []}
            for rep in range(HEADLINE_REPS):
                for k in (k1, k2):
                    t0 = time.perf_counter()
                    run(k, 2 + (attempt * HEADLINE_ROUNDS + r)
                        * HEADLINE_REPS + rep)
                    times[k].append(time.perf_counter() - t0)
            slope = (min(times[k2]) - min(times[k1])) / (k2 - k1)
            rate = batch * CHAIN / slope if slope > 0 else float("inf")
            ok = classify_round(rate, bound)
            (rounds if ok else rejected).append(rate)
            log(f"round {r}: {rate / 1e6:.3f} M perms/s"
                + ("" if ok else "  REJECTED (above the card's bound or "
                   "non-positive)"))
        if rounds:
            break
        log("all rounds rejected: retrying once")
    if not rounds:
        suspect = True
        rounds = [x for x in rejected if x != float("inf")] or [0.0]
        log("WARNING: headline is SUSPECT: every round was rejected")
    rate = statistics.median(rounds)
    spread = (max(rounds) - min(rounds)) / rate if rate else 0.0

    # correctness: the first lanes of seed 1 after k1 launches against the
    # plain version on the CPU
    got = run(k1, 1).cpu()
    plain, plain_state = _perm_fns("cpu")
    want = plain_state(CHECK_LANES, 1)     # the same first lanes
    for _ in range(k1):
        want = plain(want, CHAIN)
    correct = bool(torch.equal(got, want))
    log(f"median of {len(rounds)} valid rounds ({len(rejected)} rejected): "
        f"{rate / 1e6:.3f} M perms/s, spread {spread:.1%}; first "
        f"{CHECK_LANES} lanes equal the plain version: {correct}")
    extras = {
        "rounds_mps": [x / 1e6 for x in rounds],
        "rejected_mps": [x / 1e6 for x in rejected],
        "spread": spread,
        "sanity_bound_mps": None if card_bound is None else card_bound / 1e6,
        "protocol": (f"K1 launches of {CHAIN} chained permutations in an "
                     f"outer loop, min-of-{HEADLINE_REPS} interleaved "
                     f"timings/k, slope iters {k2}-{k1}, median of valid "
                     "rounds, each below the card's least-work bound"),
        "correct": correct,
    }
    if suspect:
        extras["suspect"] = True
    return rate, extras


def _rounds(rates: list) -> dict:
    """Every round's rate, round 0 marked dropped (``_median_rounds``), and
    the spread of the kept ones over their median."""
    kept = rates[1:] or rates
    med = statistics.median(kept)
    return {"rounds": [{"rate": r, "dropped": i == 0 and len(rates) > 1}
                       for i, r in enumerate(rates)],
            "spread": (max(kept) - min(kept)) / med if med else 0.0}


def bench_insert(depth: int, k: int, iters: int, device="cuda"):
    """Batched leaf-inserts/s into a dense tree (``bench.py --insert``):
    (rate, extras)."""
    log(f"building depth-{depth} tree ...")
    tree = indexed.IndexedMerkleTree(depth, device=device)
    rng = random.Random(0x1A5)
    # pre-pack every batch's limbs on the host (bench.py packs them and
    # passes numpy)
    batches = [field.ints_to_limbs(
        [rng.randrange(1, 1 << 253) for _ in range(k)])
        for _ in range(iters + 1)]
    t0 = time.perf_counter()
    oks = [tree.insert_batch(batches[0])]
    log(f"build+first batch: {time.perf_counter() - t0:.1f}s "
        f"(accepted {oks[0].sum()}/{k})")
    t0 = time.perf_counter()
    total = 0
    for vals in batches[1:]:
        oks.append(tree.insert_batch(vals))
        total += int(oks[-1].sum())
    tree.levels[-1].cpu()
    dt = time.perf_counter() - t0
    rate = total / dt
    log(f"{total} inserts in {dt:.3f}s -> {rate:,.0f} inserts/s "
        f"(depth {depth})")
    correct = bool(np.array_equal(np.concatenate(oks), set_semantics(
        np.concatenate(batches, axis=1)))) and \
        rebuild_root(tree) == tree.get_root_int()
    return rate, {**_rounds([rate]), "correct": correct}


def _median_rounds(run_round, rounds: int, tag: str):
    """Steady-state protocol: run `rounds` identical timed rounds, DISCARD
    the first (the first executions carry allocator and cache warm-up),
    report the median of the rest.  Returns (median, every round's
    rate)."""
    rates = []
    for r in range(rounds):
        rates.append(run_round(r))
        log(f"{tag} round {r}: {rates[-1]:,.0f}/s"
            + (" (warmup, discarded)" if r == 0 else ""))
    return (statistics.median(rates[1:]) if len(rates) > 1 else rates[0],
            rates)


def bench_non_inclusion(depth: int, n_leaves: int, k: int,
                        iters: int, rounds: int = 4, device="cuda"):
    """Config 2: non-membership witness + verify throughput.  Returns
    (rate, extras)."""
    tree = indexed.IndexedMerkleTree(depth, device=device)
    rng = random.Random(0xBEEF)
    tree.insert_batch([rng.randrange(1, 1 << 253)
                       for _ in range(n_leaves - 2)])
    # pre-stage all query batches on the card
    qbatches = [_stage(field.random_limbs(0xBEEF + i, k), device)
                for i in range(iters + 1)]
    _sync(device)

    def round_trip(qlimbs):
        # the witness stays on the card and goes straight into the verifier
        w = tree.non_inclusion_witness(qlimbs, as_numpy=False)
        return indexed.verify_non_inclusion(
            w.root, w.low_leaf_val, w.low_leaf_next_val, w.low_leaf_next_idx,
            w.low_leaf_proof, w.low_leaf_proof_helper, qlimbs,
            w.is_new_leaf_largest)

    t0 = time.perf_counter()
    round_trip(qbatches[0]).cpu()
    log(f"build+first: {time.perf_counter() - t0:.1f}s")
    last = {}

    def one_round(r):
        t0 = time.perf_counter()
        with trace(f"non_inclusion_d{depth}_k{k}"):
            oks = [round_trip(q) for q in qbatches[1:]]
            last["ok"] = torch.stack(oks).cpu()           # ONE final read
        return iters * k / (time.perf_counter() - t0)

    rate, rates = _median_rounds(one_round, rounds, "cfg2")
    return rate, {**_rounds(rates), "correct": bool(last["ok"].all())}


def bench_single_insert(depth: int, iters: int, chunk: int = 16,
                        device="cuda"):
    """Config 3: sequential witness inserts/s into a sparse tree.

    Strictly sequential semantics (each insert sees the previous one's
    tree, a full witness bundle per insert), in ``insert_seq`` chunks of
    `chunk`.  Returns (rate, extras)."""
    host = [field.random_limbs(0xF00D + i, chunk)
            for i in range(iters // chunk + 1)]
    chunks = [_stage(c, device) for c in host]
    _sync(device)

    def fresh():
        return SparseIndexedMerkleTree(depth, initial_capacity_log2=12,
                                       device=device)

    tree = fresh()
    t0 = time.perf_counter()
    tree.insert_seq(chunks[0])
    log(f"build+first chunk: {time.perf_counter() - t0:.1f}s")
    n = chunk * (len(chunks) - 1)
    last = {}

    def one_round(r):
        t = fresh()
        warm = t.insert_seq(chunks[0])          # SYNC warm (numpy ok)
        t0 = time.perf_counter()
        oks = [t.insert_seq(c, as_numpy=False).ok for c in chunks[1:]]
        ok = torch.cat(oks).cpu()                          # ONE final read
        rate = n / (time.perf_counter() - t0)
        last["ok"] = np.concatenate([warm.ok, ok.numpy()])
        return rate

    rate, rates = _median_rounds(one_round, 4, "cfg3")
    correct = bool(np.array_equal(last["ok"], set_semantics(
        np.concatenate(host, axis=1))))
    return rate, {**_rounds(rates), "correct": correct}


def batch_plan(k: int, iters: int) -> tuple:
    """(capacity log2, group, warm-up batches, timed groups) of configs
    3w/4/5 (``bench.py:405-463``): the prefix holds every batch; the
    chained groups are of 8 batches (1 under 8 iterations), after a warm-up
    group that is halved when a full warm-up and group would overflow
    the prefix."""
    cap = max(14, (k * (iters + 1) + 2).bit_length())
    group = 8 if iters >= 8 else 1
    wb = group if 2 * group * k < (1 << cap) - 1 else max(1, group // 2)
    return cap, group, wb, (iters + 1 - wb) // group


def bench_batch_insert_sparse(depth: int, k: int, iters: int,
                              witness: bool = False,
                              rounds: int = 4, device="cuda"):
    """Configs 3w/4/5: batched inserts/s into a sparse-prefix tree.

    witness=True measures the witness-producing batched path (every insert
    emits the full insert_leaf bundle).  Every round replays the SAME
    staged batches into a FRESH tree after a synchronous warm-up; round 0
    is discarded (``_median_rounds``).  Returns (rate, extras)."""
    cap, group, wb, n_g = batch_plan(k, iters)
    log(f"pre-packing {iters + 1} batches of {k} values ...")
    host = [field.random_limbs(0xCAFE + i, k) for i in range(iters + 1)]
    batches = [_stage(b, device) for b in host]
    _sync(device)

    def fresh():
        return SparseIndexedMerkleTree(depth, initial_capacity_log2=cap,
                                       device=device)

    last = {}
    if witness:
        tree = fresh()
        t0 = time.perf_counter()
        ok = tree.insert_batch(batches[0], witness=True).ok
        log(f"build+first batch: {time.perf_counter() - t0:.1f}s "
            f"(accepted {ok.sum()}/{k})")

        def one_round(r):
            t = fresh()
            # SYNC warm insert: an async warm-up would leak its device
            # time into the timed window
            warm = t.insert_batch(batches[0], witness=True).ok
            t0 = time.perf_counter()
            ws = []
            with trace(f"batch_insert_d{depth}_k{k}_w"):
                for vals in batches[1:]:
                    # as_numpy=False: the bundles stay on the card, so the
                    # batches queue behind one another
                    ws.append(t.insert_batch(vals, witness=True,
                                             as_numpy=False))
                oks = torch.stack([w.ok for w in ws]).cpu()   # ONE read
            rate = iters * k / (time.perf_counter() - t0)
            last.update(ok=np.concatenate([warm, oks.numpy().ravel()]),
                        w=ws[-1])
            return rate

        rate, rates = _median_rounds(one_round, rounds, "cfgW")
        w = last["w"]
        w.ok = w.ok.cpu().numpy()
        try:
            indexed.check_insert_witness(w)
            predicate = True
        except AssertionError as e:
            log(f"witness predicate: {e}")
            predicate = False
        correct = predicate and bool(np.array_equal(
            last["ok"], set_semantics(np.concatenate(host, axis=1))))
        return rate, {**_rounds(rates), "correct": correct}

    # plain batches: chained groups (insert_batches of `group` batches)
    warm_arr = torch.stack(batches[:wb])
    groups = [torch.stack(batches[wb + i * group:wb + (i + 1) * group])
              for i in range(n_g)]
    _sync(device)
    tree = fresh()
    t0 = time.perf_counter()
    ok = tree.insert_batches(warm_arr)
    log(f"build+first group of {wb}: {time.perf_counter() - t0:.1f}s "
        f"(accepted {ok.sum()}/{wb * k})")
    n_done = group * n_g * k

    def one_round(r):
        t = fresh()
        warm = t.insert_batches(warm_arr)                 # SYNC warm
        t0 = time.perf_counter()
        with trace(f"batch_insert_d{depth}_k{k}"):
            oks = [t.insert_batches(arr, as_numpy=False) for arr in groups]
            oks = torch.cat(oks).cpu()                    # ONE final read
        rate = n_done / (time.perf_counter() - t0)
        last.update(ok=np.concatenate([warm.ravel(), oks.numpy().ravel()]),
                    tree=t)
        return rate

    rate, rates = _median_rounds(one_round, rounds, "cfgB")
    t = last["tree"]
    stream = np.concatenate(host[:wb + n_g * group], axis=1)
    correct = bool(np.array_equal(last["ok"], set_semantics(stream))) \
        and rebuild_root(t) == t.get_root_int()
    return rate, {**_rounds(rates), "correct": correct}


def bench_oracle(batch: int, iters: int) -> float:
    """The port's C++ oracle (``native/``, 4x64-bit Montgomery, the
    reference's algorithm) hashing on one host core: the CPU baseline."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 62, (batch, 4), dtype=np.uint64)
    b = rng.integers(0, 1 << 62, (batch, 4), dtype=np.uint64)
    oracle.hash2_u64(a[:8], b[:8])                     # build + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        oracle.hash2_u64(a, b)
    dt = time.perf_counter() - t0
    rate = batch * iters / dt
    log(f"C++ oracle: {rate:,.0f} hashes/s ({2 * rate:,.0f} perms/s) "
        f"single-core")
    return rate


def result_line(metric: str, rate: float, unit: str, extras: dict,
          device) -> dict:
    return {"metric": metric, "value": rate, "unit": unit,
            "vs_baseline": None, "device": device_info(device), **extras}


def _peak_reset(device) -> None:
    if _on_card(device):
        torch.cuda.reset_peak_memory_stats(device)


def _peak_bytes(device):
    return torch.cuda.max_memory_allocated(device) if _on_card(device) \
        else None


def config_result(cfg: str, smoke: bool = False, device="cuda") -> dict:
    """One BASELINE config -> its JSON record (also used by --artifact)."""
    rounds = 2 if smoke else 4
    _peak_reset(device)
    if cfg == "2":
        rate, extras = bench_non_inclusion(8, 256, 8192, 2 if smoke else 8,
                                           rounds=rounds, device=device)
        metric, unit = "non-membership verifies/s (depth 8)", "verifies/s"
    elif cfg == "3":
        rate, extras = bench_single_insert(16, 8 if smoke else 256,
                                           chunk=4 if smoke else 64,
                                           device=device)
        metric, unit = "sequential witness inserts/s (depth 16)", "inserts/s"
    elif cfg == "3w":
        rate, extras = bench_batch_insert_sparse(
            16, 4096, 2 if smoke else 8, witness=True, rounds=rounds,
            device=device)
        metric, unit = ("witness-batch inserts/s (depth 16, batch 4096, "
                        "full insert_leaf bundles)", "inserts/s")
    elif cfg == "4":
        # iters=14 keeps the active prefix at 2^16 (15 batches of 4096)
        rate, extras = bench_batch_insert_sparse(
            24, 4096, 2 if smoke else 14, rounds=rounds, device=device)
        metric, unit = "batched inserts/s (depth 24, batch 4096)", "inserts/s"
    else:
        k, iters = (4096, 2) if smoke else (65536, 15)
        rate, extras = bench_batch_insert_sparse(32, k, iters, rounds=rounds,
                                                 device=device)
        metric, unit = (f"batched inserts/s (depth 32, batch {k}, ~1M total)",
                        "inserts/s")
    return {"config": cfg,
            **result_line(metric, rate, unit, extras, device),
            "peak_bytes": _peak_bytes(device)}


def _parity(device) -> dict:
    spec = importlib.util.spec_from_file_location(
        "parity_check_torch", os.path.join(HERE, "tools",
                                           "parity_check_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_parity(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--insert", action="store_true")
    ap.add_argument("--oracle", action="store_true",
                    help="the C++ oracle's hashes/s on one host core")
    ap.add_argument("--config", choices=["2", "3", "3w", "4", "5"],
                    help="BASELINE.md benchmark config")
    ap.add_argument("--artifact", action="store_true",
                    help="parity, then configs 2/3/3w/4/5 into "
                         "BENCH_configs_torch.json")
    ap.add_argument("--batch", type=int, default=HEADLINE_BATCH,
                    help="the headline's lanes (default 66560)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default): the kernels; cpu: the plain path")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        log("no CUDA device: bench_torch.py --device cuda needs one GPU "
            "(--device cpu runs the plain path)")
        return 1
    device = torch.device(args.device)

    if args.oracle:
        rate = bench_oracle(4096, 2 if args.smoke else 32)
        print(json.dumps({
            "metric": "C++ reference-equivalent Poseidon hashes/s (1 core)",
            "value": rate, "unit": "hashes/s", "vs_baseline": None,
            "device": device_info("cpu"), "correct": True}))
        return 0

    if args.artifact:
        log("=== parity (reference replay on the card) ===")
        parity = _parity(device)
        results = []
        for cfg in ["2", "3", "3w", "4", "5"]:
            log(f"=== config {cfg} ===")
            results.append(config_result(cfg, args.smoke, device))
        info = device_info(device)
        artifact = {
            "date": datetime.date.today().isoformat(),
            "device": info["name"], "power_limit": info["power_limit"],
            "parity": parity["parity"], "parity_checks": parity["checks"],
            "configs": results,
        }
        with open(os.path.join(HERE, "BENCH_configs_torch.json"), "w") as f:
            json.dump(artifact, f, indent=1)
        correct = all(r["correct"] for r in results)
        print(json.dumps({"metric": "configs recorded",
                          "value": len(results), "unit": "configs",
                          "vs_baseline": None, "device": info,
                          "correct": correct}))
        return 0 if correct else 1

    if args.config:
        line = config_result(args.config, args.smoke, device)
        print(json.dumps(line))
        return 0 if line["correct"] else 1

    if args.insert:
        depth, k, iters = (6, 8, 2) if args.smoke else (20, 1024, 4)
        _peak_reset(device)
        rate, extras = bench_insert(depth, k, iters, device=device)
        line = result_line(f"batched leaf-inserts/s (depth {depth})",
                           rate, "inserts/s", extras, device)
        line["peak_bytes"] = _peak_bytes(device)
        print(json.dumps(line))
        return 0 if line["correct"] else 1

    batch, (k1, k2) = (2048, SMOKE_KS) if args.smoke \
        else (args.batch, HEADLINE_KS)
    _peak_reset(device)
    rate, extras = bench_perms(batch, k1=k1, k2=k2, device=device)
    line = result_line("Poseidon perms/s/chip", rate, "perms/s", extras,
                       device)
    line["peak_bytes"] = _peak_bytes(device)
    print(json.dumps(line))
    return 0 if line["correct"] and not extras.get("suspect") else 1


if __name__ == "__main__":
    sys.exit(main())
