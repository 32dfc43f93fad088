"""chip_smoke.py without a card (CPU): its depth-6 oracle replay and golden
path on CPU tensors, phase 6's host-side checkers and phase 7's (the
resume's launch expectations, the group's set semantics, the trace's
kernel events, the plain version in chunks) on small inputs, its kernel
record and SASS censuses, and its refusal to run without CUDA or outside a
checkout."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from imt_tpu_torch.ops import field, vpu_roofline
from imt_tpu_torch.tree import indexed, reference_oracle
from imt_tpu_torch.tree.sparse import SparseIndexedMerkleTree
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _smoke_module():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _run(cwd, script):
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, cwd=cwd, timeout=120)


def test_small_replay_matches_oracle_on_cpu():
    """At depth 5, the least that holds its 24 values (the card runs it at
    depth 6): the same batches, duplicates, zeros and chains."""
    _smoke_module().replay_small(indexed, reference_oracle,
                                 torch.device("cpu"), depth=5)


def test_kernel_record_names_the_replaced_code():
    smoke = _smoke_module()
    bodies = list(vpu_roofline.BODIES)
    names = list(smoke.POSEIDON) + bodies
    paths = ("insert_batch", "sequential", "sparse_batches", "witness_batch",
             "resume", "watchdog_group", "drill", "sharded_nccl1", "sharded",
             "hash_fixed", "bench")
    launches = {p: dict.fromkeys(names, 1) for p in paths + ("probe",)}
    numbers = {"times": dict.fromkeys(names, (1.0, 2.0)),
               "bounds": dict.fromkeys(names, (0.5, "operations")),
               "probe_launches": dict.fromkeys(bodies, 1)}
    rec = smoke.kernel_record(dict.fromkeys(names, 0), launches, numbers)
    assert list(rec) == ["kernels"]
    assert [e["name"] for e in rec["kernels"]] == [
        "hash3_leaf", "hash2_nodes", "nodes_to_limbs",
        "limbs_to_nodes", "permute_n"] + bodies
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in rec["kernels"]:
        assert keys <= set(e), e
        assert e["route"] == "cuda" and os.path.isfile(
            os.path.join(ROOT, e["source"]))
        path, line = e["replaces"].split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert f.readlines()[int(line) - 1].lstrip().startswith("def "), e
    launched = {e["name"]: e["launches"] for e in rec["kernels"]}
    assert launched["hash3_leaf"] == 11 and launched["limbs_to_nodes"] == 3
    assert launched["nodes_to_limbs"] == 9
    assert rec["kernels"][4]["paths"] == {"hash_fixed": 1, "bench": 1}
    assert list(rec["kernels"][0]["paths"]) == list(paths)
    assert all(launched[b] == 1 for b in bodies)


def _fake_k1_sass(full: dict, partial: dict, straight: dict) -> str:
    """A permute_kernel listing shaped like the built one: straight code
    (the loads), a perms loop around one sparse-core permutation (a
    full-round loop, a full round, a partial-round loop, a full-round
    loop), then straight code again (the stores)."""
    lines = ["\t\tFunction : _ZN4anon14permute_kernelEPKjPjxi"]
    addr = [0]

    def emit(op, args="RZ"):
        lines.append(f"        /*{addr[0]:04x}*/                   {op} "
                     f"{args} ;  /* 0x0 */")
        addr[0] += 16

    def block(body, loop):
        top = addr[0]
        for op, n in body.items():
            for _ in range(n):
                emit(op)
        if loop:
            emit("@P0 BRA", f"{top:#x}")

    block(straight, False)
    perms = addr[0]
    emit("IMAD.MOV.U32")
    for body, loop in ((full, True), (full, False), (partial, True),
                       (full, True)):
        block(body, loop)
    emit("@!P6 BRA", f"{perms:#x}")
    block(straight, False)
    emit("EXIT", "")
    return "\n".join(lines) + "\n\t\tFunction : other\n"


def test_k1_census_counts_the_perms_loop():
    """K1's census counts one trip of the perms loop, its round loops 3, 57
    and 4 times, and nothing outside it; it holds the multiplies to the
    source's count of K1's core, and refuses another loop structure."""
    smoke = _smoke_module()
    # a full round: 3 products, 6 squares (100 wide each) and 3 dots (256);
    # a partial round: 3 products, 2 squares and a dot
    full = {"IMAD.WIDE.U32": 3 * 128 + 6 * 100 + 3 * 256, "IMAD": 12 * 8,
            "IADD3.X": 30}
    partial = {"IMAD.WIDE.U32": 3 * 128 + 2 * 100 + 256, "IMAD": 6 * 8,
               "IADD3.X": 11}
    straight = {"LDG.E": 24, "IMAD.WIDE.U32": 2}
    per = smoke.k1_census(_fake_k1_sass(full, partial, straight))
    assert per["IMAD.WIDE.U32"] == smoke.K1_WORK[0] == 61896 == \
        smoke.least_perm_work(1)[0]
    assert per["IMAD"] == smoke.K1_WORK[1] == 3504
    assert per["IMAD.MOV.U32"] == 1 and per["IADD3.X"] == 8 * 30 + 57 * 11
    assert "LDG.E" not in per and per["BRA"] == 3 + 57 + 4 + 1
    with pytest.raises(AssertionError, match="wide multiplies"):
        smoke.k1_census(_fake_k1_sass(
            full, dict(partial, **{"IMAD.WIDE.U32": 839}), {}))
    with pytest.raises(AssertionError, match="wide multiplies"):
        smoke.k1_census(_fake_k1_sass(
            full, dict(partial, **{"IMAD.WIDE.U32": 841}), {}))
    with pytest.raises(AssertionError, match="IMAD"):
        smoke.k1_census(_fake_k1_sass(full, dict(partial, IMAD=47), {}))
    with pytest.raises(AssertionError, match="expected 4 loops"):
        smoke.k1_census(_fake_hash2_sass(full, partial, straight).replace(
            "hash2_kernelILi1EE", "permute_kernelE"))


def _fake_hash2_sass(full: dict, partial: dict, straight: dict) -> str:
    """A hash2_kernel<1> listing shaped like the built one: straight code,
    then two permutations of a full-round loop, a full round, a
    partial-round loop and a full-round loop."""
    lines = ["\t\tFunction : _ZN4anon12hash2_kernelILi1EEEvPKjS2_Pjx"]
    addr = [0]

    def emit(op, args="RZ"):
        lines.append(f"        /*{addr[0]:04x}*/                   {op} "
                     f"{args} ;  /* 0x0 */")
        addr[0] += 16

    def block(body, loop):
        top = addr[0]
        for op, n in body.items():
            for _ in range(n):
                emit(op)
        if loop:
            emit("@P0 BRA", f"{top:#x}")

    block(straight, False)
    for _ in range(2):
        for body, loop in ((full, True), (full, False), (partial, True),
                           (full, True)):
            block(body, loop)
    emit("EXIT", "")
    return "\n".join(lines) + "\n\t\tFunction : other\n"


def test_sparse_census_counts_both_permutations():
    smoke = _smoke_module()
    full = {"IMAD.WIDE.U32": 18 * 128, "IMAD": 18 * 8, "IADD3.X": 30}
    partial = {"IMAD.WIDE.U32": 8 * 128, "IMAD": 8 * 8, "IADD3.X": 11}
    straight = {"LDG.E": 24, "IMAD.WIDE.U32": 2}
    per = smoke.sparse_census(_fake_hash2_sass(full, partial, straight))
    assert per["IMAD.WIDE.U32"] == 600 * 128 + 1
    assert smoke.SPARSE_MONT_PER_PERM == 600 and per["IMAD"] == 600 * 8
    assert per["IADD3.X"] == 8 * 30 + 57 * 11
    assert per["LDG.E"] == 12 and per["BRA"] == 3 + 57 + 4
    # squares may share row 0's symmetric products: 7 of 128 in 6 of a full
    # round's 18 products and 2 of a partial round's 8
    shared = smoke.sparse_census(_fake_hash2_sass(
        dict(full, **{"IMAD.WIDE.U32": 18 * 128 - 6 * 7}),
        dict(partial, **{"IMAD.WIDE.U32": 8 * 128 - 2 * 7}), {}))
    assert shared["IMAD.WIDE.U32"] == 600 * 128 - (8 * 6 + 57 * 2) * 7
    # the carry-chained rows as mad.lo.cc / madc.hi.cc: the high halves are
    # IMAD.HI.U32, the low ones IMAD
    hi_lo = lambda n: {"IMAD.HI.U32": n * 128, "IMAD": n * 136}
    per = smoke.sparse_census(_fake_hash2_sass(hi_lo(18), hi_lo(8), {}))
    assert per["IMAD.HI.U32"] == 600 * 128 and per["IMAD"] == 600 * 136
    with pytest.raises(AssertionError, match="wide multiplies"):
        smoke.sparse_census(_fake_hash2_sass(
            full, dict(partial, **{"IMAD.WIDE.U32": 8 * 128 + 1}), {}))
    with pytest.raises(AssertionError, match="6 disjoint loops"):
        smoke.sparse_census(_fake_k1_sass(full, partial, {}).replace(
            "permute_kernelE", "hash2_kernelILi1EE"))
    # the cooperative kernel's listing is not the sparse core's
    with pytest.raises(ValueError):
        smoke.sparse_census(_fake_hash2_sass(full, partial, straight).replace(
            "ILi1EE", "ILi4EE"))


# instructions of one application of each probe body, as the built loop
# has them (mod4: 3 floors on the conversion unit, 1 on the FP32 pipe)
PROBE_APP = {
    "mul": {"FMUL": 1}, "muladd": {"FMUL": 1, "FADD": 1},
    "mul16": {"FMUL": 16}, "fma16": {"FMUL": 16, "FADD": 16},
    "mod4": {"FMUL": 8, "FADD": 5, "FRND.FLOOR": 3, "FADD.RM": 1,
             "LOP3.LUT": 2, "FSETP.GEU.AND": 1, "FSEL": 1},
    "ilp16": {"FMUL": 9, "FADD": 6}, "imad16": {"IMAD": 16},
    "cios16": {"IMAD.WIDE.U32": 16, "IMAD": 2, "IADD3": 8, "IADD3.X": 8},
    "wide16": {"IMAD.WIDE.U32": 16, "IADD3": 16, "LOP3.LUT": 1}}
PROBE_UNROLL = {"mul": 16, "muladd": 16, "cios16": 4}


def _fake_probe_sass(apps: dict) -> str:
    """The probe library's listing shaped like the built one: per body a
    roofline_kernel<id, type> with a grid-stride loop of 4-element groups
    around the unrolled k loop and its remainder loop, then the scalar
    loop around the same two k loops over one element."""
    lines, addr = [], [0]

    def emit(op, args="RZ"):
        lines.append(f"        /*{addr[0]:04x}*/                   {op} "
                     f"{args} ;  /* 0x0 */")
        addr[0] += 16

    def loop(body, times):
        top = addr[0]
        for op, n in body.items():
            for _ in range(n * times):
                emit(op)
        emit("VIADD")
        emit("ISETP.NE.AND")
        emit("@P0 BRA", f"{top:#x}")

    for i, (name, app) in enumerate(apps.items()):
        t = "f" if i < 6 else "j"
        lines.append(f"\t\tFunction : _ZN12_GLOBAL__N_115roofline_kernelILi"
                     f"{i}E{t}EEvPKT0_PS1_xxiS1_S1_")
        addr[0] = 0
        for v in (4, 1):
            outer = addr[0]
            emit("LDG.E.128" if v == 4 else "LDG.E")
            loop(app, v * PROBE_UNROLL.get(name, 2))
            loop(app, v)
            emit("STG.E.128" if v == 4 else "STG.E")
            emit("@P1 BRA", f"{outer:#x}")
        emit("EXIT", "")
    return "\n".join(lines) + "\n"


def test_probe_census_counts_one_application():
    """The probe's census takes each body's unrolled 4-element k loop,
    divides by its applications, and holds the body's own instructions;
    it refuses a loop that lacks them, or that loads or stores local
    memory."""
    smoke = _smoke_module()
    census = smoke.probe_census(_fake_probe_sass(PROBE_APP),
                                vpu_roofline.BODIES)
    assert list(census) == list(vpu_roofline.BODIES)
    for name, (apps, cls, by_op) in census.items():
        trip = 4 * PROBE_UNROLL.get(name, 2)
        assert apps == trip, name
        assert by_op["BRA"] == by_op["VIADD"] == 1 / trip
        for op, n in PROBE_APP[name].items():
            assert by_op[op] == n, (name, op)
    assert census["mul"][1]["FP32"] == 1 and census["mul"][1]["branch"] == \
        1 / 64 and census["mul"][1]["other"] == 2 / 64
    mod4 = census["mod4"][1]
    assert (mod4["FP32"], mod4["FRND"], mod4["other"]) == (14, 3, 4 + 2 / 8)
    cios = census["cios16"][1]
    assert (cios["IMAD.WIDE"], cios["IMAD"], cios["IADD3"]) == (16, 2, 16)
    for name, bad in (("cios16", {"IMAD": 1}),
                      ("wide16", {"IMAD.WIDE.U32": 15}),
                      ("mod4", {"FRND.FLOOR": 2}),
                      ("fma16", {"FADD": 15}),
                      ("imad16", {"IMAD": 15}),
                      ("cios16", {"STL.64": 1}),
                      ("mul", {"LDL": 1})):
        with pytest.raises(AssertionError, match="probe " + name):
            smoke.probe_census(_fake_probe_sass(
                dict(PROBE_APP, **{name: dict(PROBE_APP[name], **bad)})),
                vpu_roofline.BODIES)


def test_second_bounds_from_the_census():
    """The second bounds: mod4 at its floors' conversion unit at the best
    split of its floors (the FP32 pipe's floor at the instructions the
    census gives it), cios16 at the IMAD pipe its function needs (16 wide
    multiply-adds at the measured slots, 2 IMAD), wide16 at its 16 wide
    multiply-adds, the other bodies at the published peak, and K1-K3 at
    their least work with each wide multiply-add at the measured slots; the
    slots from wide16's time an application against imad16's."""
    smoke = _smoke_module()
    census = smoke.probe_census(_fake_probe_sass(PROBE_APP),
                                vpu_roofline.BODIES)
    imad_per_s = 132 * 64 * 1980e6
    need, split, per = smoke.mod4_best_split(census["mod4"][2])
    assert per == pytest.approx(6)       # FADD.RM, FADD, 2 LOP3, FSETP, FSEL
    assert split == pytest.approx(16 / 52)
    assert need == pytest.approx(12 + 4 * (1 - split + 6 * split))
    assert need == pytest.approx(32 * (1 - split))
    app_s, by = smoke.unit_per_app_s(vpu_roofline, "mod4", census,
                                     imad_per_s, 2)
    assert by.startswith("FRND") and app_s == pytest.approx(
        need / vpu_roofline.F32_PEAK_PER_S)
    for slots in (1, 2):
        app_s, by = smoke.unit_per_app_s(vpu_roofline, "cios16", census,
                                         imad_per_s, slots)
        assert by.startswith("IMAD pipe") and app_s == pytest.approx(
            (slots * 16 + 2) / imad_per_s)
        app_s, by = smoke.unit_per_app_s(vpu_roofline, "wide16", census,
                                         imad_per_s, slots)
        assert app_s == pytest.approx(slots * 16 / imad_per_s)
        assert by.startswith("IMAD pipe" if slots > 1 else "published")
    for name in ("mul", "mul16", "imad16"):
        assert smoke.unit_per_app_s(vpu_roofline, name, census, imad_per_s,
                                    2)[1] == "published peak"
    for ratio, slots in ((2.0, 2), (1.1, 1), (2.41, 2), (2.6, 3), (0.5, 1)):
        est, got = smoke.wide_slots(census, {"imad16": 1.0, "wide16": ratio,
                                             "cios16": 9.0})
        assert est == pytest.approx(ratio) and got == slots
    one = smoke.poseidon_bound_ms("permute_n", 1 << 17, imad_per_s)[0]
    wide, narrow = smoke.LANE_WORK["permute_n"]
    assert smoke.unit_bound_ms("permute_n", 1 << 17, imad_per_s, 2) == \
        pytest.approx(one * (2 * wide + narrow) / (wide + narrow))
    assert smoke.unit_bound_ms("permute_n", 1 << 17, imad_per_s, 1) == \
        pytest.approx(one)
    assert smoke.unit_bound_ms("nodes_to_limbs", 8192, imad_per_s, 2) == \
        pytest.approx(smoke.poseidon_bound_ms("nodes_to_limbs", 8192,
                                              imad_per_s)[0])


def test_ptxas_report_per_kernel():
    mangled = ("_ZN50_GLOBAL__N__d154033d_17_poseidon_bn254_cu_d88bd4e1"
               "{}EPKjS1_Pjx")
    log = "\n".join([
        "ptxas info    : 18592 bytes gmem",
        "ptxas info    : Function properties for "
        + mangled.format("12hash2_kernelILi4EE"),
        "    48 bytes stack frame, 48 bytes spill stores, 56 bytes spill loads",
        "ptxas info    : Used 254 registers, used 0 barriers",
        "ptxas info    : Function properties for "
        + mangled.format("14permute_kernel"),
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 110 registers, used 0 barriers"])
    assert _smoke_module().ptxas_report(log) == {
        "hash2_kernel<4>": (254, 48, 56), "permute_kernel": (110, 0, 0)}
    probe = "\n".join([
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115"
        "roofline_kernelILi7EjEEvPKT0_PS1_xxiS1_S1_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, used 0 barriers"])
    assert _smoke_module().ptxas_report(probe) == {
        "roofline_kernel<7>": (90, 0, 0)}


def test_bound_counts_the_least_work_schedule():
    from imt_tpu.ops import poseidon_opt, poseidon_ref
    smoke = _smoke_module()
    params = poseidon_ref.generate_params()
    assert (smoke.R_F, smoke.R_P) == (params.r_f, params.r_p)
    # g = 1: every partial round reduces its row 0 (3 products) and both
    # columns (a product and the old word each)
    sbox = 2 * 36 + 64 + 3 * 64
    full, partial = 3 * (sbox + 3 * 64 + 64), sbox + (3 + 2) * 64 + 3 * 64
    assert smoke.least_perm_work(1) == (8 * full + 57 * partial,
                                        8 * 3 * 32 + 57 * 48)
    # the least is at g = 2, where the lazy schedule is still the
    # permutation, and it is well below what the kernel executes
    assert smoke.PERM_WORK == smoke.least_perm_work(2) == (60104, 3056)
    state = [3, 1 << 200, params.mds[0][1]]
    assert poseidon_opt.permute_opt_lazy(
        state, poseidon_opt.optimize_params(params), 2) == \
        poseidon_ref.permute(state, params)
    assert sum(smoke.PERM_WORK) * 1.25 < smoke.SPARSE_MONT_PER_PERM * (
        smoke.WIDE_PER_MONT + smoke.NARROW_PER_MONT)


def test_phase6_set_semantics_and_list_walk():
    """The numpy checkers of phase 6: first occurrences of nonzero values
    are accepted; the list walk follows next_idx from slot 0 and refuses a
    list out of order, a wrong next_val or a cycle."""
    import numpy as np
    smoke = _smoke_module()
    big = (1 << 200) + 5
    stream = field.ints_to_limbs([5, 7, 5, 0, big, 7, 3, big + 1])
    assert smoke.set_semantics(stream).tolist() == [
        True, True, False, False, True, False, True, True]
    # slots: 0 sentinel, 1 = 7, 2 = 3, 3 = 5, 4 = 0 (empty)
    vals = field.ints_to_limbs([0, 7, 3, 5, 0])
    nvs = field.ints_to_limbs([3, 0, 5, 7, 0])
    nis = field.ints_to_limbs([2, 0, 3, 1, 0])
    assert smoke.list_walk(vals, nvs, nis).tolist() == [2, 3, 1]
    accepted = field.ints_to_limbs([7, 5, 3])
    assert np.array_equal(vals[:, [2, 3, 1]],
                          accepted[:, smoke.lex_order(accepted)])
    assert smoke.strictly_increasing(field.ints_to_limbs([0, 1, big]))
    assert not smoke.strictly_increasing(field.ints_to_limbs([1, big, big]))
    bad_nv = nvs.copy()
    bad_nv[:, 2] = field.int_to_limbs(6)
    bad_order = vals.copy()
    bad_order[:, [2, 3]] = bad_order[:, [3, 2]]
    cycle = nis.copy()
    cycle[:, 1] = field.int_to_limbs(2)
    for args, msg in (((vals, bad_nv, nis), "next_val"),
                      ((bad_order, field.ints_to_limbs([5, 0, 3, 7, 0]),
                        nis), "increasing"),
                      ((vals, field.ints_to_limbs([3, 3, 5, 7, 0]), cycle),
                       "cycle")):
        with pytest.raises(AssertionError, match=msg):
            smoke.list_walk(*args)


@pytest.mark.parametrize("seed_offset,n,k", [(6, 16, 65536), (1, 4, 4096)])
def test_phase8_regenerates_the_planted_streams(seed_offset, n, k):
    """Phase 8's ranks regenerate config 5's stream (phase 6's seed, 16 x
    65536) and phase 4's (4 x 4096) with planted_stream: the same batches
    as the loop phases 4 and 6 ran inline, planting included (16 zeros and
    32 intra-batch duplicates a batch, 16 values of the batch before)."""
    import numpy as np
    smoke = _smoke_module()
    rng = np.random.default_rng(smoke.SEED + seed_offset)
    want, prev = [], None
    for _ in range(n):
        b = smoke.plant(rng, field.random_limbs(int(rng.integers(1 << 31)),
                                                k, 253), prev)
        want.append(b)
        prev = b
    got = smoke.planted_stream(field, smoke.SEED + seed_offset, n, k)
    assert len(got) == n
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(int((~b.any(axis=0)).sum()) == 16 for b in got)
    first = set(map(tuple, got[0].T.tolist()))
    assert sum(tuple(c) in first for c in got[1].T.tolist()) >= 16


def test_phase8_byte_audit_comparison():
    """exchange_sizes picks the candidate exchanges out of a program's
    counted calls; audit_sizes lists each program's distinct calls."""
    smoke = _smoke_module()
    chain = [("candidates", 144), ("leaf_hashes", 64), ("candidates", 144),
             ("leaf_hashes", 64), ("roots", 128)]
    one = [("candidates", 144), ("leaf_hashes", 64), ("roots", 128)]
    assert smoke.exchange_sizes(chain) == [144, 144]
    assert set(smoke.exchange_sizes(chain)) == set(smoke.exchange_sizes(one))
    leaky = [("all_gather", 4096)] + one
    assert smoke.exchange_sizes(leaky) == [144]
    assert smoke.audit_sizes({"insert_batches": chain, "read": []}) == {
        "insert_batches": [("candidates", 144), ("leaf_hashes", 64),
                           ("roots", 128)], "read": []}


def test_phase6_spine_fold_and_root_chain():
    """fold_int folds a prefix root over the python-int zero roots, as the
    tree's own spine does; root_int decodes a kept prefix root as
    get_root_int does; check_root_chain accepts a chained series and
    refuses a broken one."""
    from types import SimpleNamespace
    smoke = _smoke_module()
    z = indexed._zero_level_roots(6)
    assert smoke.zero_roots(6) == list(z)
    assert smoke.fold_int(z[2], 2, 6) == z[6]
    assert smoke.fold_int(123, 4, 4) == 123
    t = SparseIndexedMerkleTree(3, initial_capacity_log2=1, device="cpu")
    assert t.active_depth == 1
    assert smoke.root_int(field, indexed, t, t.levels[-1].clone()) == z[3]
    w = SimpleNamespace(old_root=torch.as_tensor(field.ints_to_limbs(
        [1, 2, 3])), new_root=torch.as_tensor(field.ints_to_limbs([2, 3, 4])))
    smoke.check_root_chain(field, w, 1, 4)
    for before, after in ((0, 4), (1, 3)):
        with pytest.raises(AssertionError, match="chain"):
            smoke.check_root_chain(field, w, before, after)
    w.new_root = torch.as_tensor(field.ints_to_limbs([2, 9, 4]))
    with pytest.raises(AssertionError, match="chain"):
        smoke.check_root_chain(field, w, 1, 4)


def test_phase7_resume_launches_and_group_semantics():
    """The resume of config 5 launches hash3 once and hash2 once per held
    level, then the root read one hash2 per level above and one decode;
    the group's set semantics count the values before it."""
    import numpy as np
    smoke = _smoke_module()
    assert smoke.resume_launches(21, 32) == (
        {"hash3_leaf": 1, "hash2_nodes": 21},
        {"hash2_nodes": 11, "nodes_to_limbs": 1})
    prior = field.ints_to_limbs([5, 7, 5, 0])
    group = np.stack([field.ints_to_limbs([9, 5, 9]),
                      field.ints_to_limbs([0, 11, 7])])
    assert smoke.group_semantics(prior, group).tolist() == [
        [True, False, False], [False, True, False]]
    from imt_tpu_torch.utils import observability
    start = smoke.launched()
    observability.count("cuda.hash2_nodes", 3)
    observability.count("hash2.launches", 2)      # a dispatch, not a launch
    observability.count("cuda.nodes_to_limbs", 1)
    assert smoke.launched(start) == {
        "hash3_leaf": 0, "hash2_nodes": 3, "nodes_to_limbs": 1,
        "limbs_to_nodes": 0, "permute_n": 0}
    assert smoke.launched(start, nonzero=True) == {"hash2_nodes": 3,
                                                   "nodes_to_limbs": 1}
    mid = smoke.launched()
    observability.count("cuda.permute_n", 2)
    assert smoke.launched(mid, nonzero=True) == {"permute_n": 2}


def test_phase7_trace_kernels(tmp_path):
    """Kernel events naming the hash2 kernel's symbol, in a Chrome trace
    shaped as torch.profiler writes it; CPU ops of the same name do not
    count."""
    import json
    smoke = _smoke_module()
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "hash2_kernel(unsigned int const*)",
         "dur": 5},
        {"cat": "kernel", "name": "void at::native::sort()", "dur": 1},
        {"cat": "cpu_op", "name": "hash2_kernel", "dur": 9},
        {"ph": "M", "name": "process_name"}]}))
    got = smoke.trace_kernels(str(path), smoke.HASH2_SYMBOL)
    assert [e["dur"] for e in got] == [5]


def test_phase9_witness_batch_against_the_native_tree():
    """Phase 9b's check at depth 4 on the CPU: two witness batches (the
    second with duplicates of the first and a zero) against the C++ tree's
    inserts one by one; then a rejected lane's differing low leaf passes
    and an accepted lane's changed field or a flipped ok fails."""
    import numpy as np
    from imt_tpu_torch.native import oracle
    smoke = _smoke_module()
    tree = indexed.IndexedMerkleTree(4, device="cpu")
    nat = oracle.NativeIndexedTree(4)
    fields = set(indexed.InsertWitness.__dataclass_fields__) - {"ok"}
    for vals in ([30, 10, 20, 10, 0, field.P - 1], [5, 30, 50, 35, 5]):
        w = tree.insert_batch(vals, witness=True)
        wits = [nat.insert(v) for v in vals]
        assert set(smoke.native_witness_arrays(field, wits, 4)) == fields
        assert smoke.check_native_witness(field, w, wits, 4) == \
            int(w.ok.sum())
        assert tree.get_root_int() == nat.get_root()
    rejected = int(np.flatnonzero(~w.ok)[0])
    assert field.limbs_to_int(w.low_leaf_val[:, rejected]) != \
        wits[rejected]["low_leaf"][0]
    w.new_leaf_proof[2, 0, 0] ^= 1
    with pytest.raises(AssertionError, match="new_leaf_proof"):
        smoke.check_native_witness(field, w, wits, 4)
    w.new_leaf_proof[2, 0, 0] ^= 1
    w.ok[rejected] = True
    with pytest.raises(AssertionError, match="ok differs"):
        smoke.check_native_witness(field, w, wits, 4)


def test_phase3_widths_add_the_crossover():
    """Phase 3 holds the hash kernels at their crossover and its two
    neighbours, beside the main paths' widths, widest first."""
    smoke = _smoke_module()
    got = smoke.phase3_widths(12672)
    assert set(got) == set(smoke.PHASE3_WIDTHS) | {12671, 12672, 12673}
    assert list(got) == sorted(got, reverse=True)
    assert min(smoke.phase3_widths(0)) == 1


def test_phase3_plain_in_chunks_equals_one_call():
    """The plain version over the lanes in chunks equals one call over the
    whole width (phase 3's widest checks run it so)."""
    from imt_tpu_torch.ops import poseidon
    smoke = _smoke_module()
    x = torch.as_tensor(field.random_limbs(3, 5))
    y = torch.as_tensor(field.random_limbs(4, 5))
    assert torch.equal(smoke.chunked(poseidon.limbs_to_nodes, (x,), 2),
                       poseidon.limbs_to_nodes(x))
    assert torch.equal(smoke.chunked(lambda a, b: a + b, (x, y), 3), x + y)
    assert smoke.edge_values(field)[2:4] == [field.P - 1, field.P]


def _bench_results():
    """Phase 10's inputs as bench_torch.py makes them on a passing run."""
    parity = {"parity": True, "device": "card",
              "checks": {"sequential_replay_d3": True,
                         "batched_sparse_d32": True,
                         "witness_batch_predicate": True}}
    headline = {"metric": "Poseidon perms/s/chip", "value": 55.0e6,
                "rounds_mps": [55.0, 54.9, 55.2], "rejected_mps": [],
                "sanity_bound_mps": 264.8, "correct": True}
    lines = [{"config": c, "correct": True}
             for c in _smoke_module().BENCH_CONFIGS]
    return parity, headline, lines


def test_phase10_checks_the_bench_lines():
    """check_bench passes a run whose parity, headline and five configs
    are sound, and fails one with a config whose correct is false, an
    accepted round above the card's bound, a suspect headline, a parity
    check that failed, a missing config or wrong headline lanes."""
    import copy
    smoke = _smoke_module()
    assert smoke.BENCH_CONFIGS == ("2", "3", "3w", "4", "5")
    smoke.check_bench(*_bench_results())
    breaks = {
        "correct is false": lambda p, h, l: l[3].update(correct=False),
        "above the card's bound": lambda p, h, l: h["rounds_mps"].append(
            300.0),
        "suspect": lambda p, h, l: h.update(suspect=True),
        "parity": lambda p, h, l: p["checks"].update(
            batched_sparse_d32=False),
        "every config": lambda p, h, l: l.pop(),
        "plain version": lambda p, h, l: h.update(correct=False),
    }
    for msg, brk in breaks.items():
        args = copy.deepcopy(_bench_results())
        brk(*args)
        with pytest.raises(AssertionError, match=msg):
            smoke.check_bench(*args)
    no_bound = copy.deepcopy(_bench_results())
    no_bound[1]["sanity_bound_mps"] = None
    with pytest.raises(AssertionError, match="bound"):
        smoke.check_bench(*no_bound)


def test_golden_path_matches_oracle_on_cpu():
    """At depth 3, the least that holds its 6 values (the card runs it at
    depth 6): every witness field and root of each insert."""
    _smoke_module().golden_path(indexed, reference_oracle, field,
                                torch.device("cpu"), depth=3)


def test_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = _run(ROOT, SMOKE)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_failing_rank_fails_the_run(tmp_path, monkeypatch):
    """start_ranks: a rank that raises stops the others, and the parent
    raises with its traceback."""
    monkeypatch.syspath_prepend(ROOT)
    target = tmp_path / "t.py"
    target.write_text(
        "def main(rank, world):\n"
        "    if rank == 1:\n"
        "        raise ValueError('rank one refuses')\n"
        "    import torch, torch.distributed as dist\n"
        "    dist.barrier()\n")
    ranks = _smoke_module().start_ranks(f"{target}:main", 2, {},
                                        str(tmp_path / "w"), timeout=60.0)
    with pytest.raises(RuntimeError, match="rank one refuses"):
        ranks.wait()
    assert not any(p.is_alive() for p in ranks.context.processes)


def test_a_hanging_rank_times_out(tmp_path, monkeypatch):
    """start_ranks: ranks still running at the deadline raise TimeoutError
    and are stopped."""
    monkeypatch.syspath_prepend(ROOT)
    target = tmp_path / "t.py"
    target.write_text(
        "import time\n"
        "def main(rank, world):\n"
        "    time.sleep(600)\n")
    ranks = _smoke_module().start_ranks(f"{target}:main", 2, {},
                                        str(tmp_path / "w"), timeout=8.0)
    with pytest.raises(TimeoutError, match="ran past"):
        ranks.wait()
    assert not any(p.is_alive() for p in ranks.context.processes)
