"""chip_smoke.py without a card (CPU): its depth-6 oracle replay and golden
path on CPU tensors, phase 6's host-side checkers on small inputs, its
kernel record and SASS census, and its refusal to run without CUDA or
outside a checkout."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from imt_tpu_torch.ops import field, vpu_roofline
from imt_tpu_torch.tree import indexed, reference_oracle
from imt_tpu_torch.tree.sparse import SparseIndexedMerkleTree

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
    _smoke_module().replay_small(indexed, reference_oracle,
                                 torch.device("cpu"))


def test_kernel_record_names_the_replaced_code():
    smoke = _smoke_module()
    bodies = list(vpu_roofline.BODIES)
    names = list(smoke.POSEIDON) + bodies
    launches = {p: dict.fromkeys(names, 1)
                for p in ("insert_batch", "sequential", "sparse_batches",
                          "witness_batch", "probe")}
    numbers = {"times": dict.fromkeys(names, (1.0, 2.0)),
               "bounds": dict.fromkeys(names, (0.5, "operations")),
               "probe_launches": dict.fromkeys(bodies, 1)}
    rec = smoke.kernel_record(dict.fromkeys(names, 0), launches, numbers)
    assert [e["name"] for e in rec["kernels"]] == [
        "hash3_leaf", "hash2_nodes", "nodes_to_limbs",
        "limbs_to_nodes"] + bodies
    assert [e["name"] for e in rec["off_path_kernels"]] == ["permute_n"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in rec["kernels"] + rec["off_path_kernels"]:
        assert keys <= set(e), e
        assert e["route"] == "cuda" and os.path.isfile(
            os.path.join(ROOT, e["source"]))
        path, line = e["replaces"].split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert f.readlines()[int(line) - 1].lstrip().startswith("def "), e
    launched = {e["name"]: e["launches"] for e in rec["kernels"]}
    assert launched["hash3_leaf"] == 4 and launched["limbs_to_nodes"] == 1
    assert launched["nodes_to_limbs"] == 3
    assert set(rec["kernels"][0]["paths"]) == {
        "insert_batch", "sequential", "sparse_batches", "witness_batch"}
    assert all(launched[b] == 1 for b in bodies)


def _fake_sass(every: dict, cond: dict) -> str:
    """A permute_kernel listing shaped like the built one: a perms loop
    around a round loop whose one forward branch skips a block."""
    lines = ["\t\tFunction : _ZN4anon14permute_kernelEPKjPjxi"]
    addr = [0x100]

    def emit(op, args="RZ"):
        lines.append(f"        /*{addr[0]:04x}*/                   {op} "
                     f"{args} ;  /* 0x0 */")
        addr[0] += 16

    perms_lo = addr[0]
    emit("IMAD.MOV.U32")
    rounds_lo = addr[0]
    for op, n in every.items():
        for _ in range(n):
            emit(op)
    skip_at = addr[0]
    emit("@!P1 BRA", "0x0")                   # patched below
    for op, n in cond.items():
        for _ in range(n):
            emit(op)
    lines[-1 - sum(cond.values())] = lines[-1 - sum(cond.values())].replace(
        "BRA 0x0", f"BRA {addr[0]:#x}")
    assert f"{skip_at:04x}" in lines[-1 - sum(cond.values())]
    emit("@P1 BRA", f"{rounds_lo:#x}")
    emit("@!P6 BRA", f"{perms_lo:#x}")
    emit("EXIT", "")
    return "\n".join(lines) + "\n\t\tFunction : other\n"


def test_sass_census_counts_the_round_loop():
    smoke = _smoke_module()
    every = {"IMAD.WIDE.U32": 1440, "IMAD.HI.U32": 96, "IMAD": 97,
             "IADD3": 3}
    cond = {"IMAD.WIDE.U32": 720, "IMAD.HI.U32": 48, "IMAD": 48}
    per = smoke.sass_census(_fake_sass(every, cond))
    assert per["IMAD.WIDE.U32"] == 65 * 1440 + 8 * 720
    assert per["IMAD.HI.U32"] + per["IMAD.WIDE.U32"] == 828 * 128
    assert per["IMAD"] == 65 * 97 + 8 * 48 and per["IADD3"] == 65 * 3
    with pytest.raises(AssertionError, match="wide multiplies"):
        smoke.sass_census(_fake_sass(dict(every, IADD3=3, **{
            "IMAD.WIDE.U32": 1441}), cond))


def _fake_hash2_sass(full: dict, partial: dict, straight: dict) -> str:
    """A hash2_kernel listing shaped like the built one: straight code, then
    two permutations of a full-round loop, a full round, a partial-round
    loop and a full-round loop."""
    lines = ["\t\tFunction : _ZN4anon12hash2_kernelEPKjS1_Pjx"]
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
        smoke.sparse_census(_fake_sass({"IMAD": 1}, {"IMAD": 1}).replace(
            "permute_kernel", "hash2_kernel"))


def test_ptxas_report_per_kernel():
    mangled = ("_ZN50_GLOBAL__N__d154033d_17_poseidon_bn254_cu_d88bd4e1"
               "{}EPKjS1_Pjx")
    log = "\n".join([
        "ptxas info    : 18592 bytes gmem",
        "ptxas info    : Function properties for "
        + mangled.format("12hash2_kernel"),
        "    48 bytes stack frame, 48 bytes spill stores, 56 bytes spill loads",
        "ptxas info    : Used 254 registers, used 0 barriers",
        "ptxas info    : Function properties for "
        + mangled.format("14permute_kernel"),
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 110 registers, used 0 barriers"])
    assert _smoke_module().ptxas_report(log) == {
        "hash2_kernel": (254, 48, 56), "permute_kernel": (110, 0, 0)}


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
    assert sum(smoke.PERM_WORK) * 1.7 < smoke.MONT_PER_PERM * (
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


def test_golden_path_matches_oracle_on_cpu():
    _smoke_module().golden_path(indexed, reference_oracle, field,
                                torch.device("cpu"))


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
