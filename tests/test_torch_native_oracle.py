"""The port's C++ native oracle (``imt_tpu_torch.native.oracle``) on the
CPU: the cases of ``tests/test_native_oracle.py`` against the port's
python-int oracle and its CPU tree, the same inputs through
``imt_tpu.native.oracle`` (C++ only: no XLA program is compiled), the limb
bridge, and the ASan/UBSan build in a subprocess (the counterpart of
``tests/test_sanitizers.py``'s first case).  Tolerance: exact."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from imt_tpu.native import oracle as jax_oracle
from imt_tpu_torch.native import oracle
from imt_tpu_torch.ops import field, poseidon
from imt_tpu_torch.ops.poseidon_ref import hash_fixed
from imt_tpu_torch.ops.poseidon_spec import default_params
from imt_tpu_torch.tree.indexed import IndexedMerkleTree
from imt_tpu_torch.tree.reference_oracle import OracleIndexedTree, OracleTree
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = field.P
ANCHOR = 1960587138944869480785025106734196872454309951825657414575195034687326603497
WITNESS_KEYS = ("ok", "old_root", "new_root", "low_leaf", "new_leaf",
                "low_leaf_proof", "new_leaf_proof", "low_leaf_proof_helper",
                "new_leaf_proof_helper", "new_leaf_index",
                "is_new_leaf_largest")
rng = random.Random(0xCC)


@pytest.fixture(scope="module", autouse=True)
def jax_oracle_apart(tmp_path_factory):
    """imt_tpu's binding builds its library beside its source; here it
    builds into this module's own directory, so that no other test process
    can load a half-written library while this one builds it."""
    lib = str(tmp_path_factory.mktemp("jax_oracle") / "libimt_native.so")
    saved = jax_oracle._LIB
    if jax_oracle._lib is None:
        jax_oracle._LIB = lib
    yield
    jax_oracle._LIB = saved


def test_hash_zero_anchor():
    assert oracle.hash3([0], [0], [0]) == [ANCHOR]


@pytest.mark.parametrize("arity", [2, 3])
def test_hash_parity(arity):
    """hash2 / hash3 equal the port's python sponge and imt_tpu's C++
    oracle on the same inputs, 0 and p - 1 among them."""
    cols = [[0, P - 1] + [rng.randrange(P) for _ in range(30)]
            for _ in range(arity)]
    cols[-1][:2] = cols[-1][1::-1]
    fn = {2: oracle.hash2, 3: oracle.hash3}[arity]
    ref = {2: jax_oracle.hash2, 3: jax_oracle.hash3}[arity]
    got = fn(*cols)
    params = default_params()
    assert got == [hash_fixed(list(v), params) for v in zip(*cols)]
    assert got == ref(*cols)


def test_field_ops_bulk():
    n = 5000
    xs = [rng.randrange(P) for _ in range(n)]
    ys = [rng.randrange(P) for _ in range(n)]
    muls = oracle.mul_mod(xs, ys)
    adds = oracle.add_mod(xs, ys)
    for i in range(0, n, 503):
        assert muls[i] == xs[i] * ys[i] % P
        assert adds[i] == (xs[i] + ys[i]) % P
    assert oracle.mul_mod([P - 1], [P - 1]) == [1]
    assert oracle.add_mod([P - 1], [1]) == [0]
    assert oracle.add_mod([P - 1], [P - 1]) == [P - 2]
    assert oracle.mul_mod([0], [123]) == [0]


def test_tree_build_parity():
    leaves = [rng.randrange(P) for _ in range(8)]
    expect = [x for lvl in OracleTree(leaves).levels for x in lvl]
    assert oracle.tree_build(leaves) == expect
    with pytest.raises(ValueError, match="2\\^k"):
        oracle.tree_build(leaves[:6])


def test_limb_bridge_and_hashes_against_the_plain_path():
    """limbs_to_u64 / u64_to_limbs round-trip the port's canonical limbs,
    and the oracle's raw hashes equal the plain torch path's on values the
    hashes must reduce (p, 2^256 - 1)."""
    vals = [0, 1, P - 1, P, (1 << 256) - 1, 2 ** 200 + 7]
    limbs = field.ints_to_limbs([v % P for v in vals])
    raw = np.stack([np.array([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                             dtype=np.int32) for v in vals], axis=1)
    for x in (limbs, raw):
        u = oracle.limbs_to_u64(x)
        assert u.shape == (len(vals), 4) and u.dtype == np.uint64
        assert np.array_equal(oracle.u64_to_limbs(u), x)
    assert oracle.u64_to_ints(oracle.limbs_to_u64(raw)) == vals
    a, b, c = (np.roll(raw, s, axis=1) for s in (0, 1, 2))
    u = [oracle.limbs_to_u64(x) for x in (a, b, c)]
    t = [torch.as_tensor(x) for x in (a, b, c)]
    assert np.array_equal(oracle.u64_to_limbs(oracle.hash2_u64(*u[:2])),
                          poseidon.hash2(*t[:2]).numpy())
    assert np.array_equal(oracle.u64_to_limbs(oracle.hash3_u64(*u)),
                          poseidon.hash3(*t).numpy())
    with pytest.raises(ValueError, match="uint64"):
        oracle.hash2_u64(u[0], u[1][:3])


def test_native_indexed_vs_python_oracle():
    """Roots, witnesses, proofs and leaves against the port's
    OracleIndexedTree on the reference's golden path (:683-690), then a
    duplicate and a zero: rejected, slot consumed, tree untouched."""
    nat = oracle.NativeIndexedTree(4)
    ora = OracleIndexedTree(4)
    assert nat.get_root() == ora.get_root()
    for v in [30, 10, 20, 5, 50, 35]:
        wn, wo = nat.insert(v), ora.insert(v)
        assert wn["ok"] and wo["ok"]
        for k in WITNESS_KEYS[1:]:
            assert wn[k] == wo[k], (v, k)
        assert nat.get_root() == ora.get_root()
    before = nat.get_root()
    for v in (20, 0):
        w = nat.insert(v)
        assert not w["ok"] and w["old_root"] == w["new_root"] == before
    assert nat.get_root() == before and nat.count == 8
    for i in range(7):
        leaf = ora.preimages[i]
        assert nat.get_leaf_ints(i) == (leaf.val, leaf.next_val,
                                        leaf.next_idx)


def test_native_indexed_vs_the_ports_tree():
    """Acceptance, root and a proof against the port's CPU tree over an
    adversarial batch (duplicate, zero, p - 1, neighbours)."""
    vals = [7, P - 1, 7, 0, 12345, 1, 12346, 12344]
    nat = oracle.NativeIndexedTree(5)
    tree = IndexedMerkleTree(5, device="cpu")
    assert nat.insert_batch(vals).tolist() == tree.insert_batch(vals).tolist()
    assert nat.get_root() == tree.get_root_int()
    proof, helpers = nat.get_proof(3)
    p, h = tree.get_proof(3)
    assert [field.limbs_to_int(p[i, :, 0]) for i in range(5)] == proof
    assert np.asarray(h)[:, 0].tolist() == helpers


def test_witnesses_equal_imt_tpus_native_tree():
    """Every witness dict of a mixed stream (accepted, duplicates, zeros,
    p - 1) equals imt_tpu's C++ tree's, rejected inserts included."""
    stream = [30, 10, 30, 0, P - 1, 20, 5, P - 1, 50, 1, 35, 0]
    ours, theirs = oracle.NativeIndexedTree(4), jax_oracle.NativeIndexedTree(4)
    for v in stream:
        assert ours.insert(v) == theirs.insert(v), v
    assert ours.get_root() == theirs.get_root()
    assert ours.get_proof(5) == theirs.get_proof(5)


def test_witness_batch_equals_the_native_tree_on_accepted_lanes():
    """A depth-5 K = 8 witness batch of the port's CPU tree against the
    native tree's inserts one by one: ok on every lane, every field on the
    accepted lanes (a rejected lane reports an as-if-applied new_root)."""
    vals = [9, 4, 9, 0, 17, 2, P - 1, 4]
    tree = IndexedMerkleTree(5, device="cpu")
    tree.insert_batch([11, 3])
    nat = oracle.NativeIndexedTree(5)
    nat.insert_batch([11, 3])
    w = tree.insert_batch(vals, witness=True)
    wits = [nat.insert(v) for v in vals]
    assert w.ok.tolist() == [x["ok"] for x in wits]
    ints = lambda x: field.limbs_to_ints(x.numpy())
    for lane in np.flatnonzero(w.ok):
        n = wits[lane]
        assert ints(w.old_root)[lane] == n["old_root"]
        assert ints(w.new_root)[lane] == n["new_root"]
        for leaf in ("low_leaf", "new_leaf"):
            got = tuple(ints(getattr(w, f"{leaf}_{part}"))[lane]
                        for part in ("val", "next_val", "next_idx"))
            assert got == n[leaf], (lane, leaf)
            proof = getattr(w, f"{leaf}_proof")
            assert [ints(proof[d])[lane] for d in range(5)] == \
                n[f"{leaf}_proof"]
            assert getattr(w, f"{leaf}_proof_helper")[:, lane].tolist() == \
                n[f"{leaf}_proof_helper"]
        assert int(w.new_leaf_index[lane]) == n["new_leaf_index"]
        assert bool(w.is_new_leaf_largest[lane]) == n["is_new_leaf_largest"]
    assert tree.get_root_int() == nat.get_root()


def test_native_indexed_guards():
    nat = oracle.NativeIndexedTree(2)
    for v in (5, 9, 11):            # slots 1-3 (slot 0 is the sentinel)
        nat.insert(v)
    with pytest.raises(ValueError, match="full"):
        nat.insert(13)
    with pytest.raises(ValueError, match="full"):
        oracle.NativeIndexedTree(3).insert_batch(list(range(1, 9)))
    with pytest.raises(ValueError, match="depth"):
        oracle.NativeIndexedTree(oracle.MAX_DEPTH + 1)
    with pytest.raises(IndexError):
        nat.get_proof(4)


def test_build_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(oracle, "_lib", None)
    monkeypatch.setattr(oracle, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        oracle.hash2([1], [2])
    assert not (tmp_path / "build").exists()


def test_native_oracle_under_asan_ubsan():
    """The whole oracle surface under AddressSanitizer + UBSan, halting on
    the first report, in a subprocess that imports only imt_tpu_torch."""
    libasan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
    assert os.path.sep in libasan, f"libasan not found: {libasan}"
    script = r"""
import sys
import numpy as np
from imt_tpu_torch.native import oracle

assert "_asan_" in oracle.library_path()
rng = np.random.default_rng(7)
a = rng.integers(0, 1 << 62, (64, 4), dtype=np.uint64)
b = rng.integers(0, 1 << 62, (64, 4), dtype=np.uint64)
oracle.hash2_u64(a, b)
oracle.hash3_u64(a, b, a)
xs = list(range(1, 65))
oracle.hash2(xs, xs)
oracle.hash3(xs, xs, xs)
oracle.mul_mod(xs, xs)
oracle.add_mod(xs, xs)
oracle.tree_build(list(range(1, 17)))
t = oracle.NativeIndexedTree(4)
for v in [30, 10, 20, 5, 50, 35, 30, 0]:   # with a duplicate and a zero
    t.insert(v)
t.insert_batch([7, 8])
proof, helpers = t.get_proof(1)
t.get_leaf_ints(3)
assert t.count == 10
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "imt_tpu"))
assert not bad, bad
print("ASAN-OK", t.get_root() % 1000)
"""
    env = dict(os.environ, PYTHONPATH=ROOT, IMT_NATIVE_SAN="1",
               LD_PRELOAD=libasan,
               ASAN_OPTIONS="detect_leaks=0,abort_on_error=1")
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    assert "ASAN-OK" in out.stdout
    assert "ERROR: AddressSanitizer" not in out.stderr
    assert "runtime error" not in out.stderr
