"""ctypes binding of the port's C++ native oracle (``imt_native.cpp``).

Counterpart of ``imt_tpu.native.oracle``, with the same public names.  The
oracle is an independent 4x64-bit Montgomery implementation of the field,
the Poseidon sponge, the Merkle tree build and an incremental indexed tree
with witnesses, on the host CPU: the port's CUDA kernels and plain torch
path are held against it.  Field elements cross the boundary as
``uint64[N, 4]`` little-endian limbs in standard (non-Montgomery) form;
``limbs_to_u64`` / ``u64_to_limbs`` convert from and to the port's
canonical limbs ``int32[16, B]``.

The library builds at first use with ``g++ -O2 -march=native -shared
-fPIC`` into ``imt_tpu_torch/build/`` (listed in ``.gitignore``), named by
a digest of the source, the flags and the host CPU (``-march=native`` code
runs only where it was built), so an edited source never loads a stale
library.  Without ``g++`` it raises ``RuntimeError``; nothing falls back.
``IMT_NATIVE_SAN=1`` builds and loads an AddressSanitizer + UBSan variant
instead (run it under ``LD_PRELOAD`` of ``g++ -print-file-name=libasan.so``;
``tests/test_torch_native_oracle.py`` does).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..ops._build import BUILD_DIR
from ..ops.field import LIMBS, P
from ..ops.poseidon_spec import default_params

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "imt_native.cpp")
FLAGS = ("-O2", "-march=native", "-shared", "-fPIC")
SAN_FLAGS = ("-fsanitize=address,undefined", "-fno-sanitize-recover=all",
             "-g")
# NativeIndexedTree allocates every slot and level of a dense tree
MAX_DEPTH = 20
_M64 = (1 << 64) - 1

_lock = threading.Lock()
_lib = None


# /proc/cpuinfo's lines that name the CPU and its features (x86, Arm)
_CPU_KEYS = (b"vendor_id", b"cpu family", b"model", b"flags",
             b"CPU implementer", b"CPU part", b"Features")


def _host_cpu() -> bytes:
    """The host CPU's model and features (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            info = f.read()
    except OSError:
        return b""
    return b"\n".join(sorted({ln for ln in info.splitlines()
                              if ln.startswith(_CPU_KEYS)}))


def _flags() -> tuple:
    san = os.environ.get("IMT_NATIVE_SAN") == "1"
    return FLAGS + (SAN_FLAGS if san else ()), san


def library_path() -> str:
    """Where the oracle library for this source, flags and host is (or will
    be) built."""
    flags, san = _flags()
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                + _host_cpu()).hexdigest()[:16]
    name = "imt_native_asan" if san else "imt_native"
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _build(out: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native oracle of "
                           "imt_tpu_torch needs it to build")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *_flags()[0], "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"g++ failed on imt_native.cpp with exit code "
                           f"{proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        vp, lng = ctypes.c_void_p, ctypes.c_long
        sigs = {
            "imt_init": ([u64p, u64p, ctypes.c_int, ctypes.c_int], None),
            "imt_hash2": ([u64p] * 3 + [lng], None),
            "imt_mul_mod": ([u64p] * 3 + [lng], None),
            "imt_add_mod": ([u64p] * 3 + [lng], None),
            "imt_hash3": ([u64p] * 4 + [lng], None),
            "imt_tree_build": ([u64p, u64p, lng], None),
            "imt_idx_new": ([ctypes.c_int], vp),
            "imt_idx_free": ([vp], None),
            "imt_idx_count": ([vp], lng),
            "imt_idx_root": ([vp, u64p], None),
            "imt_idx_leaf": ([vp, lng, u64p], None),
            "imt_idx_insert": ([vp, u64p, u64p], ctypes.c_int),
            "imt_idx_insert_batch": ([vp, u64p, lng, u8p], lng),
            "imt_idx_proof": ([vp, lng, u64p, u64p], None),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res

        params = default_params()
        rc = ints_to_u64([c for row in params.round_constants for c in row])
        mds = ints_to_u64([m for row in params.mds for m in row])
        lib.imt_init(_ptr(rc), _ptr(mds), params.r_f, params.r_p)
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _int_to_u64(x: int) -> np.ndarray:
    return np.array([(x >> (64 * i)) & _M64 for i in range(4)],
                    dtype=np.uint64)


def ints_to_u64(xs) -> np.ndarray:
    """Python ints -> uint64[N, 4] (each reduced mod p)."""
    out = np.zeros((len(xs), 4), dtype=np.uint64)
    for i, x in enumerate(xs):
        out[i] = _int_to_u64(x % P)
    return out


def u64_to_ints(a: np.ndarray) -> list[int]:
    """uint64[N, 4] -> python ints."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return [sum(int(row[i]) << (64 * i) for i in range(4)) for row in a]


def limbs_to_u64(limbs) -> np.ndarray:
    """The port's canonical limbs int32[16, B] (numpy or a CPU tensor; each
    limb masked to 16 bits) -> uint64[B, 4], the same 256-bit values
    (not reduced: the oracle's hashes reduce any 256-bit input)."""
    x = np.asarray(limbs).astype(np.uint64) & 0xFFFF
    if x.ndim != 2 or x.shape[0] != LIMBS:
        raise ValueError(f"expected limbs [16, B], got {list(x.shape)}")
    w = x.reshape(4, 4, -1)                     # [word, limb in word, B]
    out = (w[:, 0] | (w[:, 1] << 16) | (w[:, 2] << 32) | (w[:, 3] << 48))
    return np.ascontiguousarray(out.T)


def u64_to_limbs(a: np.ndarray) -> np.ndarray:
    """uint64[B, 4] -> canonical limbs int32[16, B]."""
    a = np.asarray(a, dtype=np.uint64)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"expected uint64 [B, 4], got {list(a.shape)}")
    sh = np.arange(4, dtype=np.uint64) * 16
    x = (a.T[:, None, :] >> sh[None, :, None]) & 0xFFFF   # [word, limb, B]
    return np.ascontiguousarray(x.reshape(LIMBS, -1).astype(np.int32))


def _elementwise(fn_name: str, *cols: np.ndarray) -> np.ndarray:
    lib = _load()
    cols = [np.ascontiguousarray(c, np.uint64) for c in cols]
    n = cols[0].shape[0]
    if any(c.shape != (n, 4) for c in cols):
        raise ValueError(f"{fn_name}: expected uint64 [N, 4] inputs of one "
                         "width")
    out = np.zeros((n, 4), dtype=np.uint64)
    getattr(lib, fn_name)(*(_ptr(c) for c in cols), _ptr(out), n)
    return out


def _ints(fn_name: str, *cols) -> list[int]:
    return u64_to_ints(_elementwise(fn_name, *map(ints_to_u64, cols)))


def hash2(xs, ys) -> list[int]:
    return _ints("imt_hash2", xs, ys)


def hash3(xs, ys, zs) -> list[int]:
    return _ints("imt_hash3", xs, ys, zs)


def mul_mod(xs, ys) -> list[int]:
    return _ints("imt_mul_mod", xs, ys)


def add_mod(xs, ys) -> list[int]:
    return _ints("imt_add_mod", xs, ys)


def tree_build(leaves) -> list[int]:
    """All tree levels (leaves first, root last) for 2^k leaves."""
    n = len(leaves)
    if n < 1 or n & (n - 1):
        raise ValueError(f"tree_build needs 2^k leaves, got {n}")
    lib = _load()
    a = ints_to_u64(leaves)
    out = np.zeros((2 * n - 1, 4), dtype=np.uint64)
    lib.imt_tree_build(_ptr(a), _ptr(out), n)
    return u64_to_ints(out)


class NativeIndexedTree:
    """Native (C++) indexed Merkle tree: the reference's out-of-circuit
    witness-generation layer (src/utils.rs + the update_idx_leaf planner,
    src/indexed_merkle_tree.rs:632-660) as a host component.

    The port's semantics (``imt_tpu_torch/tree/indexed.py``): duplicate and
    zero inserts are rejected but consume their slot.  Each insert costs
    2 * (depth + 1) hashes and an O(log n) planner lookup.

    Dense: it allocates all 2^depth slots and every level, so depth is at
    most ``MAX_DEPTH`` (20); it cannot hold a depth-32 tree.

    Witnesses of REJECTED inserts report the untouched tree (old_root ==
    new_root, slot 0 as the low leaf).  The port's trees, like
    ``imt_tpu``'s, leave their state untouched on a rejected lane but
    report other values there: an as-if-applied new_root from ``insert`` /
    ``insert_seq``, another low leaf and its proof from the witness batch.
    Compare ``ok`` on every lane and the other witness fields on accepted
    lanes only.
    """

    def __init__(self, depth: int):
        if not 1 <= depth <= MAX_DEPTH:
            raise ValueError(f"NativeIndexedTree holds depth 1..{MAX_DEPTH} "
                             f"(a dense tree), got {depth}")
        self._lib = _load()
        self.depth = depth
        self._h = ctypes.c_void_p(self._lib.imt_idx_new(depth))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.imt_idx_free(h)
            self._h = None

    @property
    def count(self) -> int:
        return self._lib.imt_idx_count(self._h)

    def get_root(self) -> int:
        out = np.zeros((1, 4), dtype=np.uint64)
        self._lib.imt_idx_root(self._h, _ptr(out))
        return u64_to_ints(out)[0]

    def get_leaf_ints(self, i: int):
        if not 0 <= i < 1 << self.depth:
            raise IndexError(f"slot {i} outside a depth-{self.depth} tree")
        out = np.zeros((3, 4), dtype=np.uint64)
        self._lib.imt_idx_leaf(self._h, i, _ptr(out))
        return tuple(u64_to_ints(out))

    def get_proof(self, index: int) -> tuple[list[int], list[int]]:
        if not 0 <= index < 1 << self.depth:
            raise IndexError(f"slot {index} outside a depth-{self.depth} "
                             "tree")
        proof = np.zeros((self.depth, 4), dtype=np.uint64)
        helpers = np.zeros(self.depth, dtype=np.uint64)
        self._lib.imt_idx_proof(self._h, index, _ptr(proof), _ptr(helpers))
        return u64_to_ints(proof), [int(x) for x in helpers]

    def insert(self, value: int) -> dict:
        """One insert; returns the witness bundle as python ints (the keys
        of ``tree/reference_oracle.py``'s ``OracleIndexedTree.insert``)."""
        d = self.depth
        wit = np.zeros(35 + 10 * d, dtype=np.uint64)
        v = _int_to_u64(value % P)
        r = self._lib.imt_idx_insert(self._h, _ptr(v), _ptr(wit))
        if r < 0:
            raise ValueError("tree full")
        u = lambda off: u64_to_ints(wit[off:off + 4][None])[0]
        vec = lambda off: u64_to_ints(wit[off:off + 4 * d].reshape(d, 4))
        tail = wit[32 + 10 * d:]
        bits = lambda off: [int(x) for x in wit[off:off + d]]
        return dict(
            ok=bool(r),
            old_root=u(0),
            low_leaf=(u(4), u(8), u(12)),
            new_root=u(16),
            new_leaf=(u(20), u(24), u(28)),
            low_leaf_proof=vec(32),
            new_leaf_proof=vec(32 + 4 * d),
            low_leaf_proof_helper=bits(32 + 8 * d),
            new_leaf_proof_helper=bits(32 + 9 * d),
            new_leaf_index=int(tail[0]),
            is_new_leaf_largest=bool(tail[1]),
        )

    def insert_batch(self, values) -> np.ndarray:
        """Sequential native batch insert; returns the acceptance mask."""
        vals = ints_to_u64(values)
        ok = np.zeros(len(values), dtype=np.uint8)
        r = self._lib.imt_idx_insert_batch(
            self._h, _ptr(vals), len(values),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if r < 0:
            raise ValueError("tree full")
        return ok.astype(bool)


# --- raw-array fast paths (no python-int conversion) -------------------------

def hash2_u64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """H(a, b) on uint64[N, 4] -> uint64[N, 4]."""
    return _elementwise("imt_hash2", a, b)


def hash3_u64(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """H(a, b, c) on uint64[N, 4] -> uint64[N, 4]."""
    return _elementwise("imt_hash3", a, b, c)
