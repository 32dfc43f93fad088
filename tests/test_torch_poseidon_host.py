"""The CUDA Poseidon kernel's arithmetic, compiled for the host (CPU).

Everything in ``csrc/poseidon_bn254.cu`` outside ``#ifdef __CUDACC__`` is
plain C++: a small harness includes the source, ``g++`` builds it into a
shared library, and ``ctypes`` runs the per-lane bodies of the hash kernels
(``hash2_lane``, ``hash3_lane``: the sparse core; ``hash2_coop``,
``hash3_coop``: the cooperative core, its four roles run in turn on one
thread with the warp shuffles as copies), K1's body
(``permute_lane``, n_perms 1, 2 and 3) and the limb <-> node conversions
on numpy-seeded lanes, with the edge values 0, p - 1, p and 2^256 - 1
among them (and the node words 0 and p - 1).  The results must equal the
plain torch version (``ops/poseidon.py``) bit for bit.  On the host the
carry-chained functions run the C++ branch of the same arithmetic; the PTX
branch runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  Skips where there is no ``g++``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from imt_tpu_torch.ops import field, poseidon
from imt_tpu_torch.ops.poseidon_spec import kernel_words
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "imt_tpu_torch", "ops", "csrc", "poseidon_bn254.cu")
HARNESS = r"""
#include "%s"

namespace {
Consts g_host;
}

extern "C" {

int h_init(const u32* words, long long n_words) {
  return pack_consts(g_host, words, n_words) ? 0 : -1;
}

void h_hash2(const u32* a, const u32* b, u32* out, long long B) {
  for (long long i = 0; i < B; ++i) hash2_lane(a, b, out, B, i, g_host);
}

void h_hash3(const u32* a, const u32* b, const u32* c, u32* out,
             long long B) {
  for (long long i = 0; i < B; ++i) hash3_lane(a, b, c, out, B, i, g_host);
}

void h_limbs_to_nodes(const u32* in, u32* out, long long B) {
  for (long long i = 0; i < B; ++i) limbs_to_nodes_lane(in, out, B, i);
}

void h_nodes_to_limbs(const u32* in, u32* out, long long B) {
  for (long long i = 0; i < B; ++i) nodes_to_limbs_lane(in, out, B, i);
}

// the cooperative bodies, every role of a group in turn on this thread
void h_hash2_coop(const u32* a, const u32* b, u32* out, long long B) {
  for (long long i = 0; i < B; ++i) {
    hash2_coop(HostRoles{}, a, b, out, B, i, true, g_host);
  }
}

void h_hash3_coop(const u32* a, const u32* b, const u32* c, u32* out,
                  long long B) {
  for (long long i = 0; i < B; ++i) {
    hash3_coop(HostRoles{}, a, b, c, out, B, i, true, g_host);
  }
}

// n chained permutations of states [3, 8, B]: K1's body (permute_lane, as
// permute_kernel runs it) if core is 1, the sparse core chained n times if
// 0, the cooperative core (role 0's state; every role's must agree) if 2
void h_permute(const u32* in, u32* out, long long B, int n, int core) {
  for (long long i = 0; i < B; ++i) {
    if (core == 1) {
      permute_lane(in, out, B, i, n, g_host);
      continue;
    }
    Fr st[kT], sc[kCoop][kT];
    for (int j = 0; j < kT; ++j) load_node(st[j], in + j * kWords * B, B, i);
    for (int k = 0; k < n; ++k) {
      if (core == 0) {
        permute_sparse(st, g_host);
        continue;
      }
      for (int q = 0; q < kCoop; ++q) {
        for (int j = 0; j < kT; ++j) sc[q][j] = st[j];
      }
      permute_coop(HostRoles{}, sc, g_host);
      for (int q = 1; q < kCoop; ++q) {
        if (std::memcmp(sc[q], sc[0], sizeof(sc[0])) != 0) return;
      }
      for (int j = 0; j < kT; ++j) st[j] = sc[0][j];
    }
    for (int j = 0; j < kT; ++j) store_node(out + j * kWords * B, st[j], B, i);
  }
}

}
"""
LANES = 64


def build_harness(directory):
    """The harness built by g++ into `directory` and loaded, its tables
    set; skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host arithmetic")
    src, so = directory / "harness.cpp", directory / "libharness.so"
    src.write_text(HARNESS % SOURCE)
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    h = ctypes.CDLL(str(so))
    P, I64 = ctypes.c_void_p, ctypes.c_longlong
    h.h_init.argtypes = [P, I64]
    h.h_hash2.argtypes = h.h_hash2_coop.argtypes = [P, P, P, I64]
    h.h_hash3.argtypes = h.h_hash3_coop.argtypes = [P, P, P, P, I64]
    h.h_permute.argtypes = [P, P, I64, ctypes.c_int, ctypes.c_int]
    h.h_limbs_to_nodes.argtypes = h.h_nodes_to_limbs.argtypes = [P, P, I64]
    words = kernel_words()
    assert h.h_init(words.ctypes.data_as(P), words.size) == 0
    assert h.h_init(words.ctypes.data_as(P), words.size - 1) == -1
    return h


def k1(h, st: torch.Tensor, n: int) -> torch.Tensor:
    """K1's kernel body on the host: n chained permutations of node states
    int32[3, 8, B]."""
    return _call(lambda i, o, w: h.h_permute(i, o, w, n, 1),
                 tuple(st.shape), st)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_harness(tmp_path_factory.mktemp("poseidon_host"))


def _limbs(seed: int) -> torch.Tensor:
    """int32[16, LANES] seeded values < 2^256, edge values first."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, (16, LANES)).astype(np.int32)
    for i, v in enumerate([0, field.P - 1, field.P, (1 << 256) - 1]):
        x[:, (i + seed) % LANES] = field.int_to_limbs(v)
    return torch.as_tensor(x)


def _call(fn, out_shape, *args) -> torch.Tensor:
    ins = [np.ascontiguousarray(a.numpy().view(np.uint32)) for a in args]
    out = np.zeros(out_shape, dtype=np.uint32)
    fn(*[a.ctypes.data_as(ctypes.c_void_p) for a in ins],
       out.ctypes.data_as(ctypes.c_void_p), out_shape[-1])
    return torch.as_tensor(out.view(np.int32))


def test_hash2_lane_equals_plain(lib):
    a, b = (poseidon.limbs_to_nodes(_limbs(s)) for s in (1, 2))
    got = _call(lib.h_hash2, (8, LANES), a, b)
    assert torch.equal(got, poseidon.hash2_nodes(a, b))


def test_hash3_lane_equals_plain(lib):
    a, b, c = (_limbs(s) for s in (3, 4, 5))
    got = _call(lib.h_hash3, (8, LANES), a, b, c)
    assert torch.equal(got, poseidon.hash3_leaf(a, b, c))


def test_hash2_coop_equals_plain(lib):
    """The cooperative hash2 body, its kCoop roles run in turn with the
    exchanges as copies."""
    a, b = (poseidon.limbs_to_nodes(_limbs(s)) for s in (1, 2))
    got = _call(lib.h_hash2_coop, (8, LANES), a, b)
    assert torch.equal(got, poseidon.hash2_nodes(a, b))


def test_hash3_coop_equals_plain(lib):
    a, b, c = (_limbs(s) for s in (3, 4, 5))
    got = _call(lib.h_hash3_coop, (8, LANES), a, b, c)
    assert torch.equal(got, poseidon.hash3_leaf(a, b, c))


def _states() -> torch.Tensor:
    """Node states int32[3, 8, LANES]: seeded values, edge values among
    them, and the node words 0 and p - 1 in their own lanes."""
    st = torch.stack([poseidon.limbs_to_nodes(_limbs(s)) for s in (6, 7, 8)])
    word = lambda v: torch.as_tensor(np.array(
        [(v >> (32 * i)) & 0xFFFFFFFF for i in range(field.WORDS)],
        dtype=np.uint32).view(np.int32))
    for j in range(3):
        st[j, :, 10 + j] = word(0)
        st[j, :, 13] = st[j, :, 14 + j] = word(field.P - 1)
    return st


@pytest.mark.parametrize("core,n", [("sparse", 2), ("k1", 1), ("k1", 2),
                                    ("k1", 3), ("coop", 2)],
                         ids=["sparse", "k1-1", "k1-2", "k1-3", "coop"])
def test_permutation_cores_equal_plain(lib, core, n):
    """The hash kernels' sparse and cooperative cores (every role's state
    equal after each permutation) and K1's kernel body (n_perms 1, 2 and 3)
    against the plain permute_n."""
    st = _states()
    got = k1(lib, st, n) if core == "k1" else _call(
        lambda i, o, w: lib.h_permute(i, o, w, n, 2 if core == "coop" else 0),
        (3, 8, LANES), st)
    assert torch.equal(got, poseidon.permute_n(st, n))


def test_conversions_equal_plain(lib):
    limbs = _limbs(9)
    nodes = _call(lib.h_limbs_to_nodes, (8, LANES), limbs)
    assert torch.equal(nodes, poseidon.limbs_to_nodes(limbs))
    assert torch.equal(_call(lib.h_nodes_to_limbs, (16, LANES), nodes),
                       poseidon.nodes_to_limbs(nodes))
