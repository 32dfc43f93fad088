"""The probe kernel's arithmetic, compiled for the host (CPU).

``csrc/vpu_roofline.cu`` keeps the exact floor of ``mod4`` (``floor_magic``)
and the row of ``cios16`` (``cios16_words``, ``cios16_start``,
``cios16_row``) outside ``#ifdef __CUDACC__``, in plain C++: a small
harness includes the source, ``g++`` builds it into a shared library, and
``ctypes`` runs them.  On the host the row takes the C++ branch of the same
arithmetic (the PTX carry chain runs only on the card), and the floor's add
rounds down through ``fesetround``.  The row is held against the plain
torch ``cios16`` (``ops/vpu_roofline.py``) at k = 0, 1 and 3 on seeded
words with 0 and 2^32 - 1 among them; the floor against ``torch.floor`` on
its edge values (signed zeros, infinities, NaN, denormals, -0.5, the
2^22 and 2^23 boundaries) and on seeded values of every magnitude, bit for
bit, any NaN matching any NaN.  Skips where there is no ``g++``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from imt_tpu_torch.ops import vpu_roofline as vr
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "imt_tpu_torch", "ops", "csrc", "vpu_roofline.cu")
HARNESS = r"""
#include "%s"

extern "C" {

void h_cios16(const u32* x, u32* out, long long n, int k, u32 c, u32 d) {
  u32 w[kWords];
  cios16_words(w, c, d);
  for (long long i = 0; i < n; ++i) {
    u64 a[kWords];
    cios16_start(a, x[i], d);
    for (int r = 0; r < k; ++r) {
      cios16_row(a, w, c);
      cios16_row(a, w, c);
    }
    out[i] = (u32)a[0];
  }
}

void h_floor(const float* y, float* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = floor_magic(y[i]);
}

}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the probe's host arithmetic")
    d = tmp_path_factory.mktemp("probe_host")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS % SOURCE)
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-frounding-math",
                    "-shared", "-fPIC", "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=120)
    h = ctypes.CDLL(str(so))
    P, I64 = ctypes.c_void_p, ctypes.c_longlong
    h.h_cios16.argtypes = [P, P, I64, ctypes.c_int, ctypes.c_uint32,
                           ctypes.c_uint32]
    h.h_floor.argtypes = [P, P, I64]
    return h


def _run(fn, x: np.ndarray, *args) -> np.ndarray:
    x = np.ascontiguousarray(x)
    out = np.empty_like(x)
    fn(x.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
       x.size, *args)
    return out


@pytest.mark.parametrize("k", [0, 1, 3])
def test_cios16_row_equals_plain(lib, k):
    x = vr.seeded_input("cios16", 1, 64, seed=11, device="cpu")
    x[0, :2] = torch.tensor([0, -1], dtype=torch.int32)   # words 0, 2^32 - 1
    got = _run(lib.h_cios16, x.numpy().view(np.uint32), k, vr.C_U32,
               vr.D_U32)
    assert np.array_equal(got.view(np.int32), vr.plain("cios16", x, k).numpy())


def test_floor_magic_equals_floor(lib):
    rng = np.random.default_rng(12)
    mags = rng.uniform(-40.0, 40.0, 2048)
    seeded = (rng.choice([-1.0, 1.0], 2048) * 2.0 ** mags).astype(np.float32)
    y = torch.cat([vr.edge_values("mod4"), torch.as_tensor(seeded)])
    got = torch.as_tensor(_run(lib.h_floor, y.numpy()))
    assert vr.same_bits(got, torch.floor(y))
