"""Build the CUDA kernels with nvcc and bind them with ctypes.

The source ``csrc/poseidon_bn254.cu`` compiles, at first use, into a shared
library with a plain C interface under ``imt_tpu_torch/build/`` (listed in
``.gitignore``), named by a digest of the source and the flags so that an
edited source never loads a stale build.  No PyTorch headers are involved, so
a build takes seconds.  Without ``nvcc`` or without a CUDA device, ``load``
raises ``RuntimeError``: nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "poseidon_bn254.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
CUDA_DEFAULT_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    "imt_init_constants": [_P, _P, _P, _P],
    "imt_permute_n": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P],
    "imt_hash2_nodes": [_P, _P, _P, ctypes.c_longlong, _P],
    "imt_hash3_leaf": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "imt_limbs_to_nodes": [_P, _P, ctypes.c_longlong, _P],
    "imt_nodes_to_limbs": [_P, _P, ctypes.c_longlong, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build printed (ptxas register and spill report) and took
build_log = ""
build_seconds = 0.0


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's default
    install location.  Raises RuntimeError when there is none."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(os.path.join(CUDA_DEFAULT_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, "
        f"{CUDA_DEFAULT_HOME}/bin): the CUDA kernels of imt_tpu_torch need "
        "the CUDA toolkit to build; on a host without it, use CPU tensors")


def _compile() -> str:
    global build_log, build_seconds
    nvcc = find_nvcc()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA kernels of imt_tpu_torch "
                           "need one; on a host without it, use CPU tensors")
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libimt_poseidon_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (once per source digest) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_compile())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
