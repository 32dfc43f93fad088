"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each source under ``csrc/`` (``poseidon_bn254.cu``, ``vpu_roofline.cu``)
compiles, at first use, into its own shared library with a plain C interface
under ``imt_tpu_torch/build/`` (listed in ``.gitignore``), named by a digest
of the source and the flags so that an edited source never loads a stale
build.  No PyTorch headers are involved, so a build takes seconds; ``build``
starts one nvcc per missing library, all at once.  Without ``nvcc`` or
without a CUDA device, ``load`` raises ``RuntimeError``: nothing here falls
back to another path.
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
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
CUDA_DEFAULT_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# library name -> (source under csrc/, C entry points and their arguments)
LIBRARIES = {
    "poseidon": ("poseidon_bn254.cu", {
        "imt_init_constants": [_P, _I64],
        "imt_permute_n": [_P, _P, _I64, _I32, _P],
        "imt_hash_lane_threads": [_I64],
        "imt_hash2_nodes": [_P, _P, _P, _I64, _P],
        "imt_hash3_leaf": [_P, _P, _P, _P, _I64, _P],
        "imt_limbs_to_nodes": [_P, _P, _I64, _P],
        "imt_nodes_to_limbs": [_P, _P, _I64, _P],
    }),
    "vpu_roofline": ("vpu_roofline.cu", {
        "imt_roofline_f32": [_I32, _P, _P, _I64, _I32, ctypes.c_float,
                             ctypes.c_float, _P],
        "imt_roofline_u32": [_I32, _P, _P, _I64, _I32, ctypes.c_uint32,
                             ctypes.c_uint32, _P],
    }),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per library: what its last build printed (the ptxas register and spill
# report) and how long nvcc took
build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def source(name: str) -> str:
    return os.path.join(_HERE, "csrc", LIBRARIES[name][0])


def library_path(name: str) -> str:
    """Where the library of `name` is (or will be) built."""
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libimt_{name}_{digest}.so")


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


def _compile(names) -> None:
    """Build every library of `names` that is missing, one nvcc each, all
    started together.  Raises if any build fails."""
    nvcc = find_nvcc()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA kernels of imt_tpu_torch "
                           "need one; on a host without it, use CPU tensors")
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, source(name)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {LIBRARIES[name][0]} with exit "
                          f"code {proc.returncode}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> None:
    """Build (once per source digest) every library in parallel, and load
    them."""
    with _lock:
        _compile([n for n in LIBRARIES if n not in _libs])
    for n in LIBRARIES:
        load(n)


def load(name: str) -> ctypes.CDLL:
    """Build (once per source digest) and load one kernel library."""
    with _lock:
        if name not in _libs:
            _compile([name])
            lib = ctypes.CDLL(library_path(name))
            for fn_name, argtypes in LIBRARIES[name][1].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
