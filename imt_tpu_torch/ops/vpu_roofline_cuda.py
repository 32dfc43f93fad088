"""Wrapper of the hand-written CUDA throughput probe (csrc/vpu_roofline.cu).

Counterpart of the Pallas kernel in ``tools/vpu_roofline.py`` (``make``,
``:83``).  ``roofline`` takes a CUDA tensor only, checks device, dtype,
shape and contiguity, allocates its output with ``torch.empty``, launches on
the current stream without synchronising, and raises if the launch reports
an error.  There is no fallback: a CPU tensor raises, and the plain version
lives in ``vpu_roofline.py``.

``LAUNCHES`` counts kernel launches per body, one per launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .vpu_roofline import BODIES, BODY_ID, C_F32, C_U32, D_F32, D_U32

LAUNCHES = {name: 0 for name in BODIES}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def roofline(name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """body^k(x) elementwise on a contiguous CUDA tensor of the body's dtype
    (float32 or int32) and rank 1 or 2, of any alignment and size; the
    body's scalars c, d are passed as kernel arguments, so nothing
    constant-folds."""
    if name not in BODIES:
        raise ValueError(f"unknown body {name!r}; one of {list(BODIES)}")
    body = BODIES[name]
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x)
        raise ValueError(f"roofline {name}: expected a CUDA tensor, got "
                         f"{where}")
    if x.dtype != body.dtype:
        raise TypeError(f"roofline {name}: expected {body.dtype}, got "
                        f"{x.dtype}")
    if x.dim() not in (1, 2):
        raise ValueError(f"roofline {name}: expected shape [rows, B] or [B], "
                         f"got {list(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"roofline {name}: expected a contiguous tensor")
    if not 0 <= k < 2 ** 31:
        raise ValueError(f"roofline {name}: k out of range: {k}")
    lib = _build.load("vpu_roofline")
    out = torch.empty_like(x)
    n = ctypes.c_longlong(x.numel())
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream)
        if body.dtype == torch.float32:
            err = lib.imt_roofline_f32(
                BODY_ID[name], ctypes.c_void_p(x.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), n, ctypes.c_int(k),
                ctypes.c_float(C_F32), ctypes.c_float(D_F32), stream)
        else:
            err = lib.imt_roofline_u32(
                BODY_ID[name], ctypes.c_void_p(x.data_ptr()),
                ctypes.c_void_p(out.data_ptr()), n, ctypes.c_int(k),
                ctypes.c_uint32(C_U32), ctypes.c_uint32(D_U32), stream)
    if err:
        raise RuntimeError(f"roofline {name}: CUDA launch error {err}")
    LAUNCHES[name] += 1
    return out
