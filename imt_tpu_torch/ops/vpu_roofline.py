"""The elementwise throughput probe: body table, plain torch bodies, slope.

Counterpart of ``tools/vpu_roofline.py`` (the TPU vector unit's ceiling):
``k`` chained applications of one small body per element of a ``[rows, B]``
array, timed at two values of ``k`` so that the slope cancels the fixed
costs.  Six f32 bodies are the tool's (``:50-81``), in its order of
operations; three int32 bodies carry the tool's purpose to this card, whose
Poseidon kernels are built from 32-bit integer multiply-adds:

* ``imad16``: 16 x ``x = x*c + d`` mod 2^32;
* ``cios16``: two rows of the shape the Poseidon kernels run (``redc_row``
  and ``mac_row_acc`` in ``poseidon_bn254.cu``).  State: 8 words ``a[j]``
  of 64 bits per element, starting as ``x + j*d``; the row's words
  ``w[j] = c + j*d``.  A row takes ``m = lo(a[0])*c`` mod 2^32, the eight
  independent multiply-adds ``p[j] = m*w[j] + a[j]`` mod 2^64, the sum
  ``s`` of their low words shifted down one word (``l[0]`` wrapping to the
  top) and their high words, as 256-bit numbers mod 2^256 (one carry
  chain), and sets ``a[j] = s[j] + 2^32 h[j+1 mod 8]``: each addend is the
  register pair of the product before, so the card widens no 32-bit
  addend.  The output is ``lo(a[0])``;
* ``wide16``: ``a = x + 2^32 d``, 16 x ``a = lo(a)*c + a`` mod 2^64, then
  ``x = lo(a) ^ hi(a)``: wide multiply-adds alone, timed against imad16's
  32-bit ones for the IMAD slots a wide one takes.

``BODIES`` gives each body's op count by the tool's census rule (every
arithmetic op of the body counts one, so a multiply-add counts two, as the
tool counts ``muladd``; a cios16 row is 1 + 16 + 8), and the instructions
of the kind its published peak counts: FP32-pipe FMUL/FADD for the f32
bodies (``floor`` runs elsewhere and is left out; ``ilp16`` has 15, though
the tool's census says 16), and IMAD for the integer bodies: imad16's 16,
and cios16's and wide16's 16 wide multiply-adds, each counted as one IMAD
(cios16's ``CIOS_NARROW`` 32-bit multipliers are left out, so its rate is
wide multiply-adds per second with their share of 32-bit ones inside).

``run`` dispatches on the tensor's device: the plain version here for a CPU
tensor, the CUDA kernel (``vpu_roofline_cuda.py``) for a CUDA tensor.
``measure`` / ``probe`` time the kernel on the card and refuse to run
anywhere else; ``time_ms`` (one call, host included), ``graph_time_ms``
(device time per call) and ``nvidia_smi`` are the timings and the card
query that the probe and ``chip_smoke.py`` share.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

import numpy as np
import torch

# the tool's runtime scalars (tools/vpu_roofline.py:109), as f32
C_F32, D_F32 = 1.000001, 1e-6
# the integer bodies' runtime scalars: odd multiplier, odd addend
C_U32, D_U32 = 0x9E3779B1, 0x7F4A7C15
U32 = 0xFFFFFFFF
CIOS_WORDS = 8                 # cios16's state words per element
CIOS_NARROW = 2                # cios16's 32-bit multiplies an application
# published peaks of one H100 SXM: 67 TFLOP/s f32 outside the tensor cores
# counts an FFMA as 2, so 33.5e12 FMUL/FADD per second; 64 IMAD per clock
# per SM (CUDA C++ Programming Guide, throughput table, cc 9.0)
F32_PEAK_PER_S = 33.5e12
IMAD_PER_CLOCK_PER_SM = 64
# a measured share above this is a fault in the count or in the timing
MAX_SHARE = 1.05


@dataclass(frozen=True)
class Body:
    dtype: torch.dtype
    ops: int          # the tool's census count per application
    peak_ops: int     # instructions of the peak's kind per application
    peak_kind: str    # "f32" (FMUL/FADD) or "imad"


BODIES = {
    "mul": Body(torch.float32, 1, 1, "f32"),
    "muladd": Body(torch.float32, 2, 2, "f32"),
    "mul16": Body(torch.float32, 16, 16, "f32"),
    "fma16": Body(torch.float32, 32, 32, "f32"),
    "mod4": Body(torch.float32, 16, 12, "f32"),
    "ilp16": Body(torch.float32, 16, 15, "f32"),
    "imad16": Body(torch.int32, 32, 16, "imad"),
    "cios16": Body(torch.int32, 50, 16, "imad"),
    "wide16": Body(torch.int32, 32, 16, "imad"),
}
BODY_ID = {name: i for i, name in enumerate(BODIES)}


# -- plain f32 bodies (each op rounds once, as in XLA and in the kernel) -----

def _mul16(x, c, d):
    for _ in range(16):
        x = x * c
    return x


def _fma16(x, c, d):
    for _ in range(16):
        x = x * c + d
    return x


def _mod4(x, c, d):
    for _ in range(4):
        x = x - c * torch.floor(x * d)
    return x


def _ilp16(x, c, d):
    a = ((x * c) * c) * c
    b = ((x * d) * d) * d
    e = ((x + c) + c) + c
    f_ = ((x + d) + d) + d
    return (a * b) * (e * f_)


_F32 = {
    "mul": lambda x, c, d: x * c,
    "muladd": lambda x, c, d: x * c + d,
    "mul16": _mul16,
    "fma16": _fma16,
    "mod4": _mod4,
    "ilp16": _ilp16,
}


# -- plain integer bodies: u32 values held in int64.  A 32x32-bit product
# does not fit int64, so x is split into 16-bit halves: x*c = xl*c +
# (xh*c << 16), each partial product < 2^48. -------------------------------

def _mul_add_wide(x, c: int, addend):
    """(lo, hi) 32-bit words of x*c + addend (x, c < 2^32; addend < 2^34)."""
    p1 = (x >> 16) * c
    u = (x & 0xFFFF) * c + addend + ((p1 & 0xFFFF) << 16)
    return u & U32, (u >> 32) + (p1 >> 16)


def _imad16_state(x, c: int, d: int, k: int):
    for _ in range(16 * k):
        x, _ = _mul_add_wide(x, c, d)
    return x


def _cios16_state(x, c: int, d: int, k: int):
    w = [(c + j * d) & U32 for j in range(CIOS_WORDS)]
    t = [(x + j * d) & U32 for j in range(CIOS_WORDS)]   # low words of a
    u = [torch.zeros_like(x)] * CIOS_WORDS               # high words of a
    for _ in range(2 * k):
        m = _mul_add_wide(t[0], c, 0)[0]
        lo, hi = zip(*(_mul_add_wide(m, w[j], t[j])
                       for j in range(CIOS_WORDS)))
        hi = [(h + v) & U32 for h, v in zip(hi, u)]
        carry = 0
        for j in range(CIOS_WORDS):
            s = lo[(j + 1) % CIOS_WORDS] + hi[j] + carry
            t[j], carry = s & U32, s >> 32
        u = hi[1:] + hi[:1]
    return t[0]


def _wide16_state(x, c: int, d: int, k: int):
    for _ in range(k):
        lo, hi = x, torch.full_like(x, d)
        for _ in range(16):
            lo, h = _mul_add_wide(lo, c, lo)
            hi = (h + hi) & U32
        x = lo ^ hi
    return x


_U32 = {"imad16": _imad16_state, "cios16": _cios16_state,
        "wide16": _wide16_state}


def plain(name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """body^k(x) elementwise, in torch ops, on any device."""
    body = BODIES[name]
    if x.dtype != body.dtype:
        raise TypeError(f"{name}: expected {body.dtype}, got {x.dtype}")
    if body.dtype == torch.float32:
        c, d = (torch.tensor(v, dtype=torch.float32, device=x.device)
                for v in (C_F32, D_F32))
        for _ in range(k):
            x = _F32[name](x, c, d)
        return x
    v = _U32[name](x.to(torch.int64) & U32, C_U32, D_U32, k)
    return (v - ((v >> 31) << 32)).to(torch.int32)


def run(name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """body^k(x): the plain version for a CPU tensor, the kernel for a CUDA
    tensor (which launches or raises)."""
    if x.device.type == "cpu":
        return plain(name, x, k)
    from . import vpu_roofline_cuda
    return vpu_roofline_cuda.roofline(name, x, k)


# -- measurement (card only) -------------------------------------------------

def _card_checked(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the probe measures a CUDA device; none is "
                           f"available as {device}")
    return device


def seeded_input(name: str, rows: int, batch: int, seed: int = 0,
                 device="cuda") -> torch.Tensor:
    """The probe's input: f32 in [0.5, 2) or int32 bit patterns, from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    if BODIES[name].dtype == torch.float32:
        x = rng.uniform(0.5, 2.0, (rows, batch)).astype(np.float32)
    else:
        x = rng.integers(0, 1 << 32, (rows, batch), dtype=np.uint64) \
            .astype(np.uint32).view(np.int32)
    return torch.as_tensor(x, device=device)


# values where a body's arithmetic has its edges, each also negated: zeros,
# infinities, NaN, denormals, the floor's 2^22 and 2^23 boundaries, and each
# of those over D_F32 (so that x * d lands on them); for the integer bodies
# the words 0, 1, 2^31 - 1, 2^31 and 2^32 - 1
_EDGE_F32 = [0.0, float("inf"), float("nan"), 1e-45, 1e-40, 0.5,
             2.0 ** 22 - 1, 2.0 ** 22 + 1, 2.0 ** 23 - 1, 2.0 ** 23,
             2.0 ** 23 + 1, 2.0 ** 24]
_EDGE_U32 = [0, 1, 0x7FFFFFFF, 0x80000000, U32]


def edge_values(name: str) -> torch.Tensor:
    """A rank-1 CPU tensor of the body's dtype holding its edge values."""
    if BODIES[name].dtype == torch.float32:
        v = np.array(_EDGE_F32, np.float32)
        v = np.concatenate([v, v / np.float32(D_F32)])
        return torch.as_tensor(np.concatenate([v, -v]))
    v = np.array(_EDGE_U32, np.uint64).astype(np.uint32).view(np.int32)
    return torch.as_tensor(v)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape and dtype, and the same bits in every element, any NaN
    matching any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def time_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Best of `reps` single calls, CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def graph_time_ms(fn, x: torch.Tensor, launches: int = 20,
                  reps: int = 5) -> float:
    """fn(x)'s device time per call, its bytes from and to HBM: `launches`
    calls captured in one CUDA graph, each on one of enough copies of x that
    the bytes read and written between two reads of one copy exceed twice
    the L2 cache, each call writing a new output; the best of `reps`
    replays (CUDA events) over `launches`.  A replay runs the calls back to
    back, so a kernel shorter than its host call (the wrapper's Python) is
    timed without the host in between."""
    l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
    nbytes = x.numel() * x.element_size()
    copies = min(launches, max(2, -(-(2 * l2 + nbytes) // (2 * nbytes))))
    xs = [x.clone() for _ in range(copies)]
    fn(xs[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(xs[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(xs[i % copies]) for i in range(launches)]
    ms = time_ms(graph.replay, reps, 1) / launches
    del outs, graph
    return ms


def nvidia_smi(query: str) -> str:
    """The first card's line of ``nvidia-smi --query-gpu=<query>
    --format=csv,noheader``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def peak_per_s(kind: str, sm_count: int, clock_mhz: float) -> float:
    """The published peak the body's peak_ops are held against."""
    if kind == "f32":
        return F32_PEAK_PER_S
    return sm_count * IMAD_PER_CLOCK_PER_SM * clock_mhz * 1e6


def measure(name: str, clock_mhz: float, rows: int = 48, batch: int = 65536,
            k1: int = 4096, k2: int = 16384, device="cuda") -> dict:
    """One body's slope on the card (the tool's protocol, :110-127, with
    CUDA events): ms at k1 and k2, best of 3 after a warm-up each; per
    iteration us; T census ops/s; T body evaluations/s; and the share of the
    published peak at the SM clock `clock_mhz`.  Raises if the share is
    above MAX_SHARE."""
    device = _card_checked(device)
    if not 0 < k1 < k2:
        raise ValueError("need 0 < k1 < k2")
    body = BODIES[name]
    x = seeded_input(name, rows, batch, device=device)
    from . import vpu_roofline_cuda
    ms = {k: time_ms(lambda k=k: vpu_roofline_cuda.roofline(name, x, k))
          for k in (k1, k2)}
    slope_s = (ms[k2] - ms[k1]) / (k2 - k1) / 1e3
    if slope_s <= 0:
        raise RuntimeError(f"{name}: non-positive slope {ms}")
    elems = rows * batch
    out = {"name": name, "rows": rows, "batch": batch, "k1": k1, "k2": k2,
           "ms_k1": ms[k1], "ms_k2": ms[k2], "us_per_iter": slope_s * 1e6,
           "t_ops_per_s": elems * body.ops / slope_s / 1e12,
           "t_evals_per_s": elems / slope_s / 1e12,
           "peak_ops_per_s": elems * body.peak_ops / slope_s,
           "peak_kind": body.peak_kind,
           "peak_per_s": peak_per_s(
               body.peak_kind,
               torch.cuda.get_device_properties(device).multi_processor_count,
               clock_mhz)}
    out["share"] = out["peak_ops_per_s"] / out["peak_per_s"]
    if out["share"] > MAX_SHARE:
        raise RuntimeError(
            f"{name}: {100 * out['share']:.1f}% of the published peak is "
            "above 105%: the op count or the timing is wrong")
    return out


def probe(clock_mhz: float, rows: int = 48, batch: int = 65536,
          k1: int = 4096, k2: int = 16384, device="cuda") -> list[dict]:
    """measure() for every body, in table order."""
    return [measure(n, clock_mhz, rows, batch, k1, k2, device)
            for n in BODIES]
