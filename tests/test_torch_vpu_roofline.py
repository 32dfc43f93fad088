"""imt_tpu_torch.ops.vpu_roofline's plain bodies against the TPU tool's
(CPU).

The tool's bodies and its kernel factory are closures inside
``tools/vpu_roofline.py::main`` (:50-106) and cannot be imported, so they are
restated here in jax.numpy and run through the same ``pallas_call`` (the
tool's BlockSpecs and memory spaces) with ``interpret=True``; every line of
the restated bodies and of the tool's body table is asserted to appear
verbatim in the tool's source, so the copy cannot drift.  Inputs: numpy-
seeded x in [0.5, 2), the tool's c, d = 1.000001, 1e-6, rows 8, B 256 (two
[8, 128] tiles), k 8.  The integer bodies are held against python ints
(cios16 and wide16 restated as 64- and 256-bit arithmetic).

Tolerance.  Op by op (jax.disable_jit: each primitive its own computation)
the restated bodies equal the plain version bit for bit, as the CUDA kernel
does on the card: every op rounds once.  Inside the interpreted kernel
XLA:CPU fuses the loop body and contracts ``x * c + d`` into one FMA, one
rounding where the port rounds twice; the kernel then equals a single-
rounding emulation bit for bit, and the plain version differs from it by at
most 1 ulp per multiply-add applied (c is within 1e-6 of 1, so an earlier
difference carries over unscaled): k ulp for muladd, 16 k for fma16.  The
other bodies have no multiply feeding an add and match the kernel exactly.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from imt_tpu_torch.ops import vpu_roofline as vr
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tools", "vpu_roofline.py")) as _f:
    TOOL = _f.read()

ROWS, B, T, K = 8, 256, 128, 8


# -- the tool's bodies, restated line for line (tools/vpu_roofline.py:50-81)

def mul16(x, c, d):
    for _ in range(16):
        x = x * c
    return x


def fma16(x, c, d):
    for _ in range(16):
        x = x * c + d
    return x


def mod4(x, c, d):
    for _ in range(4):
        x = x - c * jnp.floor(x * d)
    return x


def ilp16(x, c, d):
    a = ((x * c) * c) * c
    b = ((x * d) * d) * d
    e = ((x + c) + c) + c
    f_ = ((x + d) + d) + d
    return (a * b) * (e * f_)


BODY_TABLE = '''
        "mul":    (1, lambda x, c, d: x * c),
        "muladd": (2, lambda x, c, d: x * c + d),
        "mul16":  (16, mul16),
        "fma16":  (32, fma16),
        "mod4":   (16, mod4),
        "ilp16":  (16, ilp16),
'''
BODIES = {
    "mul": (1, lambda x, c, d: x * c),
    "muladd": (2, lambda x, c, d: x * c + d),
    "mul16": (16, mul16),
    "fma16": (32, fma16),
    "mod4": (16, mod4),
    "ilp16": (16, ilp16),
}


def make(body_fn, k):
    """The tool's make() (:83-106) at this file's sizes, interpreted."""
    def kernel(c_ref, x_ref, o_ref):
        c = c_ref[0, 0]
        d = c_ref[0, 1]

        def step(i, x):
            return body_fn(x, c, d)
        o_ref[:] = jax.lax.fori_loop(0, k, step, x_ref[:])

    @jax.jit
    def f(cd, x):
        spec = pl.BlockSpec((ROWS, T), lambda i: (0, i),
                            memory_space=pltpu.VMEM)
        return pl.pallas_call(
            kernel, grid=(B // T,),
            in_specs=[pl.BlockSpec((1, 2), lambda i: (0, 0),
                                   memory_space=pltpu.SMEM), spec],
            out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((ROWS, B), jnp.float32),
            interpret=True,
        )(cd, x)
    return f


def test_restated_bodies_appear_verbatim_in_the_tool():
    for fn in (mul16, fma16, mod4, ilp16):
        for line in inspect.getsource(fn).splitlines():
            assert line.strip() in TOOL, line
    for line in BODY_TABLE.strip().splitlines():
        assert line.strip() in TOOL, line
    assert "cd = jnp.asarray([[1.000001, 0.000001]], jnp.float32)" in TOOL
    assert "o_ref[:] = jax.lax.fori_loop(0, k, step, x_ref[:])" in TOOL


def test_census_counts_match_the_tool():
    for name, (ops, _) in BODIES.items():
        assert vr.BODIES[name].ops == ops, name
        assert vr.BODIES[name].dtype == torch.float32
    assert list(vr.BODIES)[:6] == list(BODIES)


@pytest.fixture(scope="module")
def x_f32():
    return np.random.default_rng(7).uniform(0.5, 2.0, (ROWS, B)) \
        .astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32).astype(np.int64)


@pytest.mark.parametrize("name", list(BODIES))
def test_plain_f32_body_equals_the_tools_body_op_by_op(name, x_f32):
    c, d = np.float32(vr.C_F32), np.float32(vr.D_F32)
    with jax.disable_jit():
        want = jnp.asarray(x_f32)
        for _ in range(K):
            want = BODIES[name][1](want, c, d)
    got = vr.run(name, torch.as_tensor(x_f32), K).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))


# multiply-adds per application of the bodies XLA:CPU contracts
CONTRACTED = {"muladd": 1, "fma16": 16}


@pytest.mark.parametrize("name", list(BODIES))
def test_plain_f32_body_against_the_tools_kernel(name, x_f32):
    cd = jnp.asarray([[vr.C_F32, vr.D_F32]], jnp.float32)
    want = np.asarray(make(BODIES[name][1], K)(cd, jnp.asarray(x_f32)))
    got = vr.run(name, torch.as_tensor(x_f32), K).numpy()
    if name not in CONTRACTED:
        assert np.array_equal(_bits(got), _bits(want))
        return
    n = K * CONTRACTED[name]
    fused = x_f32.copy()
    c, d = np.float64(np.float32(vr.C_F32)), np.float64(np.float32(vr.D_F32))
    for _ in range(n):
        fused = (fused.astype(np.float64) * c + d).astype(np.float32)
    assert np.array_equal(_bits(fused), _bits(want))   # XLA:CPU: one rounding
    ulps = np.abs(_bits(got) - _bits(want))
    assert ulps.max() <= n and ulps.any()


def _python_int(name: str, x: int, k: int) -> int:
    m = (1 << 32) - 1
    c, d = vr.C_U32, vr.D_U32
    if name == "imad16":
        for _ in range(16 * k):
            x = (x * c + d) & m
        return x
    if name == "wide16":
        for _ in range(k):
            a = x + (d << 32)
            for _ in range(16):
                a = ((a & m) * c + a) % (1 << 64)
            x = (a & m) ^ (a >> 32)
        return x
    # cios16: 8 words a[j] = x + j d of 64 bits, row words w[j] = c + j d;
    # a row is p[j] = (lo(a[0]) c mod 2^32) w[j] + a[j] mod 2^64, s = (low
    # words of p rotated down one word) + (high words of p) mod 2^256, and
    # a[j] = s[j] + 2^32 hi(p[j+1 mod 8]); two rows an application
    a = [(x + j * d) & m for j in range(8)]
    w = [(c + j * d) & m for j in range(8)]
    for _ in range(2 * k):
        mult = (a[0] & m) * c & m
        p = [(mult * w[j] + a[j]) % (1 << 64) for j in range(8)]
        lo = sum((p[(j + 1) % 8] & m) << (32 * j) for j in range(8))
        hi = sum((p[j] >> 32) << (32 * j) for j in range(8))
        s = (lo + hi) % (1 << 256)
        a = [(s >> (32 * j)) & m | (p[(j + 1) % 8] >> 32) << 32
             for j in range(8)]
    return a[0] & m


@pytest.mark.parametrize("name", ["imad16", "cios16", "wide16"])
def test_plain_integer_body_equals_python_ints(name):
    x = vr.seeded_input(name, 3, 11, seed=5, device="cpu")
    x[0, 0], x[0, 1], x[0, 2] = 0, -1, -(1 << 31)        # edge bit patterns
    got = vr.run(name, x, 3).numpy().view(np.uint32)
    for (i, j), v in np.ndenumerate(x.numpy().view(np.uint32)):
        assert int(got[i, j]) == _python_int(name, int(v), 3), (i, j)


def test_plain_refuses_the_wrong_dtype():
    with pytest.raises(TypeError):
        vr.plain("imad16", torch.zeros(4), 1)
    with pytest.raises(TypeError):
        vr.plain("mul", torch.zeros(4, dtype=torch.int32), 1)
