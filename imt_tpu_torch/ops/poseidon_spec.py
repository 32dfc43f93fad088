"""Poseidon-BN254 constants (T=3, RATE=2, R_F=8, R_P=57) in Montgomery form.

Counterpart of ``imt_tpu.ops.poseidon_spec``: the same Grain-derived round
constants, MDS matrix and sponge IV, computed here from ``grain.py`` (about
two seconds of python-int work, once per process, at first use) rather than
read from the JAX package's ``.npz``.  A test holds these tables equal to
that file.  R = 2^256, as there.

The tables are 16-bit limbs ``uint32[..., 16]`` (the ``.npz`` layout);
``to_words`` packs them into the node form's 32-bit limbs ``uint32[..., 8]``,
which the CUDA kernel copies into constant memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import field
from .poseidon_ref import PoseidonParams, generate_params


@dataclass(frozen=True)
class PoseidonSpecArrays:
    t: int
    rate: int
    r_f: int
    r_p: int
    rc_mont: np.ndarray    # uint32[r_f + r_p, t, 16]
    mds_mont: np.ndarray   # uint32[t, t, 16]
    iv_mont: np.ndarray    # uint32[t, 16]   initial sponge state
    one_mont: np.ndarray   # uint32[16]      1 (the squeeze pad word)


def _mont_limbs(x: int) -> np.ndarray:
    return np.array(field._int_to_limbs_list((x * field.R) % field.P),
                    dtype=np.uint32)


def _build(params: PoseidonParams) -> PoseidonSpecArrays:
    rc = np.array([[_mont_limbs(c) for c in row]
                   for row in params.round_constants], dtype=np.uint32)
    mds = np.array([[_mont_limbs(m) for m in row] for row in params.mds],
                   dtype=np.uint32)
    iv = np.zeros((params.t, field.LIMBS), dtype=np.uint32)
    iv[0] = _mont_limbs((1 << 64) % field.P)
    return PoseidonSpecArrays(
        t=params.t, rate=params.rate, r_f=params.r_f, r_p=params.r_p,
        rc_mont=rc, mds_mont=mds, iv_mont=iv, one_mont=_mont_limbs(1))


@lru_cache(maxsize=None)
def default_params() -> PoseidonParams:
    return generate_params()


@lru_cache(maxsize=None)
def default_spec() -> PoseidonSpecArrays:
    return _build(default_params())


def to_words(limbs16: np.ndarray) -> np.ndarray:
    """uint32[..., 16] 16-bit limbs -> uint32[..., 8] 32-bit limbs."""
    x = np.asarray(limbs16, dtype=np.uint32)
    return x[..., 0::2] | (x[..., 1::2] << 16)
