"""Poseidon-BN254 constants (T=3, RATE=2, R_F=8, R_P=57) in Montgomery form.

Counterpart of ``imt_tpu.ops.poseidon_spec``: the same Grain-derived round
constants, MDS matrix and sponge IV, computed here from ``grain.py`` (about
two seconds of python-int work, once per process, at first use) rather than
read from the JAX package's ``.npz``.  A test holds these tables equal to
that file.  R = 2^256, as there.  Beside the standard schedule's tables it
holds the sparse schedule's (``poseidon_opt.optimize_params``): the leading
and trailing full rounds' constants, the last leading round's folded MDS,
and each partial round's scalar constant and sparse matrix.

The tables are 16-bit limbs ``uint32[..., 16]`` (the ``.npz`` layout);
``to_words`` packs them into the node form's 32-bit limbs ``uint32[..., 8]``,
and ``kernel_words`` lays them out as the CUDA kernel's ``Consts`` struct,
which it copies into constant memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import field
from .poseidon_opt import optimize_params
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
    # the sparse schedule (poseidon_opt.permute_opt)
    pre_rounds_mont: np.ndarray    # uint32[r_f / 2, t, 16]
    mds_last_pre_mont: np.ndarray  # uint32[t, t, 16]
    partial_c0_mont: np.ndarray    # uint32[r_p, 16]
    sparse_mont: np.ndarray        # uint32[r_p, 5, 16] (m00, v1, v2, w1, w2)
    post_rounds_mont: np.ndarray   # uint32[r_f / 2, t, 16]


def _mont_limbs(x: int) -> np.ndarray:
    return np.array(field._int_to_limbs_list((x * field.R) % field.P),
                    dtype=np.uint32)


def _mont_table(rows) -> np.ndarray:
    """Nested tuples of python ints -> uint32[..., 16] Montgomery limbs."""
    if isinstance(rows, int):
        return _mont_limbs(rows)
    return np.stack([_mont_table(r) for r in rows])


def _build(params: PoseidonParams) -> PoseidonSpecArrays:
    iv = np.zeros((params.t, field.LIMBS), dtype=np.uint32)
    iv[0] = _mont_limbs((1 << 64) % field.P)
    opt = optimize_params(params)
    return PoseidonSpecArrays(
        t=params.t, rate=params.rate, r_f=params.r_f, r_p=params.r_p,
        rc_mont=_mont_table(params.round_constants),
        mds_mont=_mont_table(params.mds), iv_mont=iv,
        one_mont=_mont_limbs(1),
        pre_rounds_mont=_mont_table(opt.pre_rounds),
        mds_last_pre_mont=_mont_table(opt.mds_last_pre),
        partial_c0_mont=_mont_table(opt.partial_c0),
        sparse_mont=_mont_table(opt.sparse),
        post_rounds_mont=_mont_table(opt.post_rounds))


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


# PoseidonSpecArrays fields in the order of the kernel's Consts struct
# (csrc/poseidon_bn254.cu); iv_mont contributes its word 0 only
KERNEL_TABLES = ("rc_mont", "mds_mont", "iv_mont", "one_mont",
                 "pre_rounds_mont", "mds_last_pre_mont", "partial_c0_mont",
                 "sparse_mont", "post_rounds_mont")


@lru_cache(maxsize=None)
def kernel_words() -> np.ndarray:
    """The kernel's constant tables as one uint32 array, word by word in the
    order of its Consts struct."""
    s = default_spec()
    tabs = [getattr(s, name) for name in KERNEL_TABLES]
    tabs[KERNEL_TABLES.index("iv_mont")] = s.iv_mont[0]
    return np.ascontiguousarray(np.concatenate(
        [to_words(t).ravel() for t in tabs]))
