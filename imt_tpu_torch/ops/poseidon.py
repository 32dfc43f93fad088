"""Plain torch Poseidon-BN254 (T=3, x^5, 8 full + 57 partial rounds).

The plain version of every entry point of the CUDA kernel
(``csrc/poseidon_bn254.cu``), in the role ``imt_tpu.ops.poseidon_jax`` /
``poseidon_rns`` play for the Pallas kernel: the CPU tests run it, and
``chip_smoke.py`` holds the kernel against it on the card.  It runs the
standard round structure of ``poseidon_ref.permute`` on working limbs
(``field.py``): the S-boxes of all state words in one batched Montgomery
product, and each MDS row as one Montgomery dot product.  Inputs and
outputs are the port's int32 forms: canonical limbs ``[16, B]`` and nodes
``[8, B]`` (Montgomery, fully reduced), so its outputs equal the kernel's
bit for bit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import field
from .poseidon_spec import default_spec


@lru_cache(maxsize=None)
def _consts(device: str):
    """Round constants, MDS, IV word and pad word as working limbs, limb
    axis first: rc [rounds, 16, 3, 1], mds [16, 3 (row), 1, 3 (column)],
    iv0/one [16, 1]."""
    s = default_spec()
    t = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
    rc = t(s.rc_mont).permute(0, 2, 1)[..., None].contiguous()
    mds = t(s.mds_mont).permute(2, 0, 1)[:, :, None].contiguous()
    return rc, mds, t(s.iv_mont[0])[:, None], t(s.one_mont)[:, None], \
        s.r_f, s.r_p


def _pow5(x):
    x2 = field.mont_mul(x, x)
    return field.mont_mul(field.mont_mul(x2, x2), x)


def _permute(st: torch.Tensor) -> torch.Tensor:
    """One permutation of working-limb states [16, 3, B] (Montgomery)."""
    rc, mds, _, _, r_f, r_p = _consts(str(st.device))
    half = r_f // 2
    for r in range(r_f + r_p):
        s = field.add_mod(st, rc[r])
        if half <= r < half + r_p:
            s = torch.cat([_pow5(s[:, :1]), s[:, 1:]], dim=1)
        else:
            s = _pow5(s)
        # st_i = sum_j mds_ij * s_j: one reduction per row
        st = field.mont_dot(mds, s.transpose(1, 2)[:, None])
    return st


def _sponge(a_m, b_m, c_m=None) -> torch.Tensor:
    """2- or 3-input fixed-length sponge on Montgomery working limbs
    [16, B]; returns the squeezed word (Montgomery working limbs)."""
    _, _, iv0, one, _, _ = _consts(str(a_m.device))
    st = torch.stack([iv0.expand_as(a_m), a_m, b_m], dim=1)
    st = _permute(st)
    if c_m is None:
        st = torch.stack([st[:, 0], field.add_mod(st[:, 1], one), st[:, 2]],
                         dim=1)
    else:
        st = torch.stack([st[:, 0], field.add_mod(st[:, 1], c_m),
                          field.add_mod(st[:, 2], one)], dim=1)
    return _permute(st)[:, 1]


def hash_fixed(cols) -> torch.Tensor:
    """Fixed-length hash of any arity n >= 1 (the halo2-base
    ``hash_fix_len_array`` contract; ``imt_tpu.ops.poseidon_jax``
    ``Poseidon.hash_fixed``, :178).  cols: n canonical limb tensors
    int32[16, B]; returns canonical limbs int32[16, B].

    The sponge absorbs the inputs followed by one pad word 1, in chunks of
    RATE = 2 with a permutation after each: the first chunk seeds words 1
    and 2 of the state [iv0, 0, 0] and each further chunk is added to them
    mod p, so an odd n ends with the chunk [last input, 1] and an even n
    with the pad alone, added to word 1.  That is n // 2 + 1 permutations;
    arity 2 and 3 give ``hash2`` and ``hash3``.  The squeezed word is word
    1."""
    if not cols:
        raise ValueError("hash_fixed needs at least one input")
    xs = [field.to_mont(field.limbs_to_work(c)) for c in cols]
    _, _, iv0, one, _, _ = _consts(str(xs[0].device))
    seq = xs + [one.expand_as(xs[0])]
    st = _permute(torch.stack([iv0.expand_as(xs[0]), seq[0], seq[1]], dim=1))
    for k in range(2, len(seq), 2):
        chunk = seq[k:k + 2]
        w2 = field.add_mod(st[:, 2], chunk[1]) if len(chunk) == 2 \
            else st[:, 2]
        st = _permute(torch.stack(
            [st[:, 0], field.add_mod(st[:, 1], chunk[0]), w2], dim=1))
    return field.work_to_limbs(field.from_mont(st[:, 1]))


def permute_n(st: torch.Tensor, n_perms: int = 1) -> torch.Tensor:
    """n_perms chained permutations of node states int32[3, 8, B]."""
    w = torch.stack([field.nodes_to_work(st[j]) for j in range(3)], dim=1)
    for _ in range(n_perms):
        w = _permute(w)
    return torch.stack([field.work_to_nodes(w[:, j]) for j in range(3)])


def hash2_nodes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H(a, b) on nodes int32[8, B] x2 -> nodes int32[8, B]."""
    out = _sponge(field.nodes_to_work(a), field.nodes_to_work(b))
    return field.work_to_nodes(out)


def hash3_leaf(a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """H(a, b, c) on canonical limbs int32[16, B] x3 -> nodes int32[8, B]."""
    m = field.to_mont(field.limbs_to_work(torch.stack([a, b, c], dim=1)))
    return field.work_to_nodes(_sponge(m[:, 0], m[:, 1], m[:, 2]))


def limbs_to_nodes(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical limbs int32[16, B] -> nodes int32[8, B] (reduced mod p)."""
    return field.work_to_nodes(field.to_mont(field.limbs_to_work(limbs)))


def nodes_to_limbs(nodes: torch.Tensor) -> torch.Tensor:
    """Nodes int32[8, B] -> canonical limbs int32[16, B]."""
    return field.work_to_limbs(field.from_mont(field.nodes_to_work(nodes)))


def hash2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H(a, b) on canonical limbs int32[16, B] -> canonical limbs."""
    return nodes_to_limbs(hash2_nodes(limbs_to_nodes(a), limbs_to_nodes(b)))


def hash3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """H(a, b, c) on canonical limbs int32[16, B] -> canonical limbs."""
    return nodes_to_limbs(hash3_leaf(a, b, c))
