"""The port's Poseidon constants and plain torch hashes (CPU).

Constants against the JAX package's .npz, the reference anchors, the plain
hashes against the python-int oracle, and hash2 against imt_tpu's plain
CIOS engine (``imt_tpu.ops.poseidon_jax``, the XLA path its Pallas kernel
is held against), compared at canonical limbs.  hash3 and permute_n are in
test_torch_poseidon_pallas_*.py.  The comparisons with the Pallas kernel
itself in interpret mode (as tests/test_poseidon_rns_pallas.py runs it,
~40-60 s each on this CPU) are marked slow.  Tolerance: exact.
"""

import os

import numpy as np
import pytest
import torch

from imt_tpu.ops import field as jfield
from imt_tpu.ops import poseidon_jax
from imt_tpu.ops import poseidon_rns_pallas as pk
from imt_tpu_torch.ops import field, hashing, poseidon
from imt_tpu_torch.ops.poseidon_ref import hash_fixed
from imt_tpu_torch.ops.poseidon_spec import default_params, default_spec
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

ANCHOR_H000 = 1960587138944869480785025106734196872454309951825657414575195034687326603497
TV_PERM_012 = [
    0x115cc0f5e7d690413df64c6b9662e9cf2a3617f2743245519e19607a4417189a,
    0x0fca49b798923ab0239de1c9e7a4a9a2210312b6a2f616d18b5a87f9b628ae29,
    0x0e7ae82e40091e63cbd4f16a6d16310b3729d4b6e138fcf54110e2867045a30c,
]
NPZ = os.path.join(os.path.dirname(__file__), "..", "imt_tpu", "ops",
                   "poseidon_bn254_t3_8_57.npz")


def lanes(seed: int, n: int = 128) -> np.ndarray:
    """uint32[16, n] numpy-seeded values < p, with lanes 0, 1, p-1 first."""
    rng = np.random.default_rng(seed)
    xs = [0, 1, field.P - 1] + [
        int.from_bytes(rng.bytes(32), "little") % field.P
        for _ in range(n - 3)]
    return jfield.ints_to_limbs(xs)


def test_constants_equal_npz():
    z = np.load(NPZ)
    s = default_spec()
    for name in ("rc_mont", "mds_mont", "iv_mont", "one_mont"):
        assert np.array_equal(getattr(s, name), z[name]), name
    assert (s.r_f, s.r_p, s.t, s.rate) == (8, 57, 3, 2)


def test_anchor_and_permutation_vector():
    z = torch.zeros((16, 1), dtype=torch.int32)
    assert field.limbs_to_int(hashing.hash3(z, z, z)[:, 0]) == ANCHOR_H000
    st = torch.stack([torch.as_tensor(field.int_to_node(v))[:, None]
                      for v in (0, 1, 2)])
    out = poseidon.permute_n(st, 1)
    assert [field.node_to_int(out[j, :, 0].numpy())
            for j in range(3)] == TV_PERM_012


def test_plain_hashes_match_python_oracle():
    la, lb, lc = (lanes(s, 6) for s in (1, 2, 3))
    a, b, c = (torch.as_tensor(x.astype(np.int32)) for x in (la, lb, lc))
    xa, xb, xc = (jfield.limbs_to_ints(x) for x in (la, lb, lc))
    params = default_params()
    assert field.limbs_to_ints(hashing.hash2(a, b).numpy()) == [
        hash_fixed([x, y], params) for x, y in zip(xa, xb)]
    assert field.limbs_to_ints(hashing.hash3(a, b, c).numpy()) == [
        hash_fixed([x, y, w], params) for x, y, w in zip(xa, xb, xc)]
    # the node API composes to the same hash
    h = hashing.dec_nodes(hashing.hash2_nodes(hashing.enc_nodes(a),
                                              hashing.enc_nodes(b)))
    assert torch.equal(h, hashing.hash2(a, b))


def test_plain_hash2_matches_imt_tpu_plain():
    la, lb = lanes(11), lanes(12)
    want = np.asarray(poseidon_jax.hash2(la, lb))
    got = hashing.hash2(torch.as_tensor(la.astype(np.int32)),
                         torch.as_tensor(lb.astype(np.int32)))
    assert np.array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.slow
def test_plain_hash2_matches_pallas_interpret():
    la, lb = lanes(11), lanes(12)
    want = np.asarray(pk.hash2(la, lb, t_tile=128, interpret=True))
    got = hashing.hash2(torch.as_tensor(la.astype(np.int32)),
                         torch.as_tensor(lb.astype(np.int32)))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
