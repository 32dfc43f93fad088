"""The port's plain permute_n and K1's kernel body (built for the host by
g++, tests/test_torch_poseidon_host.py) against imt_tpu's plain CIOS
engine (``poseidon_jax``'s permutation) and, marked slow, the plain
permute_n against its Pallas permute_n kernel in interpret mode: 2 chained
permutations of a 128-lane numpy-seeded state, each word decoded to
canonical limbs (CPU).  Tolerance: exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imt_tpu.ops import field as jfield
from imt_tpu.ops import field_rns, poseidon_jax
from imt_tpu.ops import poseidon_rns_pallas as pk
from imt_tpu_torch.ops import poseidon

from test_torch_poseidon import lanes
from test_torch_poseidon_host import build_harness, k1
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)


def _port_permute_n(words, permute_n=poseidon.permute_n) -> np.ndarray:
    nodes = torch.stack([poseidon.limbs_to_nodes(
        torch.as_tensor(w.astype(np.int32))) for w in words])
    got = permute_n(nodes, 2)
    return np.stack([poseidon.nodes_to_limbs(got[j]).numpy()
                     for j in range(3)])


@jax.jit
def _jax_permute_2(st):
    eng = poseidon_jax.default_engine()
    st = eng.permute(eng.permute(jfield.to_mont(st)))
    return jfield.normalize(jfield.from_mont(st))


@pytest.fixture(scope="module")
def imt_tpu_plain():
    """The state's words and imt_tpu's 2 chained permutations of them."""
    words = [lanes(31), lanes(32), lanes(33)]
    want = np.asarray(_jax_permute_2(jnp.stack(words, axis=1)))
    return words, want.transpose(1, 0, 2).astype(np.int32)


def test_plain_permute_n_matches_imt_tpu_plain(imt_tpu_plain):
    words, want = imt_tpu_plain
    assert np.array_equal(_port_permute_n(words), want)


def test_k1_body_matches_imt_tpu_plain(imt_tpu_plain, tmp_path):
    """K1's kernel body (permute_lane), built for the host by g++, on the
    same state."""
    words, want = imt_tpu_plain
    h = build_harness(tmp_path)
    assert np.array_equal(_port_permute_n(
        words, lambda st, n: k1(h, st, n)), want)


@pytest.mark.slow
def test_plain_permute_n_matches_pallas_interpret():
    words = [lanes(31), lanes(32), lanes(33)]
    st = jnp.concatenate([field_rns.from_limbs(jnp.asarray(w))
                          for w in words], axis=0)          # f32[144, 128]
    out = np.asarray(pk.permute_n(st, 2, t_tile=128, interpret=True))
    want = np.stack([np.asarray(field_rns.to_limbs(
        jnp.asarray(out[48 * j:48 * (j + 1)]))) for j in range(3)])

    assert np.array_equal(_port_permute_n(words), want.astype(np.int32))
