"""The port's plain permute_n against imt_tpu's plain CIOS engine
(``poseidon_jax``'s permutation) and, marked slow, against its Pallas
permute_n kernel in interpret mode: 2 chained permutations of a 128-lane
numpy-seeded state, each word decoded to canonical limbs (CPU).
Tolerance: exact."""

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

torch.set_num_threads(1)


def _port_permute_n(words) -> np.ndarray:
    nodes = torch.stack([poseidon.limbs_to_nodes(
        torch.as_tensor(w.astype(np.int32))) for w in words])
    got = poseidon.permute_n(nodes, 2)
    return np.stack([poseidon.nodes_to_limbs(got[j]).numpy()
                     for j in range(3)])


@jax.jit
def _jax_permute_2(st):
    eng = poseidon_jax.default_engine()
    st = eng.permute(eng.permute(jfield.to_mont(st)))
    return jfield.normalize(jfield.from_mont(st))


def test_plain_permute_n_matches_imt_tpu_plain():
    words = [lanes(31), lanes(32), lanes(33)]
    want = np.asarray(_jax_permute_2(jnp.stack(words, axis=1)))
    assert np.array_equal(_port_permute_n(words),
                          want.transpose(1, 0, 2).astype(np.int32))


@pytest.mark.slow
def test_plain_permute_n_matches_pallas_interpret():
    words = [lanes(31), lanes(32), lanes(33)]
    st = jnp.concatenate([field_rns.from_limbs(jnp.asarray(w))
                          for w in words], axis=0)          # f32[144, 128]
    out = np.asarray(pk.permute_n(st, 2, t_tile=128, interpret=True))
    want = np.stack([np.asarray(field_rns.to_limbs(
        jnp.asarray(out[48 * j:48 * (j + 1)]))) for j in range(3)])

    assert np.array_equal(_port_permute_n(words), want.astype(np.int32))
