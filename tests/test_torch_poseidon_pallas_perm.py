"""The port's plain permute_n against imt_tpu's Pallas permute_n kernel in
interpret mode: 2 chained permutations of a 128-lane numpy-seeded state,
each word decoded to canonical limbs (CPU).  Tolerance: exact."""

import numpy as np
import torch

import jax.numpy as jnp

from imt_tpu.ops import field_rns
from imt_tpu.ops import poseidon_rns_pallas as pk
from imt_tpu_torch.ops import poseidon

from test_torch_poseidon import lanes

torch.set_num_threads(1)


def test_plain_permute_n_matches_pallas_interpret():
    words = [lanes(31), lanes(32), lanes(33)]
    st = jnp.concatenate([field_rns.from_limbs(jnp.asarray(w))
                          for w in words], axis=0)          # f32[144, 128]
    out = np.asarray(pk.permute_n(st, 2, t_tile=128, interpret=True))
    want = np.stack([np.asarray(field_rns.to_limbs(
        jnp.asarray(out[48 * j:48 * (j + 1)]))) for j in range(3)])

    nodes = torch.stack([poseidon.limbs_to_nodes(
        torch.as_tensor(w.astype(np.int32))) for w in words])
    got = poseidon.permute_n(nodes, 2)
    got = np.stack([poseidon.nodes_to_limbs(got[j]).numpy()
                    for j in range(3)])
    assert np.array_equal(got, want.astype(np.int32))
