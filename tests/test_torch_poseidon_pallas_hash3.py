"""The port's plain hash3 against imt_tpu's plain CIOS engine
(``poseidon_jax``) and, marked slow, against its Pallas hash3 kernel in
interpret mode, at canonical limbs, on a 128-lane numpy-seeded batch with
the lanes 0, 1 and p - 1 (CPU).  Tolerance: exact."""

import numpy as np
import pytest
import torch

from imt_tpu.ops import poseidon_jax
from imt_tpu.ops import poseidon_rns_pallas as pk
from imt_tpu_torch.ops import poseidon

from test_torch_poseidon import lanes

torch.set_num_threads(1)


def test_plain_hash3_matches_imt_tpu_plain():
    la, lb, lc = lanes(21), lanes(22), lanes(23)
    want = np.asarray(poseidon_jax.hash3(la, lb, lc)).astype(np.int32)
    a, b, c = (torch.as_tensor(x.astype(np.int32)) for x in (la, lb, lc))
    assert np.array_equal(poseidon.hash3(a, b, c).numpy(), want)
    # hash3_leaf is the same hash, left in node form
    assert np.array_equal(
        poseidon.nodes_to_limbs(poseidon.hash3_leaf(a, b, c)).numpy(), want)


@pytest.mark.slow
def test_plain_hash3_matches_pallas_interpret():
    la, lb, lc = lanes(21), lanes(22), lanes(23)
    want = np.asarray(pk.hash3(la, lb, lc, t_tile=128, interpret=True))
    a, b, c = (torch.as_tensor(x.astype(np.int32)) for x in (la, lb, lc))
    assert np.array_equal(poseidon.hash3(a, b, c).numpy(),
                          want.astype(np.int32))
    # hash3_leaf is the same hash, left in node form
    assert np.array_equal(
        poseidon.nodes_to_limbs(poseidon.hash3_leaf(a, b, c)).numpy(),
        want.astype(np.int32))
