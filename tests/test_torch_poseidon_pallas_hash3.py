"""The port's plain hash3 against imt_tpu's Pallas hash3 kernel in interpret
mode, at canonical limbs, on a 128-lane numpy-seeded batch with the lanes
0, 1 and p - 1 (CPU).  Tolerance: exact."""

import numpy as np
import torch

from imt_tpu.ops import poseidon_rns_pallas as pk
from imt_tpu_torch.ops import poseidon

from test_torch_poseidon import lanes

torch.set_num_threads(1)


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
