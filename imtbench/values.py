"""The traffic's values: uniform random BN254 field elements from a seed.

Nullifiers are Poseidon outputs, so uniform over [1, p) is their real
distribution.  Made on the host, as a node receives them, in one bulk
draw: 254-bit candidates, those at or above p and zero rejected.  The same
seed gives the same values in the same order, whatever the seed's size.
"""

from __future__ import annotations

import numpy as np

from .reference.poseidon import spec
from .reference.tree import keys


def field_values(seed: int, n: int) -> np.ndarray:
    """int32 [16, n]: n uniform field elements in [1, p), canonical 16-bit
    limbs (limb 0 least significant)."""
    rng = np.random.default_rng(abs(int(seed)))
    p = spec()["p"]
    pkey = keys(np.array([[(p >> (16 * i)) & 0xFFFF] for i in range(16)]))[0]
    out, have = [], 0
    while have < n:
        m = int((n - have) * 1.35) + 64
        c = rng.integers(0, 1 << 16, size=(16, m), dtype=np.uint16)
        c[15] &= (1 << 14) - 1                       # 254 bits
        k = keys(c)
        c = c[:, (k < pkey) & c.any(axis=0)]
        out.append(c[:, :n - have])
        have += out[-1].shape[1]
    return np.ascontiguousarray(np.concatenate(out, axis=1), dtype=np.int32)
