"""Grain LFSR pseudo-random bit generator for Poseidon constant derivation.

Derives round constants and the Cauchy MDS matrix for the Poseidon permutation
over the BN254 scalar field, following the Poseidon-128 reference parameter
generation procedure (Grain LFSR seeded with the field/sbox/width/round tags).

The reference implementation (aerius-labs/indexed-merkle-tree-halo2) obtains
these constants from its `pse-poseidon` dependency (Cargo.toml:16) and pins
their exact values via the test-vector anchor
Poseidon(0,0,0) = 0x0455a72abf50fec790cc5631244628bc243c3c4563dad15b71383b4e625748e9
(reference src/indexed_merkle_tree.rs:247-251 and :805-810).  This module is a
from-scratch implementation of the public Poseidon parameter-generation spec;
`tests/test_poseidon_spec.py` asserts bit-exactness against that anchor.

Everything here is host-side pure-Python integer math; it runs once and the
resulting constants are baked into Montgomery tables by `poseidon_spec.py`
(a copy of ``imt_tpu.ops.grain``, so that the port never imports the JAX
package).
"""

from __future__ import annotations

# BN254 scalar field modulus (reference src/indexed_merkle_tree.rs:382-385).
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617

_STATE_BITS = 80
_TAPS = (62, 51, 38, 23, 13, 0)


class Grain:
    """80-bit Grain LFSR, seeded per the Poseidon parameter-generation spec.

    Seed layout (MSB-first per field):
      [0:2)   field tag (1 = prime field)
      [2:6)   sbox tag  (0 = x^alpha)
      [6:18)  field size in bits (254 for BN254 Fr)
      [18:30) t (state width)
      [30:40) R_F (full rounds)
      [40:50) R_P (partial rounds)
      [50:80) all-ones padding
    The first 160 output bits are discarded.
    """

    def __init__(self, t: int, r_f: int, r_p: int, n_bits: int = 254,
                 field_tag: int = 1, sbox_tag: int = 0):
        bits = []

        def put(value: int, width: int) -> None:
            for i in reversed(range(width)):
                bits.append((value >> i) & 1)

        put(field_tag, 2)
        put(sbox_tag, 4)
        put(n_bits, 12)
        put(t, 12)
        put(r_f, 10)
        put(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == _STATE_BITS
        self.state = bits
        self.n_bits = n_bits
        for _ in range(160):
            self._raw_bit()

    def _raw_bit(self) -> int:
        s = self.state
        nb = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(nb)
        return nb

    def bit(self) -> int:
        """Next output bit: raw bits are consumed in pairs (b1, b2); b2 is
        emitted iff b1 == 1, otherwise both are discarded."""
        while True:
            b1 = self._raw_bit()
            b2 = self._raw_bit()
            if b1:
                return b2

    def int_msb(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def int_lsb(self, n: int) -> int:
        v = 0
        for i in range(n):
            if self.bit():
                v |= 1 << i
        return v

    def field_element_rejection(self) -> int:
        """Sample n_bits MSB-first; reject-and-retry until < P."""
        while True:
            v = self.int_msb(self.n_bits)
            if v < P:
                return v

    def field_element_nonrej_msb(self) -> int:
        return self.int_msb(self.n_bits) % P

    def field_element_nonrej_lsb(self) -> int:
        return self.int_lsb(self.n_bits) % P


def generate_round_constants(grain: Grain, t: int, n_rounds: int,
                             mode: str = "rej_msb") -> list[list[int]]:
    """n_rounds rows of t round constants, drawn row-major from the grain.

    The convention that reproduces the reference anchor (verified against
    Poseidon(0,0,0) and the official poseidonperm_x5_254_3 permutation test
    vector) is MSB-first sampling WITH rejection.
    """
    sample = {
        "rej_msb": grain.field_element_rejection,
        "nonrej_msb": grain.field_element_nonrej_msb,
        "nonrej_lsb": grain.field_element_nonrej_lsb,
    }[mode]
    return [[sample() for _ in range(t)] for _ in range(n_rounds)]


def generate_mds(grain: Grain, t: int) -> list[list[int]]:
    """Cauchy MDS matrix: mds[i][j] = 1 / (x_i + y_j) with x, y drawn from the
    same grain stream after the round constants, WITHOUT rejection sampling
    (MSB-first, reduced mod P) — this is the convention of the Poseidon
    reference parameter script, verified by the anchor vectors."""
    xs = [grain.field_element_nonrej_msb() for _ in range(t)]
    ys = [grain.field_element_nonrej_msb() for _ in range(t)]
    return [[pow((x + y) % P, P - 2, P) for y in ys] for x in xs]
