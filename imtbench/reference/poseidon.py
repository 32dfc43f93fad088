"""Plain Poseidon-BN254 (T=3, RATE=2, R_F=8, R_P=57), the benchmark's own.

Written from the spec, not imported from the program: the constants come
from the Grain LFSR of the Poseidon paper's parameter generation (round
constants MSB-first with rejection, then a Cauchy MDS matrix from the
same stream without it), and the published anchor Poseidon(0,0,0) of the
reference circuit (``ANCHOR``) is the independent witness that fixes them.
The sponge is the pse-poseidon one: state [2^64, 0, 0], absorb RATE words
then permute, squeeze by padding with a single 1, so a 2- or 3-input hash
is exactly two permutations.

Two forms:

* ``hash_int`` / ``permute_int``: python ints, the spec as written (standard
  rounds, no optimisation).  For a few hashes (the zero spine, tests).
* ``Hasher``: the same rounds vectorised over lanes with plain torch ops
  (no kernel of the program, no custom kernel), on any device.  A field
  element is int64 ``[..., 10, B]``: ten 28-bit limbs, in Montgomery form
  with R = 2^280.  Limbs are kept lazy (each below 2^28 + 64) and values
  below 4p; every bound that keeps int64 exact is stated where it is used.
  The MDS products by constants run as float64 matmuls on 14-bit halves of
  the constants, where every sum is an integer below 2^53, so exact.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

L = 28                      # bits a limb
N = 10                      # limbs: 280 bits
MASK = (1 << L) - 1
R_BITS = L * N


P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
T, RATE, R_F, R_P = 3, 2, 8, 57
# Poseidon(0, 0, 0) as the reference circuit's tests pin it
# (aerius-labs/indexed-merkle-tree-halo2 src/indexed_merkle_tree.rs)
ANCHOR = 0x0455a72abf50fec790cc5631244628bc243c3c4563dad15b71383b4e625748e9


def _grain_bits(t: int, r_f: int, r_p: int, n_bits: int):
    """The parameter spec's Grain LFSR: an 80-bit state seeded with the
    field tag 1 (2 bits), the S-box tag 0 (4), the field's bits (12), t
    (12), R_F (10), R_P (10) and 30 ones; 160 bits discarded; then bits in
    pairs, the second given out only where the first is 1."""
    state = []
    for value, width in ((1, 2), (0, 4), (n_bits, 12), (t, 12), (r_f, 10),
                         (r_p, 10), ((1 << 30) - 1, 30)):
        state += [(value >> i) & 1 for i in reversed(range(width))]

    def raw():
        b = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] \
            ^ state[0]
        state.pop(0)
        state.append(b)
        return b

    for _ in range(160):
        raw()
    while True:
        if raw():
            yield raw()
        else:
            raw()


@lru_cache(maxsize=None)
def spec() -> dict:
    n_bits = P.bit_length()
    bits = _grain_bits(T, R_F, R_P, n_bits)

    def msb():
        v = 0
        for _ in range(n_bits):
            v = (v << 1) | next(bits)
        return v

    def rejected():
        while True:
            v = msb()
            if v < P:
                return v

    rc = [[rejected() for _ in range(T)] for _ in range(R_F + R_P)]
    xs = [msb() % P for _ in range(T)]
    ys = [msb() % P for _ in range(T)]
    mds = [[pow((x + y) % P, P - 2, P) for y in ys] for x in xs]
    return {"p": P, "t": T, "rate": RATE, "r_f": R_F, "r_p": R_P,
            "rc": rc, "mds": mds}


# -- python ints: the spec as written --------------------------------------

def permute_int(state: list) -> list:
    s = spec()
    p, t, half = s["p"], s["t"], s["r_f"] // 2
    for r in range(s["r_f"] + s["r_p"]):
        st = [(state[i] + s["rc"][r][i]) % p for i in range(t)]
        if half <= r < half + s["r_p"]:
            st[0] = pow(st[0], 5, p)
        else:
            st = [pow(x, 5, p) for x in st]
        state = [sum(s["mds"][i][j] * st[j] for j in range(t)) % p
                 for i in range(t)]
    return state


def hash_int(inputs: list) -> int:
    """Fixed-length sponge hash of python ints (halo2-base
    hash_fix_len_array, as the reference circuit hashes a leaf or a node)."""
    s = spec()
    p, rate = s["p"], s["rate"]
    state = [(1 << 64) % p] + [0] * (s["t"] - 1)
    buf = [x % p for x in inputs]
    while len(buf) >= rate:
        chunk, buf = buf[:rate], buf[rate:]
        for i, v in enumerate(chunk):
            state[1 + i] = (state[1 + i] + v) % p
        state = permute_int(state)
    for i, v in enumerate(buf + [1]):
        state[1 + i] = (state[1 + i] + v) % p
    return permute_int(state)[1]


@lru_cache(maxsize=None)
def zero_hashes(depth: int) -> tuple:
    """Node value of an all-empty subtree per level 0..depth: H(0,0,0), then
    H(z, z)."""
    z = [hash_int([0, 0, 0])]
    for _ in range(depth):
        z.append(hash_int([z[-1], z[-1]]))
    return tuple(z)


# -- limb conversions (numpy / torch) ---------------------------------------

def int_limbs(x: int, n: int = N, bits: int = L) -> list:
    return [(x >> (bits * i)) & ((1 << bits) - 1) for i in range(n)]


def limbs16_to_ints(a) -> list:
    """Canonical 16-bit limbs [16, B] (numpy or torch) -> python ints."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                   dtype=np.int64)
    return [sum(int(a[i, j]) << (16 * i) for i in range(16))
            for j in range(a.shape[1])]


def ints_to_limbs16(xs) -> np.ndarray:
    out = np.zeros((16, len(xs)), dtype=np.int64)
    for j, x in enumerate(xs):
        for i in range(16):
            out[i, j] = (x >> (16 * i)) & 0xFFFF
    return out


def from16(x16: torch.Tensor) -> torch.Tensor:
    """int64 [16, B] 16-bit limbs -> int64 [N, B] 28-bit limbs (same value;
    a 28-bit limb spans at most three 16-bit ones)."""
    out = []
    for j in range(N):
        lo = L * j
        acc = torch.zeros_like(x16[0])
        for i in range(16):
            shift = 16 * i - lo
            if -16 < shift < L:
                acc |= (x16[i] << shift) if shift >= 0 else (x16[i] >> -shift)
        out.append(acc & MASK)
    return torch.stack(out)


def to16(x: torch.Tensor) -> torch.Tensor:
    """int64 [N, B] normalised 28-bit limbs of a value below 2^256 ->
    [16, B] 16-bit limbs."""
    out = []
    for i in range(16):
        lo = 16 * i
        acc = torch.zeros_like(x[0])
        for j in range(N):
            shift = L * j - lo
            if -L < shift < 16:
                acc |= (x[j] << shift) if shift >= 0 else (x[j] >> -shift)
        out.append(acc & 0xFFFF)
    return torch.stack(out)


# -- vectorised field arithmetic --------------------------------------------

def _carry(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Parallel carry rounds over the limb axis (-2).  The value is kept:
    the carry out of the top limb is zero because every value handled is
    below 2^256 < 2^280 (with nonnegative limbs the top limb alone cannot
    exceed 2^28 then)."""
    for _ in range(rounds):
        hi = x >> L
        x = x & MASK
        x[..., 1:, :] += hi[..., :-1, :]
    return x


class Hasher:
    """Poseidon over lanes, on `device`, in chunks of at most `chunk` lanes
    (memory: about 2.5 KB a lane at once)."""

    def __init__(self, device, chunk: int = 1 << 20):
        s = spec()
        self.device = torch.device(device)
        self.chunk = chunk
        p = self.p = s["p"]
        self.r = 1 << R_BITS
        dev = self.device
        col = lambda v: torch.tensor(int_limbs(v), dtype=torch.int64,
                                     device=dev)[:, None]
        self.P = col(p)
        self.pinv = (-pow(p, -1, 1 << L)) % (1 << L)
        self.r2 = col(self.r * self.r % p)
        self.one = col(1)
        mont = lambda v: v * self.r % p
        self.rc = [torch.stack([col(mont(c)) for c in row])
                   for row in s["rc"]]                    # each [3, N, 1]
        self.iv = torch.stack([col(mont((1 << 64) % p)), col(0), col(0)])
        self.one_m = col(mont(1))
        self.half, self.r_p = s["r_f"] // 2, s["r_p"]
        self.rounds = s["r_f"] + s["r_p"]
        # MDS in Montgomery form as Toeplitz blocks on 14-bit halves:
        # out[o, k] = sum_j sum_a M[o][j]_a * x[j]_{k-a}; every entry of the
        # float64 product is below 30 * 2^14 * (2^28 + 64) < 2^47.
        t = s["t"]
        lo = np.zeros((t * (2 * N), t * N))
        hi = np.zeros((t * (2 * N), t * N))
        for o in range(t):
            for j in range(t):
                m = int_limbs(mont(s["mds"][o][j]))
                for a in range(N):
                    for b in range(N):
                        lo[o * 2 * N + a + b, j * N + b] = m[a] & 0x3FFF
                        hi[o * 2 * N + a + b, j * N + b] = m[a] >> 14
        self.mds_lo = torch.tensor(lo, dtype=torch.float64, device=dev)
        self.mds_hi = torch.tensor(hi, dtype=torch.float64, device=dev)

    # Montgomery reduction of wide columns c [..., 2N, B] (each below
    # 2^61.3): REDC one limb at a time; the columns stay below 2^62.  For
    # T = value of c, the result is (T + m p) / R < T / R + p, below 2p
    # whenever T < 2^26 p^2 (inputs below 2^13 p).
    def _redc(self, c: torch.Tensor) -> torch.Tensor:
        for i in range(N):
            ci = c[..., i:i + 1, :]
            m = ((ci & MASK) * self.pinv) & MASK
            c[..., i:i + N, :].addcmul_(m, self.P)
            c[..., i + 1:i + 2, :] += c[..., i:i + 1, :] >> L
        return _carry(c[..., N:, :].clone(), 2)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product; limbs below 2^28 + 64, so each of the 2N - 1
        columns is below 10 * 2^56.01 < 2^59.4."""
        c = a.new_zeros(a.shape[:-2] + (2 * N, a.shape[-1]))
        for i in range(N):
            c[..., i:i + N, :].addcmul_(a[..., i:i + 1, :], b)
        return self._redc(c)

    def _mds(self, s: torch.Tensor) -> torch.Tensor:
        """state [3, N, B] -> MDS . state, as one REDC of each output's three
        products (columns below 2^61.01)."""
        b = s.shape[-1]
        x = s.reshape(3 * N, b).to(torch.float64)
        c = (self.mds_lo @ x).to(torch.int64) \
            + ((self.mds_hi @ x).to(torch.int64) << 14)
        return self._redc(c.view(3, 2 * N, b))

    def _add(self, a, b):
        return _carry(a + b, 1)

    def permute(self, s: torch.Tensor) -> torch.Tensor:
        """One permutation of states [3, N, B] (Montgomery, below 2p)."""
        for r in range(self.rounds):
            s = self._add(s, self.rc[r])                 # below 3p
            if self.half <= r < self.half + self.r_p:
                x = s[0:1]
                x2 = self.mul(x, x)
                x5 = self.mul(self.mul(x2, x2), x)
                s = torch.cat([x5, s[1:]])
            else:
                x2 = self.mul(s, s)
                s = self.mul(self.mul(x2, x2), s)
            s = self._mds(s)
        return s

    # -- conversions --------------------------------------------------------

    def to_mont(self, x16: torch.Tensor) -> torch.Tensor:
        """Canonical 16-bit limbs [16, B] (values below 2^256) -> Montgomery
        limbs [N, B], below 2p."""
        return self.mul(from16(x16.to(self.device, torch.int64)), self.r2)

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs [N, B] -> canonical 16-bit limbs [16, B] (fully
        reduced: one exact carry pass, then p subtracted where the value is
        at least p)."""
        y = self.mul(x, self.one)                         # below 2p
        y = y.clone()
        for j in range(N - 1):                            # exact carries
            y[j + 1] += y[j] >> L
            y[j] &= MASK
        d = y - self.P
        for j in range(N - 1):                            # borrows
            d[j + 1] += d[j] >> L                         # arithmetic shift
            d[j] &= MASK
        keep = (d[N - 1] < 0)[None]
        return to16(torch.where(keep, y, d))

    # -- hashes, Montgomery in and out ---------------------------------------

    def _sponge(self, words: list) -> torch.Tensor:
        b = words[0].shape[-1]
        s = self.iv.expand(3, N, b).clone()
        chunks = [words[:2], words[2:] + [None]] if len(words) == 3 \
            else [words[:2], [None]]
        for chunk in chunks:
            add = torch.stack([w if w is not None else
                               self.one_m.expand(N, b) for w in chunk])
            s = torch.cat([s[:1], self._add(s[1:1 + len(chunk)], add),
                           s[1 + len(chunk):]])
            s = self.permute(s)
        return s[1]

    def _chunked(self, words: list) -> torch.Tensor:
        b = words[0].shape[-1]
        if b <= self.chunk:
            return self._sponge(words)
        return torch.cat([self._sponge([w[:, i:i + self.chunk] for w in words])
                          for i in range(0, b, self.chunk)], dim=-1)

    def hash2(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._chunked([a, b])

    def hash3(self, a, b, c) -> torch.Tensor:
        return self._chunked([a, b, c])

    def const(self, v: int, b: int) -> torch.Tensor:
        """A constant field element in Montgomery form, [N, b]."""
        return torch.tensor(int_limbs(v * self.r % self.p), dtype=torch.int64,
                            device=self.device)[:, None].expand(N, b)

    def to_ints(self, x: torch.Tensor) -> list:
        return limbs16_to_ints(self.from_mont(x))
