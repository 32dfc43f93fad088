"""BN254 scalar-field (Fr) arithmetic: host conversions and the plain torch path.

Counterpart of ``imt_tpu.ops.field``.  Three forms of a field element appear
in the port:

* **Canonical limbs** ``int32[16, B]``: 16 limbs of 16 bits, little-endian,
  limb-major (the limb axis leads, lanes follow).  This is the public
  boundary (tree state, roots, proofs), the same layout as ``imt_tpu`` with
  int32 in place of uint32, because torch's uint32 lacks most operations.
* **Nodes** ``int32[8, B]``: the value in Montgomery form (R = 2^256), fully
  reduced (< p), as 8 limbs of 32 bits, little-endian, limb-major; each limb
  is the uint32 bit pattern held in an int32.  Merkle levels are stored in
  this form, and the CUDA kernel reads and writes it.
* **Working limbs** ``int64[16, ...]``: 16-bit limbs in int64, which the
  plain arithmetic below uses.  Every 16x16-bit product and every lazy CIOS
  accumulator fits int64 exactly.

``mont_mul`` / ``add_mod`` / ``to_mont`` / ``from_mont`` take fully reduced
working limbs (< p, except ``to_mont``, which takes any 256-bit value) and
return fully reduced working limbs, so the plain path and the kernel produce
the same bits.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .grain import P

LIMBS = 16
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
WORDS = 8                      # 32-bit limbs of a node
R = 1 << (LIMBS * LIMB_BITS)   # Montgomery radix 2^256
R2_MOD_P = (R * R) % P
# -p^{-1} mod 2^16 for the CIOS reduction step
N0_INV = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def _int_to_limbs_list(x: int, n: int = LIMBS, bits: int = LIMB_BITS):
    return [(x >> (bits * i)) & ((1 << bits) - 1) for i in range(n)]


# ---------------------------------------------------------------------------
# Host conversions (python ints <-> numpy limb arrays)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """One python int -> int32[16] canonical limbs (reduced mod p)."""
    return np.array(_int_to_limbs_list(x % P), dtype=np.int32)


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of python ints -> int32[16, N] (limb-major batch)."""
    out = np.zeros((LIMBS, len(xs)), dtype=np.int32)
    for j, x in enumerate(xs):
        out[:, j] = int_to_limbs(int(x))
    return out


def limbs_to_int(a) -> int:
    """[16] limbs (numpy, torch or list) -> python int."""
    a = np.asarray(a).astype(np.int64)
    return sum(int(a[i]) << (LIMB_BITS * i) for i in range(LIMBS))


def limbs_to_ints(a) -> list[int]:
    """[16, N] limbs -> list of python ints."""
    a = np.asarray(a).astype(np.int64)
    return [sum(int(a[i, j]) << (LIMB_BITS * i) for i in range(LIMBS))
            for j in range(a.shape[1])]


def random_limbs(seed: int, k: int, bits: int = 253) -> np.ndarray:
    """int32[16, K] of uniform random nonzero values < 2^bits, packed with
    numpy (same draw as ``imt_tpu.ops.field.random_limbs``)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << LIMB_BITS, (LIMBS, k), dtype=np.uint32)
    top, rem = divmod(bits, LIMB_BITS)
    out[top + 1:] = 0
    if rem:
        out[top] &= (1 << rem) - 1
    else:
        out[top] = 0
    allz = ~out.any(axis=0)
    out[0, allz] = 1
    return out.astype(np.int32)


def int_to_node(x: int) -> np.ndarray:
    """python int -> int32[8] node (Montgomery form, fully reduced)."""
    words = _int_to_limbs_list((x * R) % P, WORDS, 32)
    return np.array(words, dtype=np.uint32).view(np.int32)


def node_to_int(node) -> int:
    """int32[8] node -> python int (standard form)."""
    w = np.asarray(node).astype(np.int64) & 0xFFFFFFFF
    m = sum(int(w[i]) << (32 * i) for i in range(WORDS))
    return (m * pow(R, -1, P)) % P


# ---------------------------------------------------------------------------
# Limb packing between the int32 boundary forms and working limbs
# ---------------------------------------------------------------------------

def limbs_to_work(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical limbs int32[16, ...] -> working limbs int64[16, ...]
    (each limb masked to 16 bits, as the kernel reads it)."""
    return limbs.to(torch.int64) & MASK


def work_to_limbs(x: torch.Tensor) -> torch.Tensor:
    """Working limbs int64[16, ...] (< 2^16 each) -> int32[16, ...]."""
    return x.to(torch.int32)


def nodes_to_work(nodes: torch.Tensor) -> torch.Tensor:
    """Nodes int32[8, ...] -> working limbs int64[16, ...] (same value)."""
    w = nodes.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> LIMB_BITS], dim=1).reshape(
        (LIMBS,) + tuple(nodes.shape[1:]))


def work_to_nodes(x: torch.Tensor) -> torch.Tensor:
    """Working limbs int64[16, ...] (< 2^16 each) -> nodes int32[8, ...]."""
    pairs = x.reshape((WORDS, 2) + tuple(x.shape[1:]))
    w = pairs[:, 0] | (pairs[:, 1] << LIMB_BITS)            # < 2^32
    return (w - ((w >> 31) << 32)).to(torch.int32)           # uint32 bits


# ---------------------------------------------------------------------------
# Plain arithmetic on working limbs int64[16, ...]
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _limbs_of(value: int, device: str) -> torch.Tensor:
    return torch.tensor(_int_to_limbs_list(value), dtype=torch.int64,
                        device=device)


def _col(value: int, like: torch.Tensor) -> torch.Tensor:
    """The 16 limbs of `value` as a column broadcasting against `like`."""
    return _limbs_of(value, str(like.device)).view(
        (LIMBS,) + (1,) * (like.dim() - 1))


def _carry(x: torch.Tensor) -> torch.Tensor:
    """Propagate lazy (possibly negative) carries: limbs 0..L-2 end in
    [0, 2^16); the top limb keeps the rest, signed.  Exact, since >> on
    int64 is an arithmetic (floor) shift."""
    x = x.clone()
    while True:
        c = x[:-1] >> LIMB_BITS
        if not bool(c.any()):
            return x
        x[:-1] &= MASK
        x[1:] += c


def _reduce(x: torch.Tensor, bound: int = 2) -> torch.Tensor:
    """Non-negative value < bound*p (bound <= 4) in lazy limbs [L > 16, ...]
    -> fully reduced [16, ...]."""
    x = _carry(x)[:LIMBS]          # < 4p < 2^256: the limbs above 15 are 0
    for mult in ((2, 1) if bound > 2 else (1,)):
        d = _carry(torch.cat([x - _col(mult * P, x), torch.zeros_like(x[:1])]))
        x = torch.where((d[LIMBS] >= 0).unsqueeze(0), d[:LIMBS], x)
    return x


@lru_cache(maxsize=None)
def _columns(device: str) -> torch.Tensor:
    """int64[256]: the column i + j of limb product a_i * b_j."""
    return torch.tensor([i + j for i in range(LIMBS) for j in range(LIMBS)],
                        device=device)


def _cios(a: torch.Tensor, b: torch.Tensor, dot: bool) -> torch.Tensor:
    """Montgomery product, radix 2^16, lazy int64 accumulators: the product
    a*b (or, with `dot`, the sum of the products over the last axis) times
    R^{-1} mod p, fully reduced.  The 256 limb products are summed into
    their columns at once (each column < 16 * 3 * 2^32), then the CIOS
    reduction runs limb by limb."""
    a, b = torch.broadcast_tensors(a, b)
    shape = tuple(a.shape[1:-1] if dot else a.shape[1:])
    prod = a.unsqueeze(1) * b.unsqueeze(0)          # [16, 16, ...]
    if dot:
        prod = prod.sum(-1)
    t = torch.zeros((2 * LIMBS + 1,) + shape, dtype=torch.int64,
                    device=a.device)
    t.index_add_(0, _columns(str(a.device)),
                 prod.reshape((LIMBS * LIMBS,) + shape))
    p = _col(P, t)
    for i in range(LIMBS):
        ti = t[i]
        m = (ti * N0_INV) & MASK            # t[i] < 2^40: no overflow
        t[i:i + LIMBS].addcmul_(m, p)
        # t[i] is now divisible by 2^16: carry it into the next limb
        t[i + 1] += ti >> LIMB_BITS
    # (sum of products + m*p) / R, in limbs 16..32: < (terms + 1) * p
    return _reduce(t[LIMBS:], (a.shape[-1] if dot else 1) + 1)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod p.  a, b: working limbs [16, ...]
    (broadcastable batch shapes), a < 2^256 and b < p.  Output fully
    reduced (< p)."""
    return _cios(a, b, dot=False)


def mont_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_j a_j*b_j*R^{-1} mod p over the last axis (at most 3 terms, each
    factor < p), in one Montgomery reduction.  Equal, bit for bit, to the
    sum of the separate mont_mul products mod p."""
    if max(a.shape[-1], b.shape[-1]) > 3:
        raise ValueError("mont_dot takes at most 3 terms")
    return _cios(a, b, dot=True)


def add_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on fully reduced working limbs."""
    s = a + b
    return _reduce(torch.cat([s, torch.zeros_like(s[:1])]))


@lru_cache(maxsize=None)
def _p_words(device: str) -> torch.Tensor:
    return torch.tensor(_int_to_limbs_list(P, WORDS, 32), dtype=torch.int64,
                        device=device)


@lru_cache(maxsize=None)
def _word_index(device: str, dims: int) -> torch.Tensor:
    """0..7 down dim 0 of a tensor of `dims` dims (shared: read only)."""
    return torch.arange(WORDS, device=device).view((WORDS,) + (1,) * (dims - 1))


def _carries_in(gen: torch.Tensor, prop: torch.Tensor) -> tuple:
    """The carries of a chain over the 8 words of dim 0, c_i = gen_i |
    (prop_i & c_{i-1}), with no carry into word 0 and no word that both
    generates and propagates: the carry out of word i is the `gen` of the
    last word j <= i that does not propagate (none: no carry), found with
    one running max, so the op count is fixed whatever the batch.  Returns
    (the carry into each word, the carry out of word 7)."""
    idx = _word_index(str(gen.device), gen.dim())
    last = torch.where(prop, -1, idx).cummax(dim=0).values
    out = torch.where(last >= 0, gen.gather(0, last.clamp(min=0)), 0)
    pad = (0, 0) * (gen.dim() - 1) + (1, 0)
    return torch.nn.functional.pad(out[:-1], pad), out[-1:]


def add_mod_nodes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on nodes int32[8, ...] of values < p, fully reduced:
    the word sums and their carries, then the sum minus p and its borrows,
    each chain resolved at once over the 8 words (``_carries_in``), so the
    op count is small and fixed; like ``add_mod`` it is exact, and unlike
    it it never reads a value back to the host, so on the card it queues
    without a sync."""
    m = 0xFFFFFFFF
    s = (a.to(torch.int64) & m) + (b.to(torch.int64) & m)
    low = s & m
    t = (low + _carries_in(s >> 32, low == m)[0]) & m
    r = t - _p_words(str(a.device)).view((WORDS,) + (1,) * (a.dim() - 1))
    borrow, borrow_out = _carries_in((r < 0).to(torch.int64), r == 0)
    # a + b < 2p < 2^256 leaves no carry out of word 7: the sum is >= p
    # exactly when subtracting p borrows nothing out of word 7
    w = torch.where(borrow_out == 0, (r - borrow) & m, t)
    return (w - ((w >> 31) << 32)).to(torch.int32)       # uint32 bits


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Standard form (any 256-bit value) -> Montgomery form, reduced mod p."""
    return mont_mul(a, _col(R2_MOD_P, a))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical standard form (< p)."""
    return mont_mul(a, _col(1, a))


def _col_n(value: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """The n limbs of `value` as an int64 column broadcasting against
    `like`."""
    col = torch.tensor(_int_to_limbs_list(value, n), dtype=torch.int64,
                       device=like.device)
    return col.view((n,) + (1,) * (like.dim() - 1))


def sub_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, folded below 2p (``imt_tpu.ops.field.sub_mod``,
    :313): a - b + 4p, which lies in (2p, 6p), then two conditional
    subtractions of 2p.  a, b: canonical limbs int32[16, ...] of values
    < 2p; returns canonical limbs int32[16, ...] < 2p, the same bits as
    ``imt_tpu`` (not fully reduced: 2p > 2^254 > p)."""
    x = limbs_to_work(a) - limbs_to_work(b)
    t = _carry(torch.cat([x + _col(4 * P, x), torch.zeros_like(x[:1])]))
    two_p = _col_n(2 * P, LIMBS + 1, t)
    for _ in range(2):
        d = _carry(torch.cat([t - two_p, torch.zeros_like(t[:1])]))
        t = torch.where((d[LIMBS + 1] >= 0).unsqueeze(0), d[:LIMBS + 1], t)
    return work_to_limbs(t[:LIMBS])


def less_than(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b over limb arrays [L, ...] (limb 0 least significant; the
    batch shapes broadcast) -> bool[batch]; equal values -> False
    (``imt_tpu.ops.field.less_than``, :371).  Compared limb by limb from the
    most significant down, in the inputs' dtype: a [16, N] comparison
    allocates bool[N] masks and no wider temporaries."""
    lt = a[-1] < b[-1]
    eq_so_far = a[-1] == b[-1]
    for i in range(a.shape[0] - 2, -1, -1):
        lt |= eq_so_far & (a[i] < b[i])
        eq_so_far &= a[i] == b[i]
    return lt


def select(cond, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b per lane (``imt_tpu.ops.field.select``, :377); cond:
    bool[batch] (tensor or numpy)."""
    cond = torch.as_tensor(cond, device=a.device)
    return torch.where(cond.unsqueeze(0), a, b)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit-exact equality of limb arrays -> bool[batch]."""
    return (a == b).all(dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)
