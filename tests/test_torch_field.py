"""imt_tpu_torch.ops.field against imt_tpu.ops.field, bit for bit (CPU).

The port keeps fully reduced values (< p); imt_tpu's Montgomery ops return
values < 2p, so its outputs are normalized before the comparison.  Inputs
are numpy-seeded and include the lanes 0, 1 and p - 1.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imt_tpu.ops import field as jfield
from imt_tpu_torch.ops import field
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

P = field.P
EDGES = [0, 1, P - 1]


def _values(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    return EDGES + xs


def _work(xs) -> torch.Tensor:
    return field.limbs_to_work(torch.as_tensor(field.ints_to_limbs(xs)))


def _jax(xs):
    return jnp.asarray(jfield.ints_to_limbs(xs))


def _same(port: torch.Tensor, ref) -> bool:
    ref = np.asarray(jfield.normalize(ref)).astype(np.int64)
    return np.array_equal(port.numpy(), ref)


def test_limbs_roundtrip_matches_imt_tpu():
    xs = _values(1, 29) + [P, P + 5, (1 << 256) - 1]   # ints reduce mod p
    port = field.ints_to_limbs(xs)
    assert port.dtype == np.int32
    assert np.array_equal(port, jfield.ints_to_limbs(xs).astype(np.int32))
    assert field.limbs_to_ints(port) == [x % P for x in xs]
    assert field.limbs_to_int(port[:, 3]) == xs[3] % P
    assert np.array_equal(field.random_limbs(7, 64),
                          jfield.random_limbs(7, 64).astype(np.int32))


def test_to_mont_from_mont_match_imt_tpu():
    xs = _values(2, 29)
    m = field.to_mont(_work(xs))
    assert _same(m, jfield.to_mont(_jax(xs)))
    back = field.from_mont(m)
    assert field.limbs_to_ints(back.numpy()) == xs


@pytest.mark.parametrize("seed", [3, 4])
def test_mont_mul_matches_imt_tpu(seed):
    xs, ys = _values(seed, 29), _values(seed + 100, 29)
    got = field.mont_mul(_work(xs), _work(ys))
    assert _same(got, jfield.mont_mul(_jax(xs), _jax(ys)))
    assert field.limbs_to_ints(got.numpy()) == [
        x * y * pow(field.R, -1, P) % P for x, y in zip(xs, ys)]


def test_add_mod_matches_imt_tpu():
    xs, ys = _values(5, 29), _values(6, 29)[::-1]
    got = field.add_mod(_work(xs), _work(ys))
    assert _same(got, jfield.add_mod(_jax(xs), _jax(ys)))


def test_mont_dot_equals_sum_of_products():
    xs = [_values(s, 13) for s in (7, 8, 9)]
    ys = [_values(s, 13) for s in (10, 11, 12)]
    a = torch.stack([_work(x) for x in xs], dim=-1)
    b = torch.stack([_work(y) for y in ys], dim=-1)
    parts = [field.mont_mul(_work(x), _work(y)) for x, y in zip(xs, ys)]
    want = field.add_mod(field.add_mod(parts[0], parts[1]), parts[2])
    assert torch.equal(field.mont_dot(a, b), want)


def test_node_packing_roundtrip():
    xs = _values(13, 29)
    nodes = torch.stack([torch.as_tensor(field.int_to_node(x)) for x in xs],
                        dim=1)
    assert nodes.dtype == torch.int32
    assert [field.node_to_int(nodes[:, j].numpy())
            for j in range(len(xs))] == xs
    work = field.nodes_to_work(nodes)
    assert torch.equal(field.work_to_nodes(work), nodes)
    # a node is the Montgomery form: unpacked, it equals to_mont's limbs
    assert torch.equal(work, field.to_mont(_work(xs)))
    assert field.eq(work, work).all() and not field.is_zero(work[:, 3:]).any()


def test_sub_mod_matches_imt_tpu():
    # inputs < 2p: canonical values and values in [p, 2p)
    xs = _values(14, 29) + [P + 3, 2 * P - 1, 0]
    ys = _values(15, 29)[::-1] + [P - 1, 2 * P - 1, 2 * P - 1]
    a = torch.as_tensor(np.array([[(x >> (16 * i)) & 0xFFFF for x in xs]
                                  for i in range(16)], dtype=np.int32))
    b = torch.as_tensor(np.array([[(y >> (16 * i)) & 0xFFFF for y in ys]
                                  for i in range(16)], dtype=np.int32))
    got = field.sub_mod(a, b)
    want = jfield.sub_mod(jnp.asarray(a.numpy().astype(np.uint32)),
                          jnp.asarray(b.numpy().astype(np.uint32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64),
                          np.asarray(want).astype(np.int64))
    vals = field.limbs_to_ints(got.numpy())
    assert all(v < 2 * P for v in vals)
    assert [v % P for v in vals] == [(x - y) % P for x, y in zip(xs, ys)]


def _comparator_lanes():
    """The equal-limb classes of tests/test_field.py: equal values, equal
    high halves, equal low halves, off-by-one in the lowest limb, and the
    reference's masked-typo class (equal low limbs, differing high)."""
    pow128 = 1 << 128
    cases = [
        (5, 7), (7, 5), (5, 5),
        (3 * pow128 + 10, 3 * pow128 + 11), (3 * pow128 + 11, 3 * pow128 + 10),
        (2 * pow128 + 9, 5 * pow128 + 1), (5 * pow128 + 1, 2 * pow128 + 9),
        (7 * pow128 + 42, 9 * pow128 + 42), (9 * pow128 + 42, 7 * pow128 + 42),
        (P - 1, P - 2), (0, P - 1),
    ]
    rng = np.random.default_rng(16)
    for _ in range(64):
        x = int.from_bytes(rng.bytes(32), "little") % P
        y = int.from_bytes(rng.bytes(32), "little") % P
        hi, lo = y >> 128 << 128, y & (pow128 - 1)
        cases += [(x, y), (x, x), (x, (x >> 128 << 128) | lo),
                  (x, hi | (x & (pow128 - 1))), (x, x ^ 1)]
    return cases


def test_less_than_matches_imt_tpu_on_equal_limb_lanes():
    cases = _comparator_lanes()
    a = field.ints_to_limbs([c[0] for c in cases])
    b = field.ints_to_limbs([c[1] for c in cases])
    got = field.less_than(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jfield.less_than(jnp.asarray(a.astype(np.uint32)),
                                       jnp.asarray(b.astype(np.uint32))))
    assert got.dtype == bool
    assert np.array_equal(got, want)
    assert got.tolist() == [x < y for x, y in cases]
    # a column broadcasts against the batch, as in the low-leaf search
    col = torch.as_tensor(a[:, 3:4])
    assert field.less_than(torch.as_tensor(a), col).tolist() == [
        c[0] < cases[3][0] for c in cases]


def test_select_matches_imt_tpu():
    xs, ys = _values(17, 5), _values(18, 5)
    a, b = field.ints_to_limbs(xs), field.ints_to_limbs(ys)
    cond = np.array([True, False, True, False, False, True, True, False])
    got = field.select(cond, torch.as_tensor(a), torch.as_tensor(b))
    want = jfield.select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(got.numpy(), np.asarray(want))
