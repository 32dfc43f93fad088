"""hash_fixed of any arity (the halo2-base hash_fix_len_array contract) on
the CPU: ``imt_tpu_torch.ops.hashing.hash_fixed`` against
``imt_tpu.ops.poseidon_ref.hash_fixed`` (python ints) at arities 1-7 and
against ``imt_tpu.ops.hashing.hash_fixed`` (its default engine on the CPU,
the file's one compiled program) at arity 5; the card's sponge
(``poseidon_cuda.hash_fixed``) with its kernels swapped for their plain
versions, which counts its K1 launches; the node addition between them.
Tolerance: exact."""

import random
from functools import lru_cache

import numpy as np
import pytest
import torch

from imt_tpu.ops import hashing as jax_hashing
from imt_tpu.ops import poseidon_ref as jax_ref
from imt_tpu_torch.ops import field, hashing, poseidon, poseidon_cuda
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

P = field.P
B = 4


def _columns(arity: int, seed: int) -> list:
    """`arity` columns of B values: 0 and p - 1 in the first lanes (p - 1
    in every lane of column 2, an absorbed word), the rest random."""
    rng = random.Random(seed)
    cols = [[0, P - 1] + [rng.randrange(P) for _ in range(B - 2)]
            for _ in range(arity)]
    for j in range(1, arity, 2):
        cols[j][:2] = [P - 1, 0]
    if arity > 2:
        cols[2] = [P - 1] * B
    return cols


@lru_cache(maxsize=None)
def _params():
    return jax_ref.generate_params()


def _tensors(cols) -> list:
    return [torch.as_tensor(field.ints_to_limbs(c)) for c in cols]


@pytest.fixture(scope="module")
def arity5():
    """imt_tpu's hash_fixed of arity 5 on its default engine on the CPU."""
    cols = _columns(5, 5)
    import jax.numpy as jnp
    out = jax_hashing.hash_fixed(
        [jnp.asarray(field.ints_to_limbs(c).astype(np.uint32))
         for c in cols])
    return cols, np.asarray(out)


@pytest.mark.parametrize("arity", range(1, 8))
def test_equals_the_python_sponge(arity):
    cols = _columns(arity, arity)
    got = field.limbs_to_ints(hashing.hash_fixed(_tensors(cols)).numpy())
    assert got == [jax_ref.hash_fixed(list(v), _params())
                   for v in zip(*cols)]


def test_arity5_equals_imt_tpus_engine(arity5):
    cols, want = arity5
    got = hashing.hash_fixed(_tensors(cols)).numpy()
    assert np.array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("arity", [2, 3])
def test_arity_2_and_3_are_hash2_and_hash3(arity):
    t = _tensors(_columns(arity, 20 + arity))
    direct = {2: poseidon.hash2, 3: poseidon.hash3}[arity](*t)
    assert torch.equal(poseidon.hash_fixed(t), direct)
    assert torch.equal(hashing.hash_fixed(t), direct)


def test_refuses_empty_and_mixed_inputs():
    x = torch.zeros((16, 2), dtype=torch.int32)
    for fn in (hashing.hash_fixed, poseidon.hash_fixed,
               poseidon_cuda.hash_fixed):
        with pytest.raises(ValueError, match="at least one"):
            fn([])
    meta = torch.empty((16, 2), dtype=torch.int32, device="meta")
    for cols in ([x, meta], [x, x, x, meta], [x, x[:, :1]],
                 [x, x, x, x[:, :1]]):
        with pytest.raises(ValueError, match="differ"):
            hashing.hash_fixed(cols)
    with pytest.raises(ValueError, match="no Poseidon implementation"):
        hashing.hash_fixed([meta] * 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        poseidon_cuda.hash_fixed([x] * 4)


@pytest.mark.parametrize("arity", [1, 4, 5])
def test_card_sponge_with_plain_kernels(arity, monkeypatch):
    """poseidon_cuda.hash_fixed on CPU tensors, each kernel replaced by its
    plain version and counted: the plain sponge's bits, arity // 2 + 1
    launches of permute_n(st, 1) on a contiguous state, and no hash2 or
    hash3."""
    calls = {}

    def count(name, fn):
        def wrapped(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return wrapped

    def permute_n(st, n_perms):
        assert st.shape == (3, 8, B) and st.is_contiguous() and n_perms == 1
        return poseidon.permute_n(st, n_perms)

    monkeypatch.setattr(poseidon_cuda, "_check",
                        lambda name, xs, lead: xs[0].shape[-1])
    for name, fn in (("permute_n", permute_n),
                     ("limbs_to_nodes", poseidon.limbs_to_nodes),
                     ("nodes_to_limbs", poseidon.nodes_to_limbs),
                     ("hash2_nodes", poseidon.hash2_nodes),
                     ("hash3_leaf", poseidon.hash3_leaf)):
        monkeypatch.setattr(poseidon_cuda, name, count(name, fn))
    t = _tensors(_columns(arity, 30 + arity))
    got = poseidon_cuda.hash_fixed(t)
    assert calls == {"permute_n": arity // 2 + 1, "limbs_to_nodes": arity,
                     "nodes_to_limbs": 1}
    assert torch.equal(got, poseidon.hash_fixed(t))


def test_node_addition_stays_below_p():
    """field.add_mod_nodes, the absorption between K1 launches, against
    python ints at the edges (p - 1 + p - 1, sums at and around p) and
    bit for bit against add_mod's."""
    rng = random.Random(9)
    xs = [0, 1, P - 1, P - 1, P - 2, 2 ** 253] + [rng.randrange(P)
                                                  for _ in range(10)]
    ys = [0, P - 1, 1, P - 1, 1, 2 ** 253] + [rng.randrange(P)
                                              for _ in range(10)]
    node = lambda vs: torch.as_tensor(
        np.stack([field.int_to_node(v) for v in vs], axis=1))
    a, b = node(xs), node(ys)
    got = field.add_mod_nodes(a, b)
    assert [field.node_to_int(got[:, i].numpy()) for i in range(len(xs))] \
        == [(x + y) % P for x, y in zip(xs, ys)]
    want = field.work_to_nodes(field.add_mod(field.nodes_to_work(a),
                                             field.nodes_to_work(b)))
    assert torch.equal(got, want)
