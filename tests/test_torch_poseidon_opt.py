"""The port's sparse Poseidon schedule (``ops/poseidon_opt.py``) and its
Montgomery tables (``ops/poseidon_spec.py``) against ``imt_tpu`` and the
standard permutation (CPU, python ints; exact)."""

import numpy as np

from imt_tpu.ops import poseidon_opt as jopt
from imt_tpu.ops import poseidon_ref as jref
from imt_tpu_torch.ops import field, poseidon_opt, poseidon_ref
from imt_tpu_torch.ops.poseidon_spec import (KERNEL_TABLES, default_params,
                                             default_spec, kernel_words,
                                             to_words)
from _torch_inference import inference_mode  # noqa: F401

FIELDS = ("t", "r_f", "r_p", "pre_rounds", "mds", "mds_last_pre",
          "partial_c0", "sparse", "post_rounds")


def _opt():
    return poseidon_opt.optimize_params(default_params())


def test_optimize_params_equals_imt_tpu():
    want = jopt.optimize_params(jref.generate_params())
    got = _opt()
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name


def test_permute_opt_equals_standard_permutation():
    params, opt = default_params(), _opt()
    rng = np.random.default_rng(11)
    states = [[0, 0, 0], [field.P - 1] * 3, [0, field.P - 1, 1]] + [
        [int.from_bytes(rng.bytes(32), "little") % field.P for _ in range(3)]
        for _ in range(3)]
    for st in states:
        assert poseidon_opt.permute_opt(st, opt) == \
            poseidon_ref.permute(list(st), params), st


def _decode(table: np.ndarray):
    """uint32[..., 16] Montgomery limbs -> nested lists of python ints."""
    if table.ndim == 1:
        return field.limbs_to_int(table) * pow(field.R, -1, field.P) % field.P
    return [_decode(row) for row in table]


def test_montgomery_tables_decode_to_the_schedule():
    s, opt = default_spec(), _opt()
    as_lists = lambda rows: [list(r) if isinstance(r, tuple) else r
                             for r in rows]
    for table, ints in (("pre_rounds_mont", opt.pre_rounds),
                        ("mds_last_pre_mont", opt.mds_last_pre),
                        ("partial_c0_mont", opt.partial_c0),
                        ("sparse_mont", opt.sparse),
                        ("post_rounds_mont", opt.post_rounds)):
        assert _decode(getattr(s, table)) == as_lists(ints), table


def test_kernel_words_follow_the_struct_order():
    s, words = default_spec(), kernel_words()
    at = 0
    for name in KERNEL_TABLES:
        t = to_words(s.iv_mont[0] if name == "iv_mont" else getattr(s, name))
        assert np.array_equal(words[at:at + t.size], t.ravel()), name
        at += t.size
    # Consts: 65x3 + 9 + 2 + 12 + 9 + 57 + 57x5 + 12 elements of 8 words
    assert at == words.size == 581 * 8
