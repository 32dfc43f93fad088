"""tools/fuzz_compare_10m_torch.py on the CPU: 2^12 pairs of its
adversarial structure against python ints in tier-1, a comparator broken
in limb 0 caught, and the full 160 rounds of 2^16 pairs (about 10.5M, the
reference's scale) under ``-m slow``."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from imt_tpu_torch.ops import field
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fuzz():
    spec = importlib.util.spec_from_file_location(
        "fuzz_compare_10m_torch",
        os.path.join(ROOT, "tools", "fuzz_compare_10m_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pairs_hold_their_structure(fuzz):
    a, b = fuzz._rand_pairs(np.random.RandomState(fuzz.SEED), 1 << 12)
    k = (1 << 12) // 8
    av, bv = fuzz._ints(a), fuzz._ints(b)
    assert (av < field.P).all() and (bv < field.P).all()
    assert (av[:k] == bv[:k]).all()
    assert (a[8:, k:2 * k] == b[8:, k:2 * k]).all()
    assert (a[:8, 2 * k:3 * k] == b[:8, 2 * k:3 * k]).all()
    assert (a[1:, 3 * k:4 * k] == b[1:, 3 * k:4 * k]).all()
    assert ((b[0, 3 * k:4 * k] - a[0, 3 * k:4 * k]) % (1 << 16) == 1).all()


def test_comparators_on_adversarial_pairs(fuzz):
    out = fuzz.fuzz(1, "cpu", batch=1 << 12, log=lambda s: None)
    assert out["pairs"] == 1 << 12


def test_a_comparator_blind_to_limb_0_is_caught(fuzz, monkeypatch):
    less_than = field.less_than
    monkeypatch.setattr(field, "less_than",
                        lambda a, b: less_than(a[1:], b[1:]))
    with pytest.raises(AssertionError, match="field.less_than"):
        fuzz.fuzz(1, "cpu", batch=1 << 12, log=lambda s: None)


@pytest.mark.slow
def test_ten_million_pairs(fuzz):
    out = fuzz.fuzz(fuzz.ROUNDS, "cpu", log=lambda s: None)
    assert out["pairs"] == fuzz.ROUNDS * fuzz.BATCH > 10_000_000
