"""bench_torch.py, the port of bench.py, on the CPU: its round classifier
against the card's bound, its config lines (bench.py's shapes, seeds,
metric strings and keys), its batches against imt_tpu's, the headline,
config 2 and the oracle at tiny sizes on the plain path, one config-4/5
shaped stream against imt_tpu's insert_batches (this file's one imt_tpu
program: depth 6, K 8), and its refusal to fall back to the CPU.  The
inserting configs at tiny sizes are in tests/test_torch_bench_inserts.py.
Tolerance: exact."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from imt_tpu_torch.ops import field, perm_work
from imt_tpu_torch.tree.sparse import SparseIndexedMerkleTree
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE_KEYS = {"config", "metric", "value", "unit", "vs_baseline", "device",
             "rounds", "spread", "peak_bytes", "correct"}


def bench_module():
    sys.path.insert(0, ROOT)
    try:
        import bench_torch
    finally:
        sys.path.remove(ROOT)
    return bench_torch


@pytest.mark.parametrize("sms,clock_mhz", [(132, 1980.0), (114, 1755.0)])
def test_round_classifier_against_the_card_bound(sms, clock_mhz):
    """The counterpart of tests/test_gates_utils.py's round classifier:
    the bound is K1's least work (60,104 + 3,056 multiply-adds) at the
    IMAD rate of `sms` SMs at `clock_mhz`; a round at it is valid, above
    it, at zero, negative, infinite or NaN it is not."""
    bench = bench_module()
    bound = perm_work.perm_bound_per_s(sms, clock_mhz)
    assert perm_work.PERM_WORK == (60104, 3056)
    assert bound == pytest.approx(sms * 64 * clock_mhz * 1e6 / 63160)
    classify = bench.classify_round
    assert classify(bound, bound) and classify(bound / 5, bound)
    for bad in (bound * 1.0001, 0.0, -1.0, float("inf"), float("nan")):
        assert not classify(bad, bound), bad


# bench.py's config_result, call by call: the bench function, its shape
# arguments (smoke, full) and its metric string
CONFIGS = {
    "2": ("bench_non_inclusion", ((8, 256, 8192, 2), (8, 256, 8192, 8)),
          {"rounds"}, "non-membership verifies/s (depth 8)", "verifies/s"),
    "3": ("bench_single_insert", ((16, 8), (16, 256)), {"chunk"},
          "sequential witness inserts/s (depth 16)", "inserts/s"),
    "3w": ("bench_batch_insert_sparse", ((16, 4096, 2), (16, 4096, 8)),
           {"witness", "rounds"}, "witness-batch inserts/s (depth 16, batch "
           "4096, full insert_leaf bundles)", "inserts/s"),
    "4": ("bench_batch_insert_sparse", ((24, 4096, 2), (24, 4096, 14)),
          {"rounds"}, "batched inserts/s (depth 24, batch 4096)",
          "inserts/s"),
    "5": ("bench_batch_insert_sparse", ((32, 4096, 2), (32, 65536, 15)),
          {"rounds"}, None, "inserts/s"),
}


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("smoke", [True, False])
def test_config_lines_keep_bench_py(cfg, smoke, monkeypatch):
    """config_result calls bench.py's function with bench.py's shapes,
    chunk and round counts, and its line carries bench.py's metric string
    and keys, vs_baseline null, the CPU's platform and no peak bytes."""
    bench = bench_module()
    name, shapes, kw, metric, unit = CONFIGS[cfg]
    calls = []

    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        return 7.5, {"rounds": [{"rate": 7.0, "dropped": True},
                                {"rate": 7.5, "dropped": False}],
                     "spread": 0.0, "correct": True}
    monkeypatch.setattr(bench, name, fake)
    line = bench.config_result(cfg, smoke, device="cpu")
    (args, kwargs), = calls
    assert args == shapes[0 if smoke else 1]
    assert set(kwargs) == kw | {"device"}
    if "rounds" in kwargs:
        assert kwargs["rounds"] == (2 if smoke else 4)
    if cfg == "3":
        assert kwargs["chunk"] == (4 if smoke else 64)
    assert kwargs.get("witness", False) == (cfg == "3w")
    want = metric or (f"batched inserts/s (depth 32, batch "
                      f"{args[1]}, ~1M total)")
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = re.sub(r'"\s*\n\s*f?"', "", f.read())   # join the literals
    assert (metric or "batched inserts/s (depth 32, batch {k}, ~1M total)") \
        in src
    assert set(line) == LINE_KEYS
    assert (line["config"], line["metric"], line["unit"]) == (cfg, want,
                                                              unit)
    assert line["vs_baseline"] is None and line["peak_bytes"] is None
    assert line["device"]["platform"] == "cpu"
    assert line["value"] == 7.5 and line["correct"] is True


def test_config_batches_equal_imt_tpu():
    """The configs' batches (field.random_limbs from bench.py's seeds)
    equal imt_tpu.ops.field.random_limbs, as numpy: no JAX program."""
    from imt_tpu.ops import field as jfield
    for seed in (0xCAFE, 0xCAFE + 15, 0xBEEF + 3, 0xF00D + 4):
        for k in (8, 4096):
            assert np.array_equal(field.random_limbs(seed, k),
                                  jfield.random_limbs(seed, k)
                                  .astype(np.int32))


def test_headline_on_the_plain_path(monkeypatch):
    """bench_perms at 8 lanes, k 1 and 2, 2 rounds of 1 timing each on the
    CPU: a positive rate, both rounds valid, the lanes equal to the plain
    version, no card bound."""
    bench = bench_module()
    monkeypatch.setattr(bench, "HEADLINE_ROUNDS", 2)
    monkeypatch.setattr(bench, "HEADLINE_REPS", 1)
    rate, extras = bench.bench_perms(8, k1=1, k2=2, device="cpu")
    assert rate > 0 and extras["correct"] is True
    assert len(extras["rounds_mps"]) == 2 and not extras["rejected_mps"]
    assert extras["sanity_bound_mps"] is None and "suspect" not in extras
    assert {"spread", "protocol"} <= set(extras)


def test_non_inclusion_at_tiny_size():
    bench = bench_module()
    rate, extras = bench.bench_non_inclusion(4, 4, 8, 2, rounds=2,
                                             device="cpu")
    assert rate > 0 and extras["correct"] is True
    assert [r["dropped"] for r in extras["rounds"]] == [True, False]
    assert rate == extras["rounds"][1]["rate"]


def test_oracle_line(capsys):
    bench = bench_module()
    assert bench.main(["--oracle", "--smoke", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == ("C++ reference-equivalent Poseidon hashes/s "
                              "(1 core)")
    assert line["value"] > 0 and line["vs_baseline"] is None
    assert line["device"]["platform"] == "cpu"


def test_stream_equals_imt_tpu_insert_batches():
    """A config-4/5 shaped stream at depth 6, K 8, 2 timed groups
    (batch_plan's warm-up group and groups of one batch, bench.py's seeds):
    the port's masks and root equal imt_tpu's insert_batches."""
    from imt_tpu.tree.sparse import SparseIndexedMerkleTree as JaxSparse
    bench = bench_module()
    depth, k, iters = 6, 8, 2
    cap, group, wb, n_g = bench.batch_plan(k, iters)
    assert (cap, group, wb, n_g) == (14, 1, 1, 2)
    host = [field.random_limbs(0xCAFE + i, k) for i in range(iters + 1)]
    groups = [np.stack(host[:wb])] + [
        np.stack(host[wb + i * group:wb + (i + 1) * group])
        for i in range(n_g)]
    port = SparseIndexedMerkleTree(depth, initial_capacity_log2=cap,
                                   device="cpu")
    ref = JaxSparse(depth, initial_capacity_log2=cap)
    for g in groups:
        assert np.array_equal(port.insert_batches(g),
                              np.asarray(ref.insert_batches(
                                  g.astype(np.uint32))))
    assert port.get_root_int() == ref.get_root_int()


def test_no_cpu_fallback_without_a_card(capsys):
    """--device cuda (the default) without a card exits non-zero and prints
    nothing on stdout: the script, and main for a config, the artifact and
    the oracle."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run")
    out = subprocess.run([sys.executable, "bench_torch.py"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
    bench = bench_module()
    for args in (["--config", "2"], ["--artifact"], ["--oracle"]):
        assert bench.main(args) != 0, args
        captured = capsys.readouterr()
        assert captured.out == "" and "no CUDA device" in captured.err, args
