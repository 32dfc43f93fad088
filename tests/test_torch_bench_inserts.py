"""bench_torch.py's inserting configs at tiny sizes on the CPU (the plain
path): config 3's sequential witness inserts, configs 4/5's chained
batches and config 3w's witness batches, and --insert's line, each
bench.py's protocol at depth <= 6, K <= 8, 2 iterations and 2 rounds
(config 3's 4 rounds are bench.py's own).  Each gives a positive rate,
every round's rate with round 0 marked dropped, and correct true: masks
against set semantics, the root against a rebuild, the witness batch
through insert_leaf.  No imt_tpu program: tests/test_torch_bench.py holds
the stream against imt_tpu."""

import json

import pytest
import torch

from _torch_inference import inference_mode  # noqa: F401
from test_torch_bench import bench_module

torch.set_num_threads(1)


def check(rate: float, extras: dict, rounds: int) -> None:
    assert rate > 0 and extras["correct"] is True
    assert [r["dropped"] for r in extras["rounds"]] == \
        [True] + [False] * (rounds - 1)
    assert extras["spread"] >= 0


def test_sequential_witness_inserts():
    rate, extras = bench_module().bench_single_insert(3, 2, chunk=1,
                                                      device="cpu")
    check(rate, extras, 4)


@pytest.mark.parametrize("witness", [False, True])
def test_batched_inserts(witness):
    rate, extras = bench_module().bench_batch_insert_sparse(
        4, 4, 2, witness=witness, rounds=2, device="cpu")
    check(rate, extras, 2)


def test_insert_line(capsys):
    """--insert --smoke (depth 6, K 8, 2 iterations): one line with
    bench.py's metric, the CPU's platform and correct true."""
    assert bench_module().main(["--insert", "--smoke", "--device",
                                "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "batched leaf-inserts/s (depth 6)"
    assert line["value"] > 0 and line["correct"] is True
    assert line["vs_baseline"] is None and line["peak_bytes"] is None
    assert line["device"]["platform"] == "cpu"
