"""Each driver at a tiny size on the CPU's plain path (the harness's look
for a card skipped), the control and the planted faults, the needed-hash
count, and no JAX in a run's process."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from imtbench import control, harness, run
from imtbench.reference import poseidon, tree as ref, work

SEED = 2 ** 33 + 17
TINY = {
    "d20.prove-2k": {
        "config": {"depth": 5, "capacity_log2": 5},
        "traffic": {"block_size": 8, "warm_blocks": 1, "sampled_blocks": 1,
                    "trace_units": 1}},
    "d20.sync-2k": {
        "config": {"depth": 5, "capacity_log2": 5},
        "traffic": {"block_size": 4, "warm_groups": 1, "sampled_groups": 1,
                    "trace_units": 1, "trace_group": 1}},
    # the sync driver's sparse tree and groups of several blocks
    "d20.sync-2k.sparse": {
        "config": {"depth": 8, "capacity_log2": 5, "sparse": True},
        "traffic": {"block_size": 4, "blocks_per_group": 2,
                    "warm_groups": 1, "sampled_groups": 1, "trace_units": 1,
                    "trace_group": 1}},
}
FAULTS = [(c, k) for c in sorted(TINY) for k in control.KINDS]
CELLS = sorted(TINY)


def base(cell):
    """The BENCHMARK.json cell a tiny variant runs."""
    return cell.split(".sparse")[0]


def tiny_run(cell, trace=False, seed=SEED, seconds=0.01):
    with torch.inference_mode():
        return run.run_cell(base(cell), seed, seconds, trace,
                            device="cpu", overrides=TINY[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_line(cell):
    line = tiny_run(cell)
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.metrics_for(harness.manifest(),
                                                   base(cell), False)}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    json.dumps(line)


@pytest.mark.parametrize("cell", ["d20.prove-2k", "d20.sync-2k"])
def test_traced_line_on_the_cpu(cell):
    line = tiny_run(cell, trace=True)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    # no device operation on the CPU: every reader finds nothing
    assert line["metrics"] == {}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_control_and_faults_are_not_correct(cell, kind):
    with control.patched(kind):
        line = tiny_run(cell)
    assert line["correct"] is False, (kind, line["checks"])
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _brute_needed(pre, group, active, full):
    """Slots whose leaf changes, and their distinct ancestors, by comparing
    the leaf states before and after."""
    before = np.stack(ref.leaf_state(pre))
    after = np.stack(ref.leaf_state(np.concatenate([pre, group], axis=1)))
    n = after.shape[2]
    padded = np.zeros_like(after)
    padded[:, :, :before.shape[2]] = before
    changed = [s for s in range(n)
               if not np.array_equal(padded[:, :, s], after[:, :, s])]
    nodes = {(d, s >> d) for s in changed for d in range(1, active + 1)}
    return len(changed), len(nodes) + full - active


@pytest.mark.parametrize("active,full", [(6, 6), (6, 9)])
def test_needed_hashes_against_brute_force(active, full):
    vals = poseidon.ints_to_limbs16(
        [int(x) for x in np.random.default_rng(3).integers(1, 1 << 60, 40)])
    vals[:, 25] = vals[:, 3]          # a duplicate: rejected, no change
    vals[:, 30] = 0                   # a zero: rejected
    for cut in (0, 1, 12, 20):
        pre, group = vals[:, :cut], vals[:, cut:]
        need = work.needed_hashes(pre, group, active, full)
        h3, h2 = _brute_needed(pre, group, active, full)
        assert (need["hash3"], need["hash2"]) == (h3, h2), cut


def test_no_jax_in_a_runs_process():
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "from imtbench import run\n"
        "from imtbench.tests.test_imtbench_cells import TINY\n"
        "with torch.inference_mode():\n"
        "    line = run.run_cell('d20.prove-2k', 5, 0.01, False, 'cpu', "
        "TINY['d20.prove-2k'])\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([line['correct'], top]))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT, env=env,
                         check=True).stdout.strip().splitlines()[-1]
    correct, top = json.loads(out)
    assert correct is True
    assert not set(top) & {"jax", "jaxlib", "flax", "imt_tpu"}
    assert "imt_tpu_torch" in top


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted({base(c) for c in CELLS}))
def test_cell_on_the_card(cell):
    """One short run of the real command on a card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "imtbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=900, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "imtbench/run.py", "--workload", CELLS[0], "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli(harness.ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_cli_without_the_program_prints_no_result(tmp_path):
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "imtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, env)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "imt_tpu_torch" in out.stderr
