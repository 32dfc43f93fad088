"""imt_tpu_torch's soak and kill-resume drill (CPU; pytest -m soak).

The port of tests/test_soak.py's differential stream and kill-resume drill
(tools/soak_indexed_torch.py): a checkpointing worker, written to a
temporary directory, is SIGKILLed after its third checkpoint of a sparse
tree of depth 8 growing from 2^2 slots (8 batches of K = 4); the snapshot
is loaded, the remaining batches replayed, and the root and count must
equal an uninterrupted worker's.  Then one round of the differential
stream at depth 4 must print SOAK PASSED.
"""

import importlib.util
import os
import subprocess
import sys

import pytest
import torch
from _torch_inference import inference_mode  # noqa: F401

pytestmark = pytest.mark.soak

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "soak_indexed_torch.py")


def _tool():
    spec = importlib.util.spec_from_file_location("soak_indexed_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kill_resume_drill(tmp_path):
    out = _tool().kill_resume(str(tmp_path), "cpu", depth=8, capacity_log2=2,
                              k=4, n_batches=8)
    assert out["count"] == 32 and 3 <= out["batches_done"] < 8
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.npz")]


def test_soak_differential_stream_one_round():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, TOOL, "--device", "cpu", "--rounds", "1",
         "--depth", "4", "--seed", "7"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SOAK PASSED: 1 rounds on cpu" in out.stdout, out.stdout[-1000:]
