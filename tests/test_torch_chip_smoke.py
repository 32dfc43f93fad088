"""chip_smoke.py without a card (CPU): its depth-6 oracle replay on CPU
tensors, and its refusal to run without CUDA or outside a checkout."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from imt_tpu_torch.tree import indexed, reference_oracle

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _smoke_module():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def _run(cwd, script):
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, cwd=cwd, timeout=120)


def test_small_replay_matches_oracle_on_cpu():
    _smoke_module().replay_small(indexed, reference_oracle,
                                 torch.device("cpu"))


def test_kernel_record_names_the_replaced_code():
    smoke = _smoke_module()
    names = list(smoke.KERNELS)
    launches = {n: int(smoke.KERNELS[n][1]) for n in names}
    rec = smoke.kernel_record(dict.fromkeys(names, 0), launches,
                              dict.fromkeys(names, (1.0, 2.0)))
    assert [e["name"] for e in rec["kernels"]] == [
        "hash3_leaf", "hash2_nodes", "nodes_to_limbs"]
    assert [e["name"] for e in rec["off_path_kernels"]] == [
        "permute_n", "limbs_to_nodes"]
    for e in rec["kernels"] + rec["off_path_kernels"]:
        assert e["route"] == "cuda" and os.path.isfile(
            os.path.join(ROOT, e["source"]))
        path, line = e["replaces"].split(":")
        with open(os.path.join(ROOT, path)) as f:
            assert f.readlines()[int(line) - 1].startswith("def "), e
    assert all(e["launches"] == 1 for e in rec["kernels"])


def test_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = _run(ROOT, SMOKE)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert out.stdout == ""
