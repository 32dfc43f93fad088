"""imt_tpu_torch's package boundary: no JAX, no silent fallbacks (CPU)."""

import os
import re
import subprocess
import sys

import pytest
import torch

from imt_tpu_torch.ops import (_build, hashing, poseidon_cuda, vpu_roofline,
                               vpu_roofline_cuda)
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "imt_tpu_torch")
MODULES = [
    "imt_tpu_torch", "imt_tpu_torch.ops.field", "imt_tpu_torch.ops.grain",
    "imt_tpu_torch.ops.poseidon_ref", "imt_tpu_torch.ops.poseidon_spec",
    "imt_tpu_torch.ops.poseidon", "imt_tpu_torch.ops.poseidon_cuda",
    "imt_tpu_torch.ops.hashing", "imt_tpu_torch.ops._build",
    "imt_tpu_torch.ops.gates", "imt_tpu_torch.ops.vpu_roofline",
    "imt_tpu_torch.ops.vpu_roofline_cuda", "imt_tpu_torch.tree.merkle",
    "imt_tpu_torch.tree.indexed", "imt_tpu_torch.tree.batch_witness",
    "imt_tpu_torch.tree.sparse", "imt_tpu_torch.tree.reference_oracle",
    "imt_tpu_torch.utils.observability", "imt_tpu_torch.utils.checkpoint",
    "imt_tpu_torch.utils.health", "imt_tpu_torch.utils.config",
    "imt_tpu_torch.parallel", "imt_tpu_torch.parallel.collectives",
    "imt_tpu_torch.parallel.local_plan", "imt_tpu_torch.parallel.sharded",
    "imt_tpu_torch.parallel.collective_audit", "imt_tpu_torch.native",
    "imt_tpu_torch.native.oracle",
]
TOOLS = ["tools/soak_indexed_torch.py", "tools/k1_launch_torch.py",
         "tools/fuzz_compare_10m_torch.py"]


def test_import_leaves_jax_and_imt_tpu_out():
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        f"for p in {TOOLS!r}:\n"
        "    s = importlib.util.spec_from_file_location('tool', p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "import imt_tpu_torch\n"
        "t = imt_tpu_torch.IndexedMerkleTree(2, device='cpu')\n"
        "s = imt_tpu_torch.SparseIndexedMerkleTree(2, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'imt_tpu'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_parallel_leaves_jax_and_imt_tpu_out():
    """imt_tpu_torch.parallel and the rank programs of its tests, which
    the ranks load, import neither jax nor imt_tpu."""
    ranks = os.path.join(ROOT, "tests", "_torch_parallel_ranks.py")
    code = (
        "import importlib, importlib.util, sys\n"
        "for m in ('sharded', 'local_plan', 'collectives', "
        "'collective_audit'):\n"
        "    importlib.import_module('imt_tpu_torch.parallel.' + m)\n"
        f"s = importlib.util.spec_from_file_location('r', {ranks!r})\n"
        "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'imt_tpu'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_never_import_jax_or_imt_tpu():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|imt_tpu)(\.|\s|$)",
                     re.M)
    paths = [os.path.join(ROOT, p) for p in TOOLS + ["chip_smoke.py"]]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def _cpu_args():
    n = torch.zeros((8, 4), dtype=torch.int32)
    limbs = torch.zeros((16, 4), dtype=torch.int32)
    st = torch.zeros((3, 8, 4), dtype=torch.int32)
    return {
        "permute_n": (st,), "hash2_nodes": (n, n),
        "hash3_leaf": (limbs, limbs, limbs), "limbs_to_nodes": (limbs,),
        "nodes_to_limbs": (n,), "hash2": (limbs, limbs),
        "hash3": (limbs, limbs, limbs), "hash_fixed": ([limbs] * 4,),
    }


@pytest.mark.parametrize("name", sorted(_cpu_args()))
def test_kernel_wrappers_raise_on_cpu_tensors(name):
    before = dict(poseidon_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(poseidon_cuda, name)(*_cpu_args()[name])
    assert poseidon_cuda.LAUNCHES == before


@pytest.mark.parametrize("name", list(vpu_roofline.BODIES))
def test_roofline_wrapper_raises_on_cpu_tensors(name):
    x = vpu_roofline.seeded_input(name, 2, 4, device="cpu")
    before = dict(vpu_roofline_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vpu_roofline_cuda.roofline(name, x, 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        vpu_roofline.measure(name, 1980.0, 2, 4, 1, 2, device="cpu")
    assert vpu_roofline_cuda.LAUNCHES == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DEFAULT_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "_libs", {})
    for name in _build.LIBRARIES:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_dispatch_follows_the_tensor_device():
    x = torch.zeros((16, 2), dtype=torch.int32)
    assert hashing._impl(x).__name__.endswith(".poseidon")
    meta = torch.empty((16, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no Poseidon implementation"):
        hashing.hash3_leaf(meta, meta, meta)
