"""imt_tpu_torch on the card: the CUDA kernel against the plain torch path,
and the dense insert on CUDA against the same insert on the CPU.

Marked `cuda`; each test skips where torch sees no CUDA device.  This file
imports nothing of JAX, so on the GPU host (which has none) it runs without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: exact (the kernel and the plain path compute the same bits).
"""

import numpy as np
import pytest
import torch

from imt_tpu_torch import FIELD_MODULUS, IndexedMerkleTree
from imt_tpu_torch.ops import field, poseidon, poseidon_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _limbs(seed: int, width: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, (16, width)).astype(np.int32)
    x[:, 0] = field.int_to_limbs(FIELD_MODULUS - 1)
    x[:, -1] = 0xFFFF                         # 2^256 - 1: reduced mod p
    return torch.as_tensor(x, device=dev)


@pytest.mark.parametrize("width", [1, 129, 1000])
def test_kernel_equals_plain(cuda, width):
    a, b, c = (_limbs(s, width, cuda) for s in (1, 2, 3))
    na, nb = poseidon.limbs_to_nodes(a), poseidon.limbs_to_nodes(b)
    pairs = [
        (poseidon_cuda.limbs_to_nodes(a), na),
        (poseidon_cuda.nodes_to_limbs(na), poseidon.nodes_to_limbs(na)),
        (poseidon_cuda.hash2_nodes(na, nb), poseidon.hash2_nodes(na, nb)),
        (poseidon_cuda.hash3_leaf(a, b, c), poseidon.hash3_leaf(a, b, c)),
        (poseidon_cuda.hash2(a, b), poseidon.hash2(a, b)),
        (poseidon_cuda.permute_n(torch.stack([na, nb, na]), 3),
         poseidon.permute_n(torch.stack([na, nb, na]), 3)),
    ]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert torch.equal(got, want), i


def test_wrappers_refuse_bad_tensors(cuda):
    n = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        poseidon_cuda.hash2_nodes(n.long(), n.long())
    with pytest.raises(ValueError, match="shape"):
        poseidon_cuda.hash2_nodes(n[:4], n[:4])
    with pytest.raises(ValueError, match="contiguous"):
        poseidon_cuda.nodes_to_limbs(torch.zeros((8, 8), dtype=torch.int32,
                                                 device=cuda)[:, ::2])
    with pytest.raises(ValueError, match="width"):
        poseidon_cuda.hash2_nodes(n, n[:, :3].contiguous())


def test_insert_batch_on_cuda_equals_cpu(cuda):
    batches = [[30, 10, 20, 5, 50, 35, 0, 10], [7, 7, 0, 31, 32, 33, 1, 2],
               field.random_limbs(5, 64)]
    gpu, cpu = IndexedMerkleTree(8, device=cuda), IndexedMerkleTree(8)
    poseidon_cuda.reset_launch_counts()
    for b in batches:
        assert gpu.insert_batch(b).tolist() == cpu.insert_batch(b).tolist()
    assert poseidon_cuda.LAUNCHES["hash3_leaf"] == len(batches)
    assert poseidon_cuda.LAUNCHES["hash2_nodes"] > 0
    for name in ("vals", "next_vals", "next_idxs"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for d, (g, c) in enumerate(zip(gpu.levels, cpu.levels)):
        assert torch.equal(g.cpu(), c), d
    assert gpu.get_root_int() == cpu.get_root_int()
