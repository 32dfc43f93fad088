"""A module-scope autouse fixture that runs a port test module under
``torch.inference_mode``.  The plain hashes of the CPU tests are thousands
of tiny tensor ops each; without autograd's bookkeeping every op
dispatches faster, and the bits are the same.  A test module takes it by
importing it: ``from _torch_inference import inference_mode  # noqa``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def inference_mode():
    with torch.inference_mode():
        yield
