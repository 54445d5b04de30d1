"""The benchmark's CPU tests: run them with

    python -m pytest portbench/tests -q

They drive the harness on the CPU at small sizes (`smallcells.py`); the
test marked `cuda` runs a cell on the card and skips without one."""

import pytest
import torch

torch.set_num_threads(4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"
