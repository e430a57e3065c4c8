"""The benchmark's own tests.  A test marked `cuda` needs an NVIDIA card
and decides inside the `card` fixture, never at import, whether it
skips."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
