"""The benchmark's own tests: CPU tests, and card tests marked ``cuda``
that decide inside a fixture whether there is a card.

    python -m pytest gpubench/tests -q -p xdist -n 6 --dist loadfile
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Several test workers share the host's cores: a few threads each."""
    import torch

    torch.set_num_threads(2)
