import sys
from pathlib import Path

import pytest
import torch

# several workers share the CPU: a few threads each
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA device; decided when the test
    runs, never while the module is imported."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
