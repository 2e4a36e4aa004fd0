"""The benchmark's tests: on the CPU at small sizes, with the port's plain
torch path standing in for the card; those marked ``cuda`` need one.

    python3 -m pytest -q bench/tests                 # here
    python3 -m pytest -q -m cuda bench/tests         # on a CUDA machine
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
