"""The port stands alone: no JAX and nothing of the JAX package, and no
silent CPU path when CUDA is absent."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+repro\.|import\s+repro\s*$|"
    r"from\s+repro\.|from\s+repro\s+import)", re.M)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_sources_import_no_jax_and_no_repro():
    files = _port_sources()
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
           for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _tiny_dataset():
    from repro_torch.core import binning
    rng = np.random.default_rng(0)
    return binning.from_binned(rng.integers(0, 4, (64, 2)),
                               rng.integers(0, 2, 64),
                               attr_is_cont=[True, False], n_bins=[4, 4],
                               n_classes=2)


def test_build_without_device_needs_cuda():
    from repro_torch.core import frontier
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frontier.build(_tiny_dataset())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frontier.build(_tiny_dataset(), device="cuda")


def test_cuda_impl_refuses_the_cpu():
    from repro_torch.core import frontier
    with pytest.raises(ValueError, match="impl='cuda' needs a CUDA device"):
        frontier.build(_tiny_dataset(), impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        frontier.build(_tiny_dataset(), impl="pallas", device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor never reaches a kernel: the wrapper raises, and only
    ops's device dispatch sends it to the plain version."""
    from repro_torch.kernels import histogram, split_gain
    x = torch.zeros((4, 2), dtype=torch.int32)
    v = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        histogram.frontier_histogram(x, v, v.float(), v, n_slots=2,
                                     n_bins=3, n_classes=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        split_gain.split_gain(torch.zeros((2, 2, 3, 2)), torch.zeros(2),
                              torch.zeros(2, dtype=torch.bool),
                              torch.ones(2, dtype=torch.int32))
    assert histogram.LAUNCHES == 0 and split_gain.LAUNCHES == 0
