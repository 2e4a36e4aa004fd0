"""``bench/run.py`` fails rather than falling back: without a card, and in
a directory that holds only the benchmark, it prints no result."""

import json
import shutil
import subprocess
import sys

import pytest

from bench import harness, spec

ROOT = spec.ROOT
ARGS = ["--workload", "syd10m9a.shallow", "--seed", "1", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_no_result():
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_workload_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "no_such.cell", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_small_cell_on_the_card(cuda_device):
    """The harness end to end on the card, traced, at a small size."""
    s = spec.Spec.load()
    cell = s.cell("syd10m9a.deep")
    cfg = spec.config(cell.config)
    cfg["n_cases"] = 200_000
    out = harness.run_cell(cell, seed=2**31 + 5, seconds=1.0, trace_on=True,
                           device=cuda_device, config=cfg)
    assert out["correct"]
    m = harness.metrics(s, out["run"], trace_on=True)
    assert set(m) == {x.name for x in s.metrics_of(cell.name, trace=True)}
    assert 0 < m["histogram_roofline"]["value"] <= 100
    json.dumps(m)
