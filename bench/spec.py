"""What ``BENCHMARK.json`` names, found by name under ``bench/``.

  * a configuration ``<c>``: ``bench/configs/<c>.json``;
  * a traffic mix ``<t>``: ``bench/traffic/<t>.json``;
  * a metric ``<m>``: ``bench/metrics/<m>.py``, whose ``read(run)`` returns
    its value or None;
  * a configuration's generator ``<g>``: ``bench/generators/<g>.py``, whose
    ``generate(config, seed, device)`` makes the inputs.

A cell ``<c>.<t>`` joins a configuration and a traffic mix.  Adding one of
these is adding its file and its entry; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    end_to_end: bool
    workloads: tuple[str, ...] | None     # None: every cell


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


class Spec:
    def __init__(self, benchmark: dict):
        self.benchmark = benchmark
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"],
                                      int(w["chips"]))
                      for w in benchmark["workloads"]}
        self.metrics = [
            Metric(m["name"], m["unit"], end_to_end,
                   tuple(m["workloads"]) if "workloads" in m else None)
            for key, end_to_end in (("end_to_end", True),
                                    ("per_layer", False))
            for m in benchmark[key]]

    @staticmethod
    def load(root: Path = ROOT) -> "Spec":
        return Spec(_json(root / "BENCHMARK.json"))

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def metrics_of(self, cell: str, *, trace: bool) -> list[Metric]:
        """The end-to-end metrics of a run with ``trace`` off, the per-layer
        ones with it on, that ``cell`` reports."""
        return [m for m in self.metrics if m.end_to_end != trace
                and (m.workloads is None or cell in m.workloads)]


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def reader(name: str) -> ModuleType:
    return _load_module(BENCH / "metrics" / f"{name}.py",
                        "bench_metric_" + name.replace(".", "_"))


def generator(name: str) -> ModuleType:
    return _load_module(BENCH / "generators" / f"{name}.py",
                        f"bench_generator_{name}")
