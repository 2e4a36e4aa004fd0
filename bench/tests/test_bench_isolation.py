"""Nothing the benchmark runs loads JAX or the JAX package ``repro``, and
the yardstick (the reference, the generators, the work counts, the trace
reduction) loads nothing of the port ``repro_torch``.  Module names are
compared by their whole top-level name: ``repro_torch`` begins with
``repro``."""

import subprocess
import sys

from bench import spec

ROOT = spec.ROOT
JAX = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ["bench.reference", "bench.work", "bench.roofline",
             "bench.binning", "bench.trace", "bench.generators.quest"]


def _loaded(modules: list[str]) -> set[str]:
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def _bench_modules() -> list[str]:
    mods = []
    for p in sorted((ROOT / "bench").rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or rel.name == "run":
            continue
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def test_benchmark_loads_no_jax():
    mods = _bench_modules()
    assert "bench.harness" in mods and "bench.metrics.build_mfu" in mods
    # and what the harness loads of the port when it runs a build
    loaded = _loaded(mods + ["repro_torch.core.frontier",
                             "repro_torch.obs.trace",
                             "repro_torch.obs.metrics"])
    assert "repro_torch" in loaded
    assert not loaded & JAX, loaded & JAX


def test_yardstick_loads_nothing_of_the_port():
    loaded = _loaded(YARDSTICK)
    assert "torch" in loaded
    assert not loaded & (JAX | {"repro_torch"})


def test_run_refuses_a_loaded_jax_package():
    from bench import run
    assert run.forbidden_loaded(
        ["jax.numpy", "repro_torch.core", "repro.core.c45", "flax", "numpy",
         "jaxlib", "reprox"]) == ["flax", "jax", "jaxlib", "repro"]
    assert run.forbidden_loaded(["repro_torch", "torch"]) == []
