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


def test_importing_every_module_sets_no_env_and_makes_no_process_group():
    """The planning tooling (launch.mesh, dryrun, hillclimb) sets no
    environment variable at import, as the JAX dry run's XLA_FLAGS line
    does, and initialises no process group."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.launch.hillclimb", "repro_torch.sharding.act",
            "repro_torch.utils.scan"} <= set(modules)
    code = (
        "import importlib, os\n"
        "before = dict(os.environ)\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert dict(os.environ) == before, set(os.environ) ^ set(before)\n"
        "import torch.distributed as dist\n"
        "assert not (dist.is_available() and dist.is_initialized())\n")
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


def test_build_binds_each_signature_once_and_counts_launches(monkeypatch):
    """``_build.launch`` on a fake library: the signatures are set once a
    process whatever the launches, the stream comes last, a non-zero return
    raises with the library's error text and is not counted, and every
    successful launch is counted under its label."""
    import contextlib
    import ctypes
    import types
    from repro_torch.kernels import _build
    sets, calls, rets = [], [], {"fake_a_launch": 0, "fake_b_launch": 0}

    class Fn:
        def __init__(self, name):
            object.__setattr__(self, "name", name)

        def __setattr__(self, attr, value):
            sets.append((self.name, attr))
            object.__setattr__(self, attr, value)

        def __call__(self, *args):
            calls.append((self.name, args))
            if self.name == "fake_error":
                return f"fake error {args[0]}".encode()
            return rets[self.name]

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, Fn(name))

    loads = []
    monkeypatch.setattr(_build, "library",
                        lambda name: loads.append(name) or Lib())
    monkeypatch.setattr(_build, "_BOUND", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=1234))
    counts = types.ModuleType("fake_counts")
    counts.LAUNCHES, counts.PLANS = 0, {"a": 0, "b": 0}
    monkeypatch.setitem(sys.modules, "fake_counts", counts)
    lib = _build.Library("fake", "fake_error", counts="fake_counts",
                         by="PLANS", opt_in=True,
                         entries={"fake_a_launch": "2p q i f",
                                  "fake_b_launch": "i"})
    dev = torch.device("cuda", 0)
    for i in range(3):
        _build.launch(lib, "fake_a_launch", dev, 1, 2, 3, i, 0.5, label="a")
    for _ in range(2):
        _build.launch(lib, "fake_b_launch", dev, 9, label="b")
    assert loads == ["fake"]
    assert sorted(sets) == sorted(
        (fn, attr) for fn in ("fake_a_launch", "fake_b_launch", "fake_error")
        for attr in ("argtypes", "restype"))
    fns = _build._BOUND["fake"]
    assert fns["fake_a_launch"].argtypes == [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    assert fns["fake_b_launch"].argtypes == [ctypes.c_int, ctypes.c_void_p]
    assert fns["fake_error"].restype is ctypes.c_char_p
    assert calls[2] == ("fake_a_launch", (1, 2, 3, 2, 0.5, 1234))
    assert calls[3] == ("fake_b_launch", (9, 1234))
    assert (counts.LAUNCHES, counts.PLANS) == (5, {"a": 3, "b": 2})

    rets["fake_a_launch"] = 7
    with pytest.raises(RuntimeError,
                       match="fake_a_launch: launch failed: fake error 7"):
        _build.launch(lib, "fake_a_launch", dev, 1, 2, 3, 4, 0.5, label="a")
    assert (counts.LAUNCHES, counts.PLANS) == (5, {"a": 3, "b": 2})
    assert len(sets) == 6 and loads == ["fake"]


def _root_superstep():
    """The tiny dataset's root state and its splitPre / splitAtt planes on
    the CPU: ``(prob, state, pre, att, (x, y, w, cont, nb))``."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    ds = _tiny_dataset()
    prob = frontier.FrontierProblem.from_dataset(
        ds, GrowConfig(max_nodes=64, frontier_slots=4))
    data = (torch.as_tensor(ds.x, dtype=torch.int32),
            torch.as_tensor(ds.y, dtype=torch.int32),
            torch.as_tensor(ds.w, dtype=torch.float32),
            torch.as_tensor(ds.attr_is_cont), torch.as_tensor(ds.n_bins))
    state = frontier.init_state(prob, data[1], data[2])
    pre = frontier.split_pre(state, prob=prob)
    att = frontier.split_att(state, pre, *data, prob=prob, impl="torch")
    return prob, state, pre, att, data


def _post_args(state, pre, att, data, **swap):
    """The CUDA splitPost wrapper's arguments for one superstep, with the
    tensors named in ``swap`` (a state field, a key of ``pre`` or ``att``,
    or ``x``) replaced."""
    pre = {k: swap.get(k, v) for k, v in pre.items()}
    att = {k: swap.get(k, v) for k, v in att.items()}
    fields = ("status", "active", "case_node", "n_nodes", "overflow")
    return ((state.tree, *(swap.get(f, getattr(state, f)) for f in fields),
             pre, att, swap.get("x", data[0]), data[3], data[4]),
            dict(cost_model="nsq", n_total_cases=64.0, alpha=1000.0))


def test_split_post_wrapper_refuses_cpu_tensors():
    """The CUDA splitPost takes CUDA tensors only, from the wrapper and
    from frontier.split_post(impl="cuda") alike, and launches nothing."""
    from repro_torch.core import frontier
    from repro_torch.kernels import split_post
    prob, state, pre, att, data = _root_superstep()
    args, kw = _post_args(state, pre, att, data)
    with pytest.raises(ValueError, match="CUDA tensors"):
        split_post.split_post(*args, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        frontier.split_post(state, pre, att, data[0], data[3], data[4],
                            prob=prob, impl="cuda")
    with pytest.raises(ValueError, match="unknown cost model"):
        split_post.split_post(*args, **dict(kw, cost_model="linear"))
    with pytest.raises(ValueError, match="unknown impl"):
        frontier.split_post(state, pre, att, data[0], data[3], data[4],
                            prob=prob, impl="pallas")
    assert split_post.LAUNCHES == 0


@pytest.mark.parametrize("name,dtype", [
    ("ids", torch.int32), ("valid", torch.uint8), ("total_w", torch.float64),
    ("best_attr", torch.int64), ("split_bin", torch.int64),
    ("status", torch.int64), ("case_node", torch.int64),
    ("x", torch.float32)])
def test_split_post_wrapper_refuses_a_wrong_dtype(name, dtype):
    from repro_torch.kernels import split_post
    _, state, pre, att, data = _root_superstep()
    t = {**pre, **att, "x": data[0], "status": state.status,
         "case_node": state.case_node}[name]
    args, kw = _post_args(state, pre, att, data, **{name: t.to(dtype)})
    with pytest.raises(TypeError, match=f"{name} must be"):
        split_post.split_post(*args, **kw)
    assert split_post.LAUNCHES == 0


@pytest.mark.parametrize("name", ["x", "active", "active_k", "hist"])
def test_split_post_wrapper_refuses_a_non_contiguous_input(name):
    """A strided x, active plane or histogram is refused, never read with
    the wrong layout."""
    from repro_torch.kernels import split_post
    _, state, pre, att, data = _root_superstep()
    t = {"x": data[0], "active": state.active, "active_k": att["active_k"],
         "hist": att["hist"]}[name]
    # the same values, every other element of a tensor twice as wide
    wide = torch.stack([t, t], -1).flatten(-2)[..., ::2]
    assert torch.equal(wide, t) and not wide.is_contiguous()
    args, kw = _post_args(state, pre, att, data, **{name: wide})
    with pytest.raises(ValueError, match="contiguous"):
        split_post.split_post(*args, **kw)
    assert split_post.LAUNCHES == 0


@pytest.mark.parametrize("fault,error,match", [
    ("no lo", ValueError, "needs lo"),
    ("ids int32", TypeError, "ahead ids must be"),
    ("total_w short", ValueError, "ahead total_w has shape"),
    ("lo int64", TypeError, "lo must be"),
    ("no live", ValueError, "needs lo, min_objs, max_depth and live"),
    ("live int64", TypeError, "live must be"),
    ("live short", ValueError, "live has shape"),
    ("live without ahead", ValueError, "live list is the next frontier's")])
def test_split_post_wrapper_refuses_a_malformed_next_frontier(fault, error,
                                                              match):
    """The next frontier's planes, ``lo``, the stop tests' parameters and
    the live list are checked as splitPre's are: a missing one, a wrong
    dtype or shape is refused before any launch; a live list without the
    next frontier too."""
    from repro_torch.kernels import split_post
    _, state, pre, att, data = _root_superstep()
    ahead = {name: torch.empty_like(pre[name]) for name in (
        "ids", "valid", "ids_safe", "total_w", "depth_k", "pre_leaf")}
    nxt = dict(ahead=ahead, lo=torch.zeros((), dtype=torch.int32),
               min_objs=2.0, max_depth=64,
               live=torch.empty_like(pre["slot"]))
    if fault == "no lo":
        nxt["lo"] = None
    elif fault == "no live":
        nxt["live"] = None
    elif fault == "live int64":
        nxt["live"] = nxt["live"].long()
    elif fault == "live short":
        nxt["live"] = nxt["live"][:-1]
    elif fault == "live without ahead":
        nxt = dict(live=nxt["live"])
    elif fault == "ids int32":
        ahead["ids"] = ahead["ids"].int()
    elif fault == "total_w short":
        ahead["total_w"] = ahead["total_w"][:-1]
    else:
        nxt["lo"] = nxt["lo"].long()
    args, kw = _post_args(state, pre, att, data)
    with pytest.raises(error, match=match):
        split_post.split_post(*args, **kw, **nxt)
    assert split_post.LAUNCHES == 0


def test_superstep_torch_launches_no_kernel():
    """superstep(impl="torch") and a CPU build run the plain splitPost:
    no kernel of the three is launched."""
    from repro_torch.core import frontier
    from repro_torch.kernels import histogram, split_gain, split_post
    prob, state, _, _, data = _root_superstep()
    before = (histogram.LAUNCHES, split_gain.LAUNCHES, split_post.LAUNCHES)
    state, stats = frontier.superstep(state, *data, prob=prob, impl="torch")
    assert int(state.n_nodes) > 1 and int(stats["n_processed"]) == 1
    frontier.build(_tiny_dataset(), device="cpu")
    assert (histogram.LAUNCHES, split_gain.LAUNCHES,
            split_post.LAUNCHES) == before


def test_tree_and_lm_constructors_without_device_need_cuda():
    """Every public constructor defaults to the card: Tree.empty, the LM's
    init and params_from_jax, the serving Replica and launch.serve."""
    from repro_torch.configs import base
    from repro_torch.core.tree import Tree
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = base.reduced(base.get_config("yi_6b"), dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Tree.empty(4, 2)
    assert Tree.empty(4, 2, device="cpu").node_attr.device.type == "cpu"
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve("yi_6b", n_requests=1)


def test_chip_smoke_stops_every_process_it_started():
    """A spawn pool leaves multiprocessing's resource tracker running until
    its parent exits; the smoke's exit path stops it and any other child
    still running, so that nothing outlives the run."""
    code = (
        "import concurrent.futures, multiprocessing, os, subprocess, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "ctx = multiprocessing.get_context('spawn')\n"
        "with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as p:\n"
        "    assert list(p.map(abs, [-1, -2])) == [1, 2]\n"
        "sleeper = subprocess.Popen(\n"
        "    [sys.executable, '-c', 'import time; time.sleep(120)'])\n"
        "before = chip_smoke._children()\n"
        "assert sleeper.pid in before and len(before) == 2, before\n"
        "stopped = chip_smoke.stop_children(grace_s=5.0)\n"
        "assert 'resource tracker' in stopped[0], stopped\n"
        "assert any(s.startswith(f'{sleeper.pid}:') for s in stopped), stopped\n"
        "assert chip_smoke._children() == {}, chip_smoke._children()\n"
        "assert not any(os.path.exists(f'/proc/{pid}') for pid in before)\n"
        "assert chip_smoke.stop_children() == []\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
