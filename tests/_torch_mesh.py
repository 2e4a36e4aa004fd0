"""Partitioned runs of the port for the tests, each in a subprocess of its
own, so that no process group outlives its run inside a pytest worker.

:func:`run` starts ``python tests/_torch_mesh.py <mode> <json args>`` and
returns the JSON its last ``RESULT`` line holds.  A mode runs on the fake
process group (``repro_torch.launch.mesh.fake_mesh``: meta tensors, one
process) or on a real ``gloo`` group of four CPU processes
(``torch.multiprocessing.spawn``, ranks on ``tcp://localhost:<port>``).
Nothing here imports JAX: the tests hold the results against it.

The cells are ``tests/test_dryrun_small.py``'s: reduced configs and its
shrunk shapes (:func:`use_small`), the dry-run tests' ``small`` fixture.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("yi_6b", "train_4k"), ("phi35_moe", "train_4k"),
         ("gemma2_9b", "decode_32k"), ("rwkv6_3b", "long_500k"),
         ("recurrentgemma_2b", "prefill_32k")]
AXES = ("data", "model")


def run(mode: str, *args, timeout: float = 300) -> dict:
    env = {"PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(ROOT)),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), mode, json.dumps(args)],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr[-6000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    assert lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(lines[-1][len("RESULT"):])


def use_small(dtype: str | None = None) -> None:
    """The shrunk shapes and reduced configs of test_dryrun_small (with
    ``dtype`` in place of each config's), for this process."""
    from repro_torch.configs import base

    shapes = {
        "train_4k": base.ShapeSpec("train_4k", 128, 8, "train"),
        "prefill_32k": base.ShapeSpec("prefill_32k", 256, 4, "prefill"),
        "decode_32k": base.ShapeSpec("decode_32k", 256, 8, "decode"),
        "long_500k": base.ShapeSpec("long_500k", 512, 1, "decode"),
    }
    real = base.get_config
    over = {"dtype": dtype} if dtype else {}
    reduced = {a: base.reduced(real(a), **over) for a in base.ARCH_IDS}
    base.SHAPES = shapes
    base.get_config = lambda a: reduced[a] if a in reduced else real(a)


def _emit(obj) -> None:
    print("RESULT" + json.dumps(obj), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, *args, world: int = 4) -> None:
    import torch.multiprocessing as mp
    mp.spawn(fn, args=(world, _free_port(), *args), nprocs=world, join=True)


def _gloo(rank: int, world: int, port: int, shape=(2, 2)):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return make_mesh(shape, AXES, device_type="cpu")


# --------------------------------------------------------------------------
# modes
# --------------------------------------------------------------------------


def mode_cell(arch: str, shape: str, mesh: str) -> None:
    """dryrun.run_cell of a small cell (the fake group lives inside it)."""
    from repro_torch.launch import dryrun
    use_small()
    r = dryrun.run_cell(arch, shape, mesh=mesh, verbose=False)
    one = dryrun.run_cell(arch, shape, verbose=False)
    _emit({"mesh": r, "one": one})


def mode_main(out: str) -> None:
    from repro_torch.launch import dryrun, report
    use_small()
    dryrun.main(["--arch", "gemma2_9b", "--shape", "decode_32k", "--out",
                 out, "--mesh", "16x16"])
    _emit({"render": report.render(out), "summary": report.summarize(out)})


def mode_hillclimb(arch: str, shape: str, knobs: dict) -> None:
    from repro_torch.launch import hillclimb
    use_small()
    _emit({"plain": hillclimb.measure(arch, shape),
           "knob": hillclimb.measure(arch, shape, **knobs)})


def mode_counter() -> None:
    """What one device of a fake (2, 4) mesh counts of three steps: an
    elementwise op on a replicated tensor, a matmul of a row-sharded by a
    column-sharded operand, and that product gathered; each counted twice
    (DTensor caches its sharding propagation after the first run), and
    the first two on plain meta tensors on one device."""
    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.sharding import partitioning as part

    def gather(x, w):
        z = x @ w
        return z.redistribute(z.device_mesh, [Replicate(), Replicate()])

    steps = {"replicated": (lambda a: a * 2.0, ["a"]),
             "matmul": (lambda x, w: x @ w, ["x", "w"]),
             "gather": (gather, ["x", "w"])}
    shapes = {"a": ((64, 32), ()), "x": ((8, 64), ("data", None)),
              "w": ((64, 32), (None, "model"))}
    meta = {k: torch.empty(s, device="meta") for k, (s, _) in shapes.items()}
    out = {}
    with fake_mesh((2, 4), AXES) as mesh:
        laid = {k: part.distribute_tensor(meta[k], spec, mesh)
                for k, (_, spec) in shapes.items()}
        for name, (fn, args) in steps.items():
            out[name] = [_costs(roofline.count_costs(
                fn, *[laid[a] for a in args])[1]) for _ in range(2)]
    for name in ("replicated", "matmul"):
        fn, args = steps[name]
        out[name + "_one"] = _costs(roofline.count_costs(
            fn, *[meta[a] for a in args])[1])
    _emit(out)


def mode_layout() -> None:
    """Each leaf of a small train cell laid out over a fake (2, 4) mesh:
    its local shape against ``shard_shape``; a real tensor distributed and
    gathered back on a one-rank group; the group gone after the mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import specs
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.sharding import partitioning as part

    use_small()
    shapes = {}
    with fake_mesh((2, 4), AXES) as mesh:
        cell = specs.make_cell("yi_6b", "train_4k", mesh)
        state, batch = part.distribute(cell.args, cell.in_shardings, mesh)
        named = dict(state.params.named_parameters())
        for name, p in named.items():
            spec = cell.in_shardings[0].params[name]
            shapes[f"param {name}"] = dict(
                local=list(p.to_local().shape),
                shard_shape=list(part.shard_shape(p.shape, spec, mesh)))
        for name, t in batch.items():
            spec = cell.in_shardings[1][name]
            shapes[f"batch {name}"] = dict(
                local=list(t.to_local().shape),
                shard_shape=list(part.shard_shape(t.shape, spec, mesh)))
    gone = not dist.is_initialized()
    with fake_mesh((1, 1), AXES) as one:
        x = torch.arange(24.0).reshape(4, 6)
        d = part.distribute_tensor(x, ("data", "model"), one)
        equal = bool(torch.equal(part.gather(d), x)
                     and d.to_local().data_ptr() == x.data_ptr())
    _emit({"shapes": shapes, "gathered_equal": equal,
           "group_gone": gone and not dist.is_initialized()})


# ---- LM train step on a (2, 2) gloo mesh --------------------------------


def _load(cell, npz) -> None:
    """The params and batch of ``npz`` (by the port's names) into the
    cell's args."""
    import torch
    state, batch = cell.args
    with torch.no_grad():
        for name, p in state.params.named_parameters():
            p.copy_(torch.from_numpy(npz[f"p:{name}"]).to(p.dtype))
        for k in batch:
            batch[k] = torch.from_numpy(npz[f"b:{k}"])


def train_cell(arch: str, mesh, device: str, npz=None, batch=None):
    """The small train_4k cell of ``arch`` (f32) at its 8 rows or at
    ``batch`` rows (4 microbatches from 64), with ``npz``'s weights and
    batch when given."""
    from repro_torch.launch import specs
    cell = specs.make_cell(arch, "train_4k", mesh, device=device,
                           batch=batch)
    if npz is not None:
        _load(cell, npz)
    return cell


def grads(cell, mesh=None):
    """(loss, {name: gradient}) of the cell's train step at its params,
    over its microbatches (``compute_grads``, the step without the
    update): on a ``DeviceMesh`` laid out by its in_shardings, the
    gradients gathered."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding import act
    from repro_torch.sharding import partitioning as part

    state, batch = cell.args
    ctx = contextlib.nullcontext()
    if mesh is not None:
        state, batch = part.distribute(cell.args, cell.in_shardings, mesh)
        ctx = implicit_replication()
    with ctx, act.from_mesh(mesh or cell_mesh()):
        loss, _, g = cell.step_fn.compute_grads(state.params, batch)
    return (part.gather(loss).item(),
            {n: part.gather(x).numpy() for n, x in g.items()})


def cell_mesh():
    from repro_torch.launch.mesh import abstract_mesh
    return abstract_mesh((2, 2), AXES)


def _train_rank(rank, world, port, arch, npz_path, out_dir, batch):
    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch import specs
    from repro_torch.sharding import partitioning as part

    use_small("float32")
    mesh = _gloo(rank, world, port)
    try:
        npz = np.load(npz_path)
        cell = train_cell(arch, mesh, "cpu", npz, batch)
        loss, g = grads(cell, mesh)
        cell = train_cell(arch, mesh, "cpu", npz, batch)
        (state, metrics), costs = specs.run_cell_step(cell, mesh, count=True)
        moments = {"m": part.gather(state.m), "v": part.gather(state.v)}
        metrics = {k: float(part.gather(v)) for k, v in metrics.items()}
    finally:
        dist.destroy_process_group()
    if rank:
        return
    one_loss, one_g = grads(train_cell(arch, cell_mesh(), "cpu", npz, batch))
    (one_state, one_metrics) = specs.run_cell_step(
        train_cell(arch, cell_mesh(), "cpu", npz, batch), cell_mesh())
    np.savez(os.path.join(out_dir, "gloo.npz"),
             **{f"g:{k}": v for k, v in g.items()},
             **{f"og:{k}": v for k, v in one_g.items()},
             **{f"m:{k}": v.numpy() for k, v in moments["m"].items()},
             **{f"v:{k}": v.numpy() for k, v in moments["v"].items()},
             **{f"om:{k}": v.numpy() for k, v in one_state.m.items()},
             **{f"ov:{k}": v.numpy() for k, v in one_state.v.items()})
    meta = _meta_count(arch, batch)
    with open(os.path.join(out_dir, "gloo.json"), "w") as f:
        json.dump(dict(loss=loss, metrics=metrics, costs=_costs(costs),
                       meta=_costs(meta), one_loss=one_loss,
                       one_metrics={k: float(v)
                                    for k, v in one_metrics.items()}), f)


def _costs(c) -> dict:
    return dict(flops=c.device_flops, bytes=c.device_bytes,
                coll=c.coll_bytes, by_op=c.coll_by_op,
                n=c.n_collectives)


def _meta_count(arch: str, batch=None):
    """The same step counted on meta tensors over a fake (2, 2) mesh of
    CPU devices (the gloo group's collectives) in this one process."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import fake_mesh
    with fake_mesh((2, 2), AXES, device_type="cpu") as mesh:
        cell = train_cell(arch, mesh, "meta", batch=batch)
        return specs.run_cell_step(cell, mesh, count=True)[1]


def mode_gloo_train(arch: str, npz_path: str, out_dir: str,
                    batch: int | None = None) -> None:
    _spawn(_train_rank, arch, npz_path, out_dir, batch)
    with open(os.path.join(out_dir, "gloo.json")) as f:
        _emit(json.load(f))


# ---- serving: a prefill and a decode step on a (2, 2) gloo mesh ----------


def serve_out(arch: str, mesh=None) -> dict:
    """The small prefill_32k cell of ``arch`` (f32, seed-0 weights: 4
    prompts of 256 tokens), then one decode step of every row at the next
    position against the prefill's cache; the logits of both and the
    cache, gathered."""
    import contextlib

    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import base
    from repro_torch.launch import specs
    from repro_torch.models.model import build_model
    from repro_torch.sharding import act
    from repro_torch.sharding import partitioning as part

    cell = specs.make_cell(arch, "prefill_32k", mesh or cell_mesh(),
                           device="cpu")
    logits, cache = specs.run_cell_step(cell, mesh)
    params = cell.args[0]
    b, s = cell.args[1].shape
    gen = torch.Generator().manual_seed(1)
    token = torch.randint(0, 512, (b, 1), generator=gen, dtype=torch.int32)
    pos = torch.full((b,), s - 1, dtype=torch.int32)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        token = part.distribute_tensor(token, part.batch_shardings(
            mesh, {"t": token})["t"], mesh)
        pos = part.distribute_tensor(pos, part.batch_shardings(
            mesh, {"p": pos})["p"], mesh)
        ctx = implicit_replication()
    model = build_model(base.get_config(arch))
    with ctx, act.from_mesh(mesh or cell_mesh()):
        step, cache = model.decode_step(params, cache, token, pos)
    out = {"prefill": logits, "decode": step}
    for i, slot in enumerate(cache):
        out.update({f"cache{i}.{k}": v for k, v in slot.items()})
    return {k: part.gather(v).float().numpy() for k, v in out.items()}


def _serve_rank(rank, world, port, arch, out_dir):
    import numpy as np
    import torch.distributed as dist

    use_small("float32")
    mesh = _gloo(rank, world, port)
    try:
        out = serve_out(arch, mesh)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        one = serve_out(arch)
        np.savez(os.path.join(out_dir, "serve.npz"), **out,
                 **{f"one:{k}": v for k, v in one.items()})


def mode_gloo_serve(arch: str, out_dir: str) -> None:
    _spawn(_serve_rank, arch, out_dir)
    _emit({"ok": True})


# ---- the tree path: one superstep on a (2, 2) gloo mesh -----------------


def tree_cell(npz, device="cpu"):
    """A small frontier problem (the yadt workload's classes and bins, a
    few thousand cases) and its root state, from ``npz``'s data, on
    ``device``."""
    import torch

    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig

    x, y, w, cont, nb = (torch.from_numpy(npz[k]).to(device)
                         for k in ("x", "y", "w", "cont", "n_bins"))
    prob = frontier.FrontierProblem(
        n_cases=x.shape[0], n_attrs=x.shape[1], n_bins_max=int(npz["nbmax"]),
        n_classes=int(npz["n_classes"]), max_children=int(npz["maxch"]),
        cfg=GrowConfig(max_nodes=256, frontier_slots=8,
                       compact=bool(npz["compact"])))
    state = frontier.init_state(prob, y, w)
    return prob, state, (x, y, w, cont, nb)


def superstep_out(prob, state, data, mesh=None, steps: int = 2,
                  knobs=None, impl=None) -> dict:
    """``steps`` supersteps from the root under the layout ``knobs``; the
    splitAtt results of the last one (its histogram, scores and split
    bins) and the node arrays, gathered.  ``impl`` defaults to the
    kernels' ops on a mesh (on CPU shards their plain versions) and to
    the plain versions without one."""
    import contextlib

    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core import frontier
    from repro_torch.sharding import act
    from repro_torch.sharding import partitioning as part

    impl = impl or ("cuda" if mesh else "torch")
    ctx = contextlib.nullcontext()
    if mesh is not None:
        cases = ("data", "model")
        rep = ()
        state = part.distribute(state, frontier.GrowState(
            tree=rep, status=rep, active=rep, case_node=(cases,),
            n_nodes=rep, overflow=rep), mesh)
        data = part.distribute(data, ((cases, None), (cases,), (cases,),
                                      rep, rep), mesh)
        ctx = implicit_replication()
    with ctx, act.from_mesh(mesh or cell_mesh(), **(knobs or {})):
        for _ in range(steps):
            pre = frontier.split_pre(state, prob=prob)
            att = frontier.split_att(state, pre, *data, prob=prob,
                                     impl=impl)
            state, _ = frontier.split_post(state, pre, att, data[0], data[3],
                                           data[4], prob=prob, impl=impl)
        hist = torch.cat([att["hist"], att["unknown"][:, :, None]], 2)
        scores = frontier._gains(att["hist"], pre["total_w"], data[3],
                                 data[4], prob=prob, impl=impl)
    out = {"hist": hist, "score": scores[0], "split_bin": scores[1],
           "best_attr": att["best_attr"], "n_nodes": state.n_nodes,
           "node_attr": state.tree.node_attr,
           "node_class": state.tree.node_class,
           "case_node": state.case_node}
    return {k: part.gather(v).cpu().numpy() for k, v in out.items()}


def tree_npz(compact: bool, n: int = 2000) -> dict:
    """The small frontier problem's data for :func:`tree_cell`: ``n``
    cases of conftest's tree-dataset recipe (3 continuous attributes, 5%
    unknown, and 2 discrete; two classes) binned by the port's own
    ``binning.fit``, so that it runs where JAX is not installed."""
    import numpy as np

    from repro_torch.core import binning
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.frontier import FrontierProblem
    rng = np.random.default_rng(0)
    cols, kinds = [], []
    for _ in range(3):
        c = rng.choice(rng.uniform(-2, 2, size=16), size=n)
        c[rng.random(n) < 0.05] = np.nan
        cols.append(c)
        kinds.append(True)
    for _ in range(2):
        cols.append(rng.integers(0, int(rng.integers(2, 5)), n))
        kinds.append(False)
    y = rng.integers(0, 2, n)
    y = np.where(np.nan_to_num(cols[0], nan=0.0) > 0, 1 - y, y)
    ds = binning.fit(cols, y, attr_is_cont=kinds, n_classes=2, max_bins=64)
    prob = FrontierProblem.from_dataset(ds, GrowConfig())
    return dict(x=ds.x, y=ds.y, w=ds.w, cont=ds.attr_is_cont,
                n_bins=ds.n_bins.astype(np.int32), nbmax=prob.n_bins_max,
                n_classes=prob.n_classes, maxch=prob.max_children,
                compact=compact)


def _tree_rank(rank, world, port, npz_path, out_dir, knobs, steps):
    import numpy as np
    import torch.distributed as dist

    mesh = _gloo(rank, world, port)
    try:
        prob, state, data = tree_cell(np.load(npz_path))
        out = superstep_out(prob, state, data, mesh, steps, knobs=knobs)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        one = superstep_out(*tree_cell(np.load(npz_path)), steps=steps)
        np.savez(os.path.join(out_dir, "tree.npz"), **out,
                 **{f"one:{k}": v for k, v in one.items()})


def mode_gloo_tree(npz_path: str, out_dir: str, knobs: dict,
                   steps: int = 2) -> None:
    _spawn(_tree_rank, npz_path, out_dir, knobs, steps)
    _emit({"ok": True})


if __name__ == "__main__":
    globals()[f"mode_{sys.argv[1]}"](*json.loads(sys.argv[2]))
