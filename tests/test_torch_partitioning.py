"""The port's partitioning rules against the JAX package's, leaf for leaf.

Every parameter of every LM's full config, on the 16x16 pod grid and on
2x16x16, gets the spec the JAX rules give it (a scanned JAX leaf's inner
spec for the port's per-layer leaf); so does every cache field at
decode_32k and long_500k, and the batch, logits and DP-axis rules.
``shard_shape`` is held to ``distribute_tensor``'s local shapes on a 2x4
mesh of the fake process group, in a subprocess.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.model import build_model as jbuild
from repro.sharding import partitioning as jpart
from repro_torch.configs import base
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import partitioning as part

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """Just enough Mesh surface for the JAX rule functions
    (tests/test_sharding.py's)."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _meshes(name):
    sizes = MESHES[name]
    return FakeMesh(sizes), abstract_mesh(tuple(sizes.values()),
                                          tuple(sizes))


def norm(spec) -> tuple:
    """A spec's entries with one-axis tuples as the bare name (JAX's
    ``PartitionSpec`` iterates them so)."""
    def entry(e):
        if e is None or isinstance(e, str):
            return e
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return tuple(entry(e) for e in spec)


def jax_params_by_port_name(arch):
    """{port parameter name: (JAX path, leaf, inner)}: a scanned leaf of
    pattern position j and cycle c is the port's layer c * P + j, a tail
    leaf t the layer n_cycles * P + t; ``inner`` marks a scanned leaf."""
    cfg = jbase.get_config(arch)
    params = jax.eval_shape(jbuild(cfg).init, jax.random.key(0))
    p = len(cfg.block_pattern)
    nc = cfg.n_layers // p
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "scan":
            for c in range(nc):
                out[".".join(map(str, ["layers", c * p + keys[1],
                                       *keys[2:]]))] = (path, leaf, True)
        elif keys[0] == "tail":
            out[".".join(map(str, ["layers", nc * p + keys[1],
                                   *keys[2:]]))] = (path, leaf, False)
        else:
            out[".".join(map(str, keys))] = (path, leaf, False)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_param_pspec_matches_jax_for_every_leaf(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    want = jax_params_by_port_name(arch)
    got = dict(build_model(base.get_config(arch)).init_meta()
               .named_parameters())
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        path, leaf, inner = want[name]
        spec = norm(jpart.param_pspec(path, leaf, jmesh))
        if inner:
            assert spec[0] is None
            spec = spec[1:]
        assert norm(part.param_pspec(name, t, mesh)) == spec, name
        assert norm(part.param_shardings({name: t}, mesh)[name]) == spec


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_cache_pspec_matches_jax_for_every_layer_and_field(
        arch, shape_name, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    shape = base.SHAPES[shape_name]
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)
    jcache = jax.eval_shape(lambda: jbuild(jcfg).init_cache(
        shape.global_batch, shape.seq_len))
    cache = build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                        "meta")
    long = shape_name == "long_500k"
    specs = part.cache_shardings(cfg, mesh, cache, long=long)
    assert len(cache) == len(jcache) == cfg.n_layers
    for i, (slot, jslot) in enumerate(zip(cache, jcache)):
        assert sorted(slot) == sorted(jslot)
        for f, t in slot.items():
            assert tuple(t.shape) == tuple(jslot[f].shape)
            want = norm(jpart.cache_pspec(jcfg, jmesh, i, f, jslot[f].shape,
                                          long=long))
            assert norm(part.cache_pspec(cfg, mesh, i, f, tuple(t.shape),
                                         long=long)) == want, (i, f)
            assert norm(specs[i][f]) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_logits_and_axes_match_jax(mesh_name):
    # the JAX rules wrap these specs in NamedShardings: an AbstractMesh
    _, mesh = _meshes(mesh_name)
    sizes = MESHES[mesh_name]
    jmesh = jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))
    assert part.batch_axes(mesh) == jpart.batch_axes(jmesh)
    for axes in (None, "data", "model", ("data", "model"),
                 tuple(MESHES[mesh_name])):
        assert part.axis_size(mesh, axes) == jpart.axis_size(jmesh, axes)
    for b in (1, 2, 16, 24, 32, 128, 256, 512):
        leaves = {"tokens": torch.empty((b, 64), device="meta"),
                  "frontend_embeds": torch.empty((b, 8, 32), device="meta")}
        got = part.batch_shardings(mesh, leaves)
        want = jpart.batch_shardings(
            jmesh, {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                    for k, v in leaves.items()})
        for k in leaves:
            assert norm(got[k]) == norm(want[k].spec), (b, k)
        for arch in base.ARCH_IDS:
            assert norm(part.logits_sharding(base.get_config(arch), mesh,
                                             b)) == norm(
                jpart.logits_sharding(jbase.get_config(arch), jmesh,
                                      b).spec), (arch, b)


def test_rules_take_a_mapping_and_a_device_mesh_surface():
    sizes = {"data": 2, "model": 4}
    leaf = torch.empty((8, 12), device="meta")
    want = ("data", "model")
    assert part.param_pspec("layers.0.attn.wq", leaf, sizes) == want

    class DeviceMeshLike:                  # DeviceMesh's surface
        mesh_dim_names = ("data", "model")
        shape = (2, 4)
    assert part.param_pspec("wq", leaf, DeviceMeshLike()) == want
    assert part.batch_axes(DeviceMeshLike()) == ("data",)


def test_shard_shape_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert part.shard_shape((64, 4096, 8, 256),
                            (("pod", "data"), "model", None, None),
                            mesh) == (2, 256, 8, 256)
    assert part.shard_shape((7, 9), (), mesh) == (7, 9)
    assert part.to_placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert part.to_placements((None, ("pod", "data", "model")), mesh) == (
        Shard(1), Shard(1), Shard(1))
    assert part.to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        part.to_placements((("model", "data"),), mesh)


SUBPROCESS = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as M
    from repro_torch.sharding import partitioning as part

    cases = json.loads(sys.argv[1])
    out = []
    for rank in (0, 7):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        mesh = M.make_host_mesh(2, 4)
        for shape, spec in cases:
            spec = tuple(tuple(e) if isinstance(e, list) else e
                         for e in spec)
            t = torch.zeros(shape)
            d = distribute_tensor(t, mesh, part.to_placements(spec, mesh))
            out.append([list(d.to_local().shape),
                        list(part.shard_shape(shape, spec, mesh))])
        dist.destroy_process_group()
    print("RESULT" + json.dumps(out))
""")


def test_shard_shape_equals_distribute_tensor_local_shape():
    """On a 2x4 mesh of the fake backend (ranks 0 and 7, in a subprocess so
    that no process group leaks into this one)."""
    cases = [((8, 12), ["data", "model"]), ((16, 4), [["data", "model"],
                                                      None]),
             ((4, 8, 3), ["model", "data", None]), ((5, 3), [None, None]),
             ((6, 8), [None, "model"]), ((2, 16), [None, ["data", "model"]])]
    proc = subprocess.run(
        [sys.executable, "-c", SUBPROCESS, json.dumps(cases)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][0]
    pairs = json.loads(line[len("RESULT"):])
    assert len(pairs) == 2 * len(cases)
    for local, ours in pairs:
        assert local == ours
