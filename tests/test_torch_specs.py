"""The port's cell specs against the JAX package's: the meta parameters'
leaf shapes and dtypes (``jax.eval_shape(model.init)``), every LM cell's
input specs (the decode cache tree included), and every cell's model
flops; and the cells the port builds on meta."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import roofline as jrl
from repro.launch import specs as jspecs
from repro.models.model import build_model as jbuild
from repro_torch.configs import base
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.models.model import build_model
from repro_torch.train.train_step import TrainState

LM_CELLS = [c for c in dryrun.cells_to_run() if c[0] != "yadt"]


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _sds(x) -> tuple:
    return tuple(x.shape), str(np.dtype(x.dtype))


def test_cells_are_the_jax_packages():
    want = []
    for arch in jbase.ARCH_IDS:
        if arch == "yadt":
            want.append((arch, "train_4k"))
            continue
        want += [(arch, s.name)
                 for s in jbase.runnable_shapes(jbase.get_config(arch))]
    assert sorted(dryrun.cells_to_run()) == sorted(want)
    assert len(want) == 35


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_meta_params_have_the_jax_leaf_shapes_and_dtypes(arch):
    cfg = jbase.get_config(arch)
    tree = jax.eval_shape(jbuild(cfg).init, jax.random.key(0))
    p, nc = len(cfg.block_pattern), cfg.n_layers // len(cfg.block_pattern)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "scan":
            for c in range(nc):
                want[".".join(map(str, ["layers", c * p + keys[1],
                                        *keys[2:]]))] = (leaf.shape[1:],
                                                         leaf.dtype)
        elif keys[0] == "tail":
            want[".".join(map(str, ["layers", nc * p + keys[1],
                                    *keys[2:]]))] = (leaf.shape, leaf.dtype)
        else:
            want[".".join(map(str, keys))] = (leaf.shape, leaf.dtype)
    params = build_model(base.get_config(arch)).init_meta()
    got = {k: (tuple(t.shape), _dtype(t))
           for k, t in params.named_parameters()}
    assert got == {k: (tuple(s), str(np.dtype(d)))
                   for k, (s, d) in want.items()}
    assert all(t.is_meta for t in params.parameters())
    assert sum(t.numel() for t in params.parameters()) == sum(
        int(np.prod(s)) for s, _ in want.values())


@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_input_specs_match_jax(arch, shape):
    want = jspecs.input_specs(arch, shape)
    got = specs.input_specs(arch, shape)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k == "cache":
            assert len(v) == len(want[k])
            for slot, jslot in zip(v, want[k]):
                assert {f: (tuple(t.shape), _dtype(t))
                        for f, t in slot.items()} == {
                    f: _sds(t) for f, t in jslot.items()}
                assert all(t.is_meta for t in slot.values())
        else:
            assert (tuple(v.shape), _dtype(v)) == _sds(want[k]) and v.is_meta


@pytest.mark.parametrize("arch,shape", dryrun.cells_to_run())
def test_model_flops_match_jax(arch, shape):
    assert roofline.model_flops_for(arch, shape) == jrl.model_flops_for(
        arch, shape)


def test_train_cell_builds_on_meta_with_the_jax_accumulation():
    cell = specs.make_cell("gemma3_4b", "train_4k")
    state, batch = cell.args
    assert isinstance(state, TrainState) and cell.grad_accum == 4
    assert cell.batch == 256 and batch["tokens"].shape == (256, 4096)
    assert all(t.is_meta and t.dtype == torch.float32
               for t in state.m.values())
    small = specs.make_cell("gemma3_4b", "train_4k", batch=2)
    assert small.grad_accum == 1 and small.batch == 2
    # the args' bytes: the weights (bf16, the f32 leaves f32), two f32
    # moments a parameter, and the int32 tokens and labels
    weights = sum(t.numel() * t.element_size()
                  for t in state.params.parameters())
    n = sum(t.numel() for t in state.params.parameters())
    assert specs.device_arg_bytes(cell, specs.one_device_mesh()) == (
        weights + 8 * n + 2 * 256 * 4096 * 4)


def test_per_device_arg_bytes_follow_the_specs():
    from repro_torch.launch.mesh import abstract_mesh
    mesh = abstract_mesh((16, 16), ("data", "model"))
    cell = specs.make_cell("yi_6b", "decode_32k", mesh)
    params, cache, token, pos = cell.args
    whole = specs.device_arg_bytes(cell, specs.one_device_mesh())
    assert whole == sum(t.numel() * t.element_size()
                        for t in roofline.tree_tensors(cell.args))
    # KV caches over batch (data) and sequence (model): 1/256 a device
    kv = sum(t.numel() * 2 for slot in cache for t in slot.values())
    assert specs.device_arg_bytes(cell, mesh) < whole / 16
    assert specs.device_arg_bytes(cell, mesh) >= kv // 256


def test_cuda_cell_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        specs.make_cell("yi_6b", "decode_32k", device="cuda", batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_cell("gemma3_4b", "long_500k", device="cuda",
                        verbose=False)
