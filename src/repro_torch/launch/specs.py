"""Steps and inputs for every (arch x shape) cell: the port of
``repro.launch.specs``.

The single source the dry run, the roofline and the tests build from.  On
``device="meta"`` nothing is allocated: the parameters and AdamW moments
come from ``Model.init_meta`` (the counterpart of ``jax.eval_shape(
model.init)``), the inputs and caches are meta tensors, and the kernels'
wrappers return empty outputs and count their work.  On ``device="cuda"``
the same cell holds real tensors on the card: weights from seed 0, tokens
drawn from seed 0, the ``yadt`` cases from the port's QUEST generator.
The layouts come from :mod:`repro_torch.sharding.partitioning` as specs
(tuples of mesh-axis names); ``partitioning.to_placements`` turns one into
DTensor placements over a ``DeviceMesh``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.configs import base as cfgbase
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.device import resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import frontends
from repro_torch.models.model import build_model
from repro_torch.sharding import partitioning as part
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (TrainState, init_state,
                                          make_train_step, named_params)

SEED = 0


@dataclasses.dataclass
class Cell:
    """Everything needed to run one (arch x shape x mesh) cell.  ``batch``
    is the global batch the args hold (``make_cell(batch=)`` cuts it for a
    card run), ``grad_accum`` the train step's microbatches."""
    arch: str
    shape: ShapeSpec
    step_fn: Callable
    args: tuple            # meta or CUDA tensor trees
    in_shardings: tuple    # specs, tree for tree
    out_shardings: Any
    static_kwargs: dict
    batch: int = 0
    grad_accum: int = 1
    device: str = "meta"


def one_device_mesh():
    """The mesh of one card: both axes of size 1."""
    return abstract_mesh((1, 1), ("data", "model"))


def _device(device) -> torch.device:
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def _generator(dev: torch.device) -> torch.Generator:
    gen = torch.Generator(dev)
    gen.manual_seed(SEED)
    return gen


def _tokens(shape, cfg: ModelConfig, dev: torch.device) -> torch.Tensor:
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.int32, device=dev)
    return torch.randint(0, cfg.vocab_size, shape, generator=_generator(dev),
                         device=dev, dtype=torch.int32)


def _frontend(cfg: ModelConfig, b: int, dev: torch.device):
    spec = frontends.frontend_embeds_spec(cfg, b)
    if spec is None or dev.type != "meta":
        return (None if spec is None
                else frontends.fake_frontend_embeds(cfg, b, SEED, dev))
    return torch.empty(spec[0], dtype=spec[1], device=dev)


def _params(model, dev: torch.device):
    if dev.type == "meta":
        return model.init_meta()
    return model.init(_generator(dev))


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                      batch: int | None = None, device="meta") -> dict:
    dev = _device(device)
    b, s = shape.global_batch if batch is None else batch, shape.seq_len
    out = {"tokens": _tokens((b, s), cfg, dev),
           "labels": _tokens((b, s), cfg, dev)}
    fe = _frontend(cfg, b, dev)
    if fe is not None:
        out["frontend_embeds"] = fe
    return out


def input_specs(arch: str, shape_name: str) -> dict:
    """Meta tensors standing in for every model input (the decode cache
    tree included)."""
    cfg = cfgbase.get_config(arch)
    shape = cfgbase.SHAPES[shape_name]
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    b = shape.global_batch
    meta = torch.device("meta")
    if shape.kind == "prefill":
        out = {"tokens": _tokens((b, shape.seq_len), cfg, meta)}
        fe = _frontend(cfg, b, meta)
        if fe is not None:
            out["frontend_embeds"] = fe
        return out
    # decode: one new token against a seq_len cache
    return {"token": _tokens((b, 1), cfg, meta),
            "pos": torch.empty((b,), dtype=torch.int32, device=meta),
            "cache": build_model(cfg).init_cache(b, shape.seq_len, meta)}


def _state_shardings(state: TrainState, mesh) -> TrainState:
    return TrainState(
        params=part.param_shardings(named_params(state.params), mesh),
        m=part.param_shardings(state.m, mesh),
        v=part.param_shardings(state.v, mesh),
        step=part.replicated(mesh))


# --------------------------------------------------------------------------
# cells per step kind
# --------------------------------------------------------------------------


def make_cell(arch: str, shape_name: str, mesh=None, *, device="meta",
              batch: int | None = None) -> Cell:
    """The cell's step and its arguments on ``device`` ("meta" or
    "cuda"), at the shape's global batch or at ``batch`` rows."""
    mesh = one_device_mesh() if mesh is None else mesh
    if arch == "yadt":
        return _yadt_cell(shape_name, mesh, device=device)
    cfg = cfgbase.get_config(arch)
    shape = cfgbase.SHAPES[shape_name]
    dev = _device(device)
    b = shape.global_batch if batch is None else int(batch)
    model = build_model(cfg)
    params = _params(model, dev)

    if shape.kind == "train":
        state = init_state(params)
        state_sh = _state_shardings(state, mesh)
        batch_t = train_batch_specs(cfg, shape, batch=b, device=dev)
        batch_sh = part.batch_shardings(mesh, batch_t)
        # Microbatching, the JAX package's rule applied to the batch that
        # runs: 4 accumulation steps from a global batch of 64.
        grad_accum = 4 if b >= 64 else 1
        step = make_train_step(
            lambda p, bt: model.loss_fn(p, bt), opt.AdamWConfig(),
            grad_accum=grad_accum)
        metrics_sh = {k: part.replicated(mesh) for k in
                      ("loss", "n_tokens", "grad_norm", "lr")}
        if cfg.is_moe:
            metrics_sh.update(moe_aux=part.replicated(mesh),
                              moe_dropped=part.replicated(mesh))
        return Cell(arch, shape, step, (state, batch_t),
                    (state_sh, batch_sh), (state_sh, metrics_sh), {},
                    batch=b, grad_accum=grad_accum, device=dev.type)

    params_sh = part.param_shardings(named_params(params), mesh)

    if shape.kind == "prefill":
        tokens = _tokens((b, shape.seq_len), cfg, dev)
        fe = _frontend(cfg, b, dev)
        args = [params, tokens] + ([fe] if fe is not None else [])
        cache_sh = part.cache_shardings(
            cfg, mesh, model.init_cache(b, shape.seq_len,
                                        torch.device("meta")))
        in_sh = [params_sh, part.batch_shardings(mesh, {"t": tokens})["t"]]
        if fe is not None:
            in_sh.append(part.batch_shardings(mesh, {"f": fe})["f"])
        out_sh = (part.logits_sharding(cfg, mesh, b), cache_sh)

        def prefill_step(p, t, *rest):
            return model.prefill(p, t, *(rest or (None,)),
                                 max_seq=shape.seq_len)

        return Cell(arch, shape, prefill_step, tuple(args), tuple(in_sh),
                    out_sh, {}, batch=b, device=dev.type)

    # decode: every row at the cache's last position
    long = shape.name == "long_500k"
    cache = model.init_cache(b, shape.seq_len, dev)
    cache_sh = part.cache_shardings(cfg, mesh, cache, long=long)
    token = _tokens((b, 1), cfg, dev)
    pos = torch.full((b,), shape.seq_len - 1, dtype=torch.int32, device=dev)
    tok_sh = part.batch_shardings(mesh, {"t": token})["t"]
    pos_sh = part.batch_shardings(mesh, {"p": pos})["p"]
    out_sh = (part.logits_sharding(cfg, mesh, b), cache_sh)

    def decode(p, c, t, pv):
        return model.decode_step(p, c, t, pv)

    return Cell(arch, shape, decode, (params, cache, token, pos),
                (params_sh, cache_sh, tok_sh, pos_sh), out_sh, {},
                batch=b, device=dev.type)


# --------------------------------------------------------------------------
# the paper's own workload (arch == "yadt"): one frontier superstep
# --------------------------------------------------------------------------


def _yadt_cell(shape_name: str, mesh, *, device="meta") -> Cell:
    from repro_torch.configs.yadt import WORKLOAD as wl
    from repro_torch.core import frontier
    from repro_torch.data import quest

    shape = cfgbase.SHAPES[shape_name]
    # train_4k is the full 10M-case superstep, the other shapes the JAX
    # package's fractions; a multiple of 512 (shardable on either mesh)
    n_cases = {"train_4k": wl.n_cases, "prefill_32k": wl.n_cases // 4,
               "decode_32k": wl.n_cases // 8,
               "long_500k": wl.n_cases // 16}[shape_name]
    n_cases = -(-n_cases // 512) * 512
    dev = _device(device)
    prob = frontier.FrontierProblem(
        n_cases=n_cases, n_attrs=wl.n_attrs, n_bins_max=wl.n_bins,
        n_classes=wl.n_classes, max_children=wl.max_children, cfg=wl.grow)
    if dev.type == "meta":
        x = torch.empty((n_cases, wl.n_attrs), dtype=torch.int32, device=dev)
        y = torch.empty((n_cases,), dtype=torch.int32, device=dev)
        w = torch.empty((n_cases,), dtype=torch.float32, device=dev)
        cont = torch.empty((wl.n_attrs,), dtype=torch.bool, device=dev)
        nb = torch.empty((wl.n_attrs,), dtype=torch.int32, device=dev)
    else:
        ds = quest.syd(n_cases, seed=SEED, max_bins=wl.n_bins)
        x, y, w, cont = (torch.as_tensor(a).to(dev) for a in
                         (ds.x, ds.y, ds.w, ds.attr_is_cont))
        nb = torch.as_tensor(ds.n_bins, dtype=torch.int32).to(dev)
    state = frontier.init_state(prob, y, w)

    dp = part.batch_axes(mesh) + ("model",)   # cases over every axis
    case_sh, case2_sh = (dp,), (dp, None)
    rep = part.replicated(mesh)
    # case -> node assignment lives with the cases; the rest replicated
    state_sh = frontier.GrowState(tree=rep, status=rep, active=rep,
                                  case_node=case_sh, n_nodes=rep,
                                  overflow=rep)

    def superstep(state, x, y, w, cont, nb):
        # The port's superstep updates the node arrays (and on the card
        # the cases' nodes) in place: a copy makes the step a function of
        # its arguments, as the JAX cell's is, so every call runs the same
        # root superstep.
        return frontier.superstep(_copy_state(state), x, y, w, cont, nb,
                                  prob=prob, impl="cuda")

    stats_sh = {k: rep for k in ("n_processed", "n_active", "n_internal",
                                 "n_children", "max_r", "nap_nodes",
                                 "overflow")}
    return Cell("yadt", shape, superstep, (state, x, y, w, cont, nb),
                (state_sh, case2_sh, case_sh, case_sh, rep, rep),
                (state_sh, stats_sh), {}, batch=n_cases, device=dev.type)


def _copy_state(state):
    from repro_torch.core import frontier
    tree = dataclasses.replace(state.tree, **{
        f.name: getattr(state.tree, f.name).clone()
        for f in dataclasses.fields(state.tree)
        if isinstance(getattr(state.tree, f.name), torch.Tensor)})
    return frontier.GrowState(
        tree=tree, status=state.status.clone(), active=state.active.clone(),
        case_node=state.case_node.clone(), n_nodes=state.n_nodes,
        overflow=state.overflow)


# --------------------------------------------------------------------------
# running a cell
# --------------------------------------------------------------------------


def is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def run_cell_step(cell: Cell, mesh=None, *, unroll: bool = False,
                  count: bool = False, **knobs):
    """The cell's step on its args under the mesh's activation context and
    the layout ``knobs`` (the JAX ``lower_cell``).  Returns its output,
    or with ``count`` (output, ``roofline.Costs``).

    On a ``DeviceMesh`` the step is partitioned, the counterpart of
    ``jax.jit(in_shardings=, out_shardings=)``: the args are laid out as
    DTensors by ``cell.in_shardings`` (``partitioning.distribute``), once:
    the cell keeps them, so that it then lives on the mesh and a step that
    updates its state in place carries it to the next call; the step runs
    on them (plain tensors it makes are taken as replicated) and its
    outputs are laid out by ``cell.out_shardings``.  The count is then the
    device's (rank 0's on a fake mesh).  On an ``AbstractMesh`` or one
    device the step runs as it is."""
    from repro_torch.sharding import act
    from repro_torch.utils import scan as uscan

    mesh = one_device_mesh() if mesh is None else mesh
    ctx = uscan.unrolled() if unroll else contextlib.nullcontext()
    fn, args = cell.step_fn, cell.args
    if is_device_mesh(mesh):
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        args = cell.args = part.distribute(args, cell.in_shardings, mesh)

        def fn(*a):
            with implicit_replication():
                out = cell.step_fn(*a)
            return part.distribute(out, cell.out_shardings, mesh)
    with act.from_mesh(mesh, **knobs), ctx:
        if count:
            return roofline.count_costs(fn, *args)
        return fn(*args)


def make_analysis_cells(arch: str, shape_name: str, mesh=None, *,
                        device="meta", batch: int | None = None
                        ) -> list[tuple[Cell, float]]:
    """Cells whose counts make up the step's cost, with their scales.

    The JAX package composes a train or prefill step's cost from small
    unrolled pieces because ``cost_analysis`` counts a scan body once.
    Eager PyTorch runs every layer, microbatch and chunk as its own ops,
    and the flop and byte counters see each of them, so the whole step is
    its own analysis cell, at scale 1.0."""
    return [(make_cell(arch, shape_name, mesh, device=device, batch=batch),
             1.0)]


# --------------------------------------------------------------------------
# per-device argument bytes
# --------------------------------------------------------------------------


def arg_specs(cell: Cell) -> list[tuple[torch.Tensor, tuple]]:
    """(tensor, spec) of every distinct argument tensor of the cell; a
    container whose spec is one spec (``()``: replicated) gives it to every
    tensor inside."""
    out: dict[int, tuple[torch.Tensor, tuple]] = {}

    def walk(arg, spec):
        if isinstance(arg, torch.Tensor):
            out.setdefault(id(arg), (arg, spec))
        elif part.is_spec(spec) and not isinstance(arg, (list, tuple)):
            for t in roofline.tree_tensors(arg):
                out.setdefault(id(t), (t, spec))
        elif isinstance(arg, nn.Module):
            walk(named_params(arg), spec)
        elif isinstance(arg, dict):
            for k, v in arg.items():
                walk(v, spec[k])
        elif isinstance(arg, (list, tuple)):
            for v, s in zip(arg, spec):
                walk(v, s)
        elif dataclasses.is_dataclass(arg):
            for f in dataclasses.fields(arg):
                walk(getattr(arg, f.name), getattr(spec, f.name))

    walk(cell.args, cell.in_shardings)
    return list(out.values())


def device_arg_bytes(cell: Cell, mesh) -> int:
    """The bytes of the cell's arguments one device holds, each laid out
    by its spec (``partitioning.shard_shape``)."""
    total = 0
    for t, spec in arg_specs(cell):
        n = 1
        for d in part.shard_shape(t.shape, spec, mesh):
            n *= d
        total += n * t.element_size()
    return total
