"""Roofline of one NVIDIA H100 SXM: the port of ``repro.launch.roofline``.

The card's published peaks (NVIDIA H100 SXM data sheet, at its 700 W
limit) are kept here and nowhere else in the port:

  * 989 TFLOP/s dense bf16 on the tensor cores (the LM cells' peak, and
    the flash kernels' operations bound),
  * 67 TFLOP/s f32 on the CUDA cores, used for every scalar operation
    outside the tensor cores (the tree kernels, the ``yadt`` cell),
  * 3.35 TB/s and 80 GB of HBM3,
  * the collective rate of one card (:func:`collective_rate`): NVLink 4 at
    450 GB/s each way (the data sheet's 900 GB/s bidirectional) on a mesh
    of at most 8 cards, one NVLink domain; on a larger mesh the 50 GB/s of
    one 400 Gb/s NIC a card (the DGX H100 layout: eight cards, eight
    ConnectX-7 NICs).  One rate a mesh, the JAX package's simplification
    (its one ICI rate).

A step's costs come from running it (:func:`count_costs`), on meta
tensors (shapes only, nothing allocated; runs on the CPU) or on the card,
on plain tensors (one card) or on DTensors over a ``DeviceMesh`` (a
partitioned step: the counts are then one device's, rank 0's):

  * ``device_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count
    of the step (its formulas and decompositions, in a mode of this
    module's that sees one device's ops), the hand-written kernels counted
    by their own formulas
    (registered beside each kernel's custom op, from this module's
    ``*_flops`` / ``*_ops``);
  * ``device_bytes``: every op's tensor inputs read once and outputs
    written once (views and ``empty`` allocations move nothing), which is
    what the port's unfused eager program moves: the counterpart of XLA's
    "bytes accessed";
  * ``min_bytes``: the step's arguments read once and its outputs written
    once; an argument the step updates in place (the train state, the
    decode cache) counts once, as read;
  * ``device_coll_bytes``: :func:`collective_bytes` of the collectives the
    device issues (``_c10d_functional`` ops and DTensor's all-to-all, each
    with its group's size), the JAX package's ring factors on each result.

Under DTensor the counters see each rank's local ops (a mode that declines
DTensor arguments sees the ops DTensor runs on the shards) and leave out
the ops DTensor's sharding propagation runs on fake global-shape tensors
to learn the output shapes.

``bound_s = max(device_flops / peak, min_bytes / bandwidth)``, with
``bound_by`` saying which.  ``t_memory`` keeps the JAX meaning (the
program's bytes over the bandwidth), ``t_collective`` is the collective
bytes over the mesh's rate (0 on one card, which issues none).
"""

from __future__ import annotations

import contextlib
import dataclasses
import traceback
from pathlib import Path
from typing import Any, Callable

# NVIDIA H100 SXM (data sheet, 700 W): HBM3 rate and size, the tensor
# cores' dense bf16 rate, and the CUDA cores' f32 rate
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
BF16_TENSOR_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
# one card's collective rate (one way): NVLink 4 inside a node of at most
# 8 cards (data sheet: 900 GB/s bidirectional), else one 400 Gb/s NIC a
# card (DGX H100: eight ConnectX-7 NICs for eight cards)
NVLINK_BYTES_PER_S = 450e9
NIC_BYTES_PER_S = 50e9
NVLINK_DOMAIN = 8
# the JAX module's names
PEAK_FLOPS = BF16_TENSOR_OPS_PER_S
HBM_BW = HBM_BYTES_PER_S
# integer operations a traversal descent step: leaf test, unknown test,
# threshold test, two clip bounds, child add
OPS_PER_STEP = 6


def collective_rate(n_devices: int) -> tuple[float, str]:
    """(bytes/s, which link) a card moves collective bytes at on a mesh of
    ``n_devices``."""
    if n_devices <= NVLINK_DOMAIN:
        return NVLINK_BYTES_PER_S, "nvlink4"
    return NIC_BYTES_PER_S, "nic_400g"


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time of work that moves ``n_bytes`` and does ``n_ops`` at
    ``ops_per_s``, in ms, and which of the two sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# the hand-written kernels' work (PERF.md section 6, "Bounds")
# --------------------------------------------------------------------------


def live_pairs(s: int, window: int) -> int:
    """(q, k) pairs inside the causal window of ``s`` rows from position 0:
    sum over q of min(q + 1, window)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_fwd_flops(b: int, s: int, h: int, d: int, window: int) -> int:
    """4 * D flops a live (q, k) pair and head (S = QK^T and PV)."""
    return 4 * b * h * d * live_pairs(s, window)


def flash_bwd_flops(b: int, s: int, h: int, d: int, window: int) -> int:
    """10 * D flops a live pair and head (S, dP, dV, dK, dQ)."""
    return 10 * b * h * d * live_pairs(s, window)


def flash_fwd_bytes(b: int, sq: int, h: int, kv: int, d: int, itemsize: int,
                    *, sk: int | None = None, lse: bool = False) -> int:
    """q, k, v read once, the output (and the f32 LSE) written once."""
    sk = sq if sk is None else sk
    return ((2 * b * sq * h * d + 2 * b * sk * kv * d) * itemsize
            + (b * h * sq * 4 if lse else 0))


def flash_bwd_bytes(b: int, sq: int, h: int, kv: int, d: int, itemsize: int,
                    *, sk: int | None = None) -> int:
    """q, k, v, o, dO and the LSE read once, dq, dk, dv written once."""
    sk = sq if sk is None else sk
    return ((4 * b * sq * h * d + 4 * b * sk * kv * d) * itemsize
            + b * h * sq * 4)


def histogram_bytes(n: int, a: int, cells: int, listed: bool = False) -> int:
    """Each case row (A int32 bins, label, weight, slot) read once, each of
    ``cells`` output cells written once; read through a list of cases,
    each case's int32 index in it too."""
    return n * (4 * a + 12 + (4 if listed else 0)) + 4 * cells


def histogram_ops(n: int, a: int) -> int:
    """One add per (case, attribute)."""
    return n * a


def split_gain_bytes(k: int, a: int, b: int, c: int) -> int:
    """The (K, A, B, C) f32 histogram, the K totals, the A flags and bin
    counts read once; the (K, A) score and bin written once."""
    return k * a * b * c * 4 + k * 4 + a * 5 + k * a * 8


def split_gain_ops(k: int, a: int, b: int, c: int) -> int:
    """The prefix scan, the entropies and the argmax: 6C + 20 a bin."""
    return k * a * b * (6 * c + 20)


def split_post_bytes(n: int, live: int, waiting: int = 0,
                     changed: int = 0, listed: int = 0) -> int:
    """splitPost's routing: each case's int32 slot read once; a live case's
    bin of its node's split attribute read and its new node written (the
    node kernel's K rows are negligible beside N).  Writing the next
    frontier (an open range) it also reads the node of each of the
    ``waiting`` cases (slot -1: an open node outside the frontier), writes
    each of the ``changed`` slots and the int32 index of each of the
    ``listed`` cases that are live in the next superstep."""
    return n * 4 + live * 8 + waiting * 4 + changed * 4 + listed * 4


def traversal_bytes(n: int, a: int, t: int, rows: int) -> int:
    """The N case rows, ``rows`` node-table rows (32 bytes) and the (T, N)
    labels, once each."""
    return n * a * 4 + rows * 32 + t * n * 4


def traversal_ops(steps: int) -> int:
    return OPS_PER_STEP * steps


def _shape(t) -> tuple[int, ...]:
    return tuple(t.shape)


def _flash_fwd_bytes(args, lse: bool) -> int:
    qs, k = args[0], args[1]
    b, sq, h, d = _shape(qs)
    return flash_fwd_bytes(b, sq, h, k.shape[2], d, qs.element_size(),
                           sk=k.shape[1], lse=lse)


def _flash_bwd_bytes(args) -> int:
    qs, k = args[0], args[1]
    b, sq, h, d = _shape(qs)
    return flash_bwd_bytes(b, sq, h, k.shape[2], d, qs.element_size(),
                           sk=k.shape[1])


def _histogram_bytes(args) -> int:
    x, n_slots, n_bins, n_classes = args[0], args[4], args[5], args[6]
    n, a = _shape(x)
    listed = len(args) > 10 and args[10] is not None
    return histogram_bytes(args[11] if listed else n, a,
                           n_slots * a * (n_bins + 1) * n_classes, listed)


def _split_gain_bytes(args) -> int:
    return split_gain_bytes(*_shape(args[0]))


def _traversal_bytes(args) -> int:
    t, m, _ = _shape(args[0])
    n, a = _shape(args[1])
    return traversal_bytes(n, a, t, t * m)   # the whole table: no data here


# The bytes of the kernels' custom ops, by op name, from their arguments.
KERNEL_BYTES: dict[str, Callable[[tuple], int]] = {
    "repro_torch::flash_fwd": lambda args: _flash_fwd_bytes(args, False),
    "repro_torch::flash_fwd_lse": lambda args: _flash_fwd_bytes(args, True),
    "repro_torch::flash_bwd": _flash_bwd_bytes,
    "repro_torch::frontier_histogram": _histogram_bytes,
    "repro_torch::split_gain": _split_gain_bytes,
    "repro_torch::forest_predict": _traversal_bytes,
}


# --------------------------------------------------------------------------
# counting a step
# --------------------------------------------------------------------------


class NeedsDevice(RuntimeError):
    """The step asked a meta tensor for its data (a ``nonzero``, an
    ``.item()``): it runs only on the card.  ``op`` is the aten op,
    ``where`` the port's line that called it."""

    def __init__(self, op: str, where: str, error: str):
        super().__init__(f"{op} at {where} needs the device: {error}")
        self.op, self.where, self.error = op, where, error


def _is_data_dependent(e: Exception) -> bool:
    msg = str(e)
    return (isinstance(e, NotImplementedError) or "meta tensor" in msg
            or "data-dependent" in msg)


_PORT = Path(__file__).resolve().parents[1]


def _caller() -> str:
    """``path:line`` of the innermost frame in the port outside this
    module."""
    for frame in reversed(traceback.extract_stack()):
        path = Path(frame.filename).resolve()
        if _PORT in path.parents and path != Path(__file__).resolve():
            return f"{path.relative_to(_PORT.parent)}:{frame.lineno}"
    return "?"


def _dtensor_class():
    """``DTensor``, or None where torch has no ``torch.distributed``."""
    import torch
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return DTensor


def _local(t):
    """A DTensor's local shard (what one device holds); any other tensor
    itself."""
    cls = _dtensor_class()
    return t.to_local() if cls is not None and isinstance(t, cls) else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _decliner():
    """A test of an op's argument types: True for an op on DTensors, which
    a counting mode declines (returns NotImplemented) so that it sees the
    ops DTensor then runs on the shards, the collectives among them."""
    cls = _dtensor_class()
    if cls is None:
        return lambda types: False
    return lambda types: any(issubclass(t, cls) for t in types)


def _propagation(args, out) -> bool:
    """True for an op DTensor's sharding propagation runs on fake
    global-shape tensors to learn an output's shape: no device runs it."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor)
               for t in _op_tensors((args, out)))


# --------------------------------------------------------------------------
# collective bytes: the JAX package's ring model
# --------------------------------------------------------------------------

# The collectives' op names (``_c10d_functional``, DTensor's all-to-all)
# by the JAX package's (XLA's) names.
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# What a collective moves per device over a ring of g, from its result
# (``repro.launch.roofline.collective_bytes``).
RING = {"all-gather": lambda size, g: size * (g - 1) / g,
        "all-reduce": lambda size, g: 2 * size * (g - 1) / g,
        "reduce-scatter": lambda size, g: size * (g - 1),
        "all-to-all": lambda size, g: size * (g - 1) / g,
        "collective-permute": lambda size, g: float(size)}


def collective_op(func) -> str | None:
    """The JAX name of a collective op, None for any other op; raises on
    a communicating op the count does not know."""
    ns, _, name = func._schema.name.partition("::")
    if ns not in ("_c10d_functional", "c10d_functional", "_dtensor"):
        return None
    if name in _COLLECTIVES:
        return _COLLECTIVES[name]
    if name in ("wait_tensor", "_wrap_tensor_autograd") or ns == "_dtensor":
        return None
    raise NotImplementedError(f"collective_bytes: no ring model for "
                              f"{func._schema.name}")


def _group_size(func, args, kwargs) -> int:
    """The size of the op's process group, from its ``group_name``."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args)) | kwargs
    return _resolve_process_group(bound["group_name"]).size()


def collective_bytes(issued: list[tuple[str, int, int]]
                     ) -> tuple[float, dict[str, float]]:
    """Per-device communicated bytes of ``issued`` collectives, each
    ``(JAX op name, result bytes, group size)``: the total and the bytes by
    op (the counterpart of the JAX function, which reads the same triples
    out of the partitioned HLO).  A group of one moves nothing."""
    total = 0.0
    by_op: dict[str, float] = {}
    for op, size, g in issued:
        if g <= 1:
            continue
        vol = RING[op](size, g)
        total += vol
        by_op[op] = by_op.get(op, 0.0) + vol
    return total, by_op


def _op_tensors(x) -> list:
    """Every tensor leaf of an op's arguments or outputs, repeats included
    (an op reads an input it is given twice twice, as far as this count
    goes; so a scan counted once stacks as many inputs as the one run)."""
    import torch
    return [t for t in torch.utils._pytree.tree_leaves(x)
            if isinstance(t, torch.Tensor)]


def _make_byte_counter():
    from torch.utils._python_dispatch import TorchDispatchMode

    class ByteCounter(TorchDispatchMode):
        """Adds each op's tensor inputs and outputs (a kernel's custom op:
        its formula); views and ``empty`` allocations add nothing.  A meta
        tensor asked for its data raises :class:`NeedsDevice`.  Each
        collective is also kept in ``issued`` (its JAX name, its result's
        bytes and its group's size)."""

        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.ops = 0
            self.issued: list[tuple[str, int, int]] = []
            self.declines = _decliner()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if self.declines(types):
                return NotImplemented
            try:
                out = func(*args, **kwargs)
            except Exception as e:
                metas = [t for t in _op_tensors((args, kwargs)) if t.is_meta]
                if metas and _is_data_dependent(e):
                    raise NeedsDevice(func._schema.name, _caller(),
                                      str(e).splitlines()[0]) from e
                raise
            if _propagation(args, out):
                return out
            name = func._schema.name
            coll = collective_op(func)
            if coll is not None:
                self.issued.append((coll, sum(map(_nbytes, _op_tensors(out))),
                                    _group_size(func, args, kwargs)))
            self.ops += 1
            if name in KERNEL_BYTES:
                self.bytes += KERNEL_BYTES[name](args)
            elif not (func.is_view or name.startswith(("aten::empty",
                                                       "aten::new_empty"))):
                self.bytes += sum(map(_nbytes, _op_tensors((args, kwargs))))
                self.bytes += sum(map(_nbytes, _op_tensors(out)))
            return out

    return ByteCounter()


# the shape queries _FlopCounterMode lets through uncounted
_SHAPE_QUERIES = ("sym_is_contiguous.default", "is_contiguous.default",
                  "is_contiguous.memory_format",
                  "is_strides_like_format.default",
                  "is_non_overlapping_and_dense.default", "size.default",
                  "sym_size.default", "stride.default", "sym_stride.default",
                  "storage_offset.default", "sym_storage_offset.default",
                  "numel.default", "sym_numel.default", "dim.default")


def _make_flop_counter():
    import torch
    from torch.utils import flop_counter
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    skip = {getattr(getattr(aten, n.split(".")[0]), n.split(".")[1])
            for n in _SHAPE_QUERIES if hasattr(aten, n.split(".")[0])}
    skip.add(torch.ops.prim.layout.default)

    class FlopCounter(TorchDispatchMode):
        """``torch.utils.flop_counter.FlopCounterMode``'s count (its
        formulas, the kernels' registered ones among them, and its
        decomposition of an op it has no formula for), of the ops one
        device runs: it declines DTensor arguments, so that it counts the
        local ops on the shards, and leaves out sharding propagation."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.registry = dict(flop_counter.flop_registry)
            self.declines = _decliner()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (func in skip or self.declines(types)
                    or isinstance(func, torch._ops.HigherOrderOperator)):
                return NotImplemented
            if (func not in self.registry
                    and func is not torch.ops.prim.device.default):
                with self:
                    r = func.decompose(*args, **kwargs)
                    if r is not NotImplemented:
                        return r
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if packet in self.registry and not _propagation(args, out):
                self.flops += self.registry[packet](*args, **kwargs,
                                                    out_val=out)
            return out

    return FlopCounter()


def tree_tensors(tree) -> list:
    """The distinct tensors (by identity) of a step's arguments or outputs:
    through tuples, lists, dicts, dataclasses (the train and grow states)
    and modules (their parameters and buffers)."""
    import torch
    from torch import nn

    seen: dict[int, Any] = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            seen.setdefault(id(x), x)
        elif isinstance(x, nn.Module):
            for t in [*x.parameters(), *x.buffers()]:
                walk(t)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(tree)
    return list(seen.values())


@dataclasses.dataclass
class Costs:
    """What :func:`count_costs` counted for one call, on one device (a
    DTensor argument or output counts its local shard)."""
    device_flops: float
    device_bytes: float
    arg_bytes: float
    out_bytes: float          # outputs that are not arguments
    n_ops: int
    coll_bytes: float = 0.0   # collective_bytes of the issued collectives
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    n_collectives: int = 0

    @property
    def min_bytes(self) -> float:
        return self.arg_bytes + self.out_bytes


class _Repeat:
    """``repeat(n)``: what the two counters count inside it counts ``n``
    times (``utils.scan.counted``: one of ``n`` identical iterations run
    on meta tensors)."""

    def __init__(self, flops, counter):
        self.flops, self.counter = flops, counter

    @contextlib.contextmanager
    def repeat(self, n: int):
        f0, b0, o0, c0 = (self.flops.flops, self.counter.bytes,
                          self.counter.ops, len(self.counter.issued))
        yield
        extra = n - 1
        self.flops.flops += extra * (self.flops.flops - f0)
        self.counter.bytes += extra * (self.counter.bytes - b0)
        self.counter.ops += extra * (self.counter.ops - o0)
        self.counter.issued += extra * self.counter.issued[c0:]


def count_costs(fn: Callable, *args, **kwargs) -> tuple[Any, Costs]:
    """Run ``fn(*args, **kwargs)`` under the flop counter and the byte
    counter; returns its output and the :class:`Costs`.  Raises
    :class:`NeedsDevice` where a meta argument's data was needed."""
    import repro_torch.kernels.ops  # noqa: F401  (the kernels' formulas)
    from repro_torch.utils import scan as uscan

    counter = _make_byte_counter()
    flops = _make_flop_counter()
    with flops, counter:
        uscan.COUNTERS.append(_Repeat(flops, counter))
        try:
            out = fn(*args, **kwargs)
        finally:
            uscan.COUNTERS.pop()
    arg_ts = tree_tensors(args)
    arg_ids = {id(t) for t in arg_ts}
    out_ts = [t for t in tree_tensors(out) if id(t) not in arg_ids]
    coll, by_op = collective_bytes(counter.issued)
    return out, Costs(device_flops=float(flops.flops),
                      device_bytes=float(counter.bytes),
                      arg_bytes=float(sum(map(_nbytes, arg_ts))),
                      out_bytes=float(sum(map(_nbytes, out_ts))),
                      n_ops=counter.ops, coll_bytes=coll, coll_by_op=by_op,
                      n_collectives=len(counter.issued))


# --------------------------------------------------------------------------
# the roofline of a cell
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    device_flops: float
    device_bytes: float
    device_coll_bytes: float
    coll_by_op: dict[str, float]
    peak_mem_bytes: float | None      # None: not measured
    arg_bytes: float
    model_flops: float        # 6*N*D (dense) / 6*N_active*D (MoE), global
    min_bytes: float = 0.0
    peak_flops: float = PEAK_FLOPS
    coll_bw: float = NVLINK_BYTES_PER_S
    coll_link: str = "nvlink4"

    @property
    def t_compute(self) -> float:
        return self.device_flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.device_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.device_coll_bytes / self.coll_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_seconds(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_min_bytes(self) -> float:
        return self.min_bytes / HBM_BW

    @property
    def bound_s(self) -> float:
        return max(self.t_compute, self.t_min_bytes)

    @property
    def bound_by(self) -> str:
        return ("operations" if self.t_compute >= self.t_min_bytes
                else "bytes")

    def useful_flops_ratio(self, n_devices: int) -> float:
        global_flops = self.device_flops * n_devices
        return self.model_flops / global_flops if global_flops else 0.0

    def as_dict(self, n_devices: int) -> dict[str, Any]:
        return dict(
            arch=self.arch, shape=self.shape, mesh=self.mesh,
            device_flops=self.device_flops, device_bytes=self.device_bytes,
            device_coll_bytes=self.device_coll_bytes,
            coll_by_op=self.coll_by_op,
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            peak_mem_gb=(None if self.peak_mem_bytes is None
                         else self.peak_mem_bytes / 1e9),
            arg_gb=self.arg_bytes / 1e9,
            model_flops=self.model_flops,
            useful_flops_ratio=self.useful_flops_ratio(n_devices),
            min_bytes=self.min_bytes, t_min_bytes=self.t_min_bytes,
            peak_flops=self.peak_flops, bound_s=self.bound_s,
            bound_by=self.bound_by, coll_bw=self.coll_bw,
            coll_link=self.coll_link,
        )


def model_flops_for(arch: str, shape_name: str,
                    batch: int | None = None) -> float:
    """6*N*D with N = (active) params, D = tokens processed by the step
    (``batch``: the rows run, default the shape's global batch)."""
    from repro_torch.configs import base as cfgbase
    if arch == "yadt":
        return 0.0
    cfg = cfgbase.get_config(arch)
    shape = cfgbase.SHAPES[shape_name]
    b = shape.global_batch if batch is None else batch
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    if shape.kind == "train":
        return 6.0 * n * b * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * b * shape.seq_len
    return 2.0 * n * b     # decode: one token per row


def analyze(costs: Costs, *, arch: str, shape: str, mesh_desc: str,
            n_devices: int, peak_mem_bytes: float | None = None,
            arg_bytes: float | None = None, batch: int | None = None
            ) -> Roofline:
    """The :class:`Roofline` of one device of a mesh of ``n_devices``,
    from a count of that device's step (on one card the step; on a mesh
    the partitioned step, each count the device's own), its collectives
    over the mesh's rate (:func:`collective_rate`).  ``arg_bytes``: the
    arguments a device holds (default: the counted ones)."""
    bw, link = collective_rate(n_devices)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_desc,
        device_flops=costs.device_flops, device_bytes=costs.device_bytes,
        device_coll_bytes=costs.coll_bytes, coll_by_op=dict(costs.coll_by_op),
        peak_mem_bytes=peak_mem_bytes,
        arg_bytes=costs.arg_bytes if arg_bytes is None else arg_bytes,
        model_flops=model_flops_for(arch, shape, batch),
        min_bytes=costs.min_bytes,
        peak_flops=FP32_OPS_PER_S if arch == "yadt" else PEAK_FLOPS,
        coll_bw=bw, coll_link=link)
