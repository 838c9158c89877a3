"""Counted aten ops for the roofline on the H100 (counterpart of
``repro/distributed/hlo_analysis.py``).

The reference parses XLA's optimized HLO. Eager PyTorch has no program
text, so ``analyze(fn, *args, **kw)`` runs ``fn`` under a
``TorchDispatchMode`` (``OpCounter``) that sees every aten op ``fn``
dispatches, autograd's backward and the optimizer's update included, and
counts with the reference's rules:

- dot FLOPs: 2 * prod(result) * K for the matrix products (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``, ``mv``, ``addmv``, ``dot``:
  what ``matmul``, ``linear`` and ``einsum`` decompose to), by the
  operands' dtype; the bias add of ``addmm`` / ``baddbmm`` / ``addmv``
  counts as elementwise, as XLA's separate add does;
- elementwise FLOPs: the result's elements for an arithmetic op (a
  foreach op: summed over its list; a fused op such as ``_softmax`` once),
  the input's elements for a reduction;
- HBM bytes: operand bytes plus result bytes of every op, with views,
  allocations and metadata ops free (the reference's ``_SKIP_MEM``).
  Eager PyTorch fuses nothing, so every op is top-level: the count is the
  unfused program's traffic, above what a fused program moves;
- collectives: the port's own gather
  (``distributed/sharding.py::gather_block``) notes each all-gather and
  its operand bytes here (``note_collective``), as the reference sums
  operand sizes (an all-reduce twice). The functional collectives
  (``_c10d_functional``: what ``DTensor`` and ``nn/moe_ep.py`` issue)
  reach the mode and count by kind with their operand bytes;
- ``DTensor``s: an op on ``DTensor``s is not counted itself; it runs on
  each rank's local blocks, and those local ops count (the mode steps
  aside for the ``DTensor`` op, ``NotImplemented``, and sees what it
  dispatches). The ops DTensor runs on meta tensors or in a fake-tensor
  mode of its own to propagate shardings are not the program's work and
  are left out;
- kernel launches: a call into the port's CUDA kernels is opaque, as a
  Pallas custom-call is to the reference: it counts in
  ``custom_call_count`` (the launch counters of ``kernels/aip_step.py``)
  and adds no FLOPs. On the CPU the kernels' plain versions run
  (``kernels/ops.py`` dispatches on the tensor's device), and their ops
  count.

Loops: eager PyTorch dispatches every op of every iteration, so what
runs under the counter counts every iteration by construction (a horizon
of T ticks counts T bodies; the reference multiplies a while body's count
by its trip count, ``_trip_count``). That makes a deep program slow to
count, so the LM dry-run (``launch/dryrun.py``, "Loops") runs its cells
at a few trip counts of the loops the reference scans over (layer
groups, encoder layers, microbatches) and extrapolates, exactly; the
IALS cells and the loops over the sequence count every iteration. Ops
outside the ``aten`` namespace are not counted. All numbers are one
process's: a rank's, on its block.

``roofline`` keeps the reference's keys and formulas with the H100's
peaks (NVIDIA's data sheet, SXM part, dense, at the 700 W limit).
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the card's peaks: the port pins IEEE fp32 (TF32 off), so f32 products
# run on the CUDA cores; bf16 / fp16 ones on the tensor cores
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
HBM_BW = 3.35e12          # bytes/s, HBM3
# collectives: NVLink 4 within an 8-card node, 450 GB/s a direction (18
# links of 25 GB/s); beyond a node one 400 Gb/s NIC a card, ~50 GB/s
NVLINK_BW = 450e9
NVLINK_CARDS = 8
NIC_BW = 50e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
        "vdot"}
_BIASED_DOTS = {"addmm", "baddbmm", "addbmm", "addmv"}
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "true_divide", "floor_divide",
    "maximum", "minimum", "fmax", "fmin", "pow", "exp", "exp2", "expm1",
    "log", "log2", "log10", "log1p", "tanh", "sigmoid", "neg", "abs",
    "sqrt", "rsqrt", "reciprocal", "square", "sign", "floor", "ceil",
    "round", "trunc", "frac", "atan2", "remainder", "fmod", "where",
    "masked_fill", "clamp", "clamp_min", "clamp_max", "relu", "lerp",
    "addcmul", "addcdiv", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "__and__", "__or__",
    "__xor__", "__lshift__", "__rshift__", "threshold_backward",
    "tanh_backward", "sigmoid_backward", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
}
REDUCTIONS = {"sum", "mean", "prod", "amax", "amin", "argmax", "argmin",
              "max", "min", "std", "var", "std_mean", "var_mean", "any",
              "all", "norm", "linalg_vector_norm", "logsumexp", "cumsum",
              "cumprod", "topk"}
# allocations and metadata: no bytes move (views are found from the
# schema: a result that aliases an input without writing it)
FREE = {"empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "_unsafe_view", "lift_fresh", "sym_size",
        "sym_stride", "sym_numel", "sym_storage_offset"}


def peak_flops(dtype) -> float:
    """The card's peak for products of ``dtype`` (a ``torch.dtype`` or
    its name): the bf16 / fp16 tensor-core rate, else the fp32 rate of
    the CUDA cores."""
    name = str(dtype).replace("torch.", "")
    return (PEAK_BF16_FLOPS if name in ("bfloat16", "float16")
            else PEAK_FP32_FLOPS)


def collective_bw(n_chips: int) -> float:
    """Bytes/s a card moves in a collective over ``n_chips`` cards."""
    return NVLINK_BW if n_chips <= NVLINK_CARDS else NIC_BW


try:
    from torch.distributed.tensor import DTensor as _DTENSOR
except ImportError:                     # a build without distributed
    _DTENSOR = None

_active = threading.local()


def _counters() -> list:
    if not hasattr(_active, "stack"):
        _active.stack = []
    return _active.stack


def note_collective(kind: str, operand: torch.Tensor):
    """Count one collective of ``kind`` with ``operand`` (this rank's
    share) into every ``OpCounter`` active on this thread; nothing when
    none is."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    nbytes = operand.numel() * operand.element_size()
    for c in _counters():
        c.collective_bytes[kind] += nbytes * (2.0 if kind == "all-reduce"
                                              else 1.0)
        c.collective_counts[kind] += 1


def _launch_total() -> int:
    """Kernel launches so far: every launch adds one to exactly one
    counter whose name has no "[...]" (those are per-domain or per-route
    copies)."""
    from repro_torch.kernels import aip_step
    return sum(v for k, v in aip_step.LAUNCHES.items() if "[" not in k)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _elems(x) -> int:
    return sum(t.numel() for t in _tensors(x))


_KINDS: Dict[object, tuple] = {}


def _kind(func) -> tuple:
    """-> (class, base name) of an aten op: class one of "free", "dot",
    "elementwise", "reduction", "move"."""
    hit = _KINDS.get(func)
    if hit is not None:
        return hit
    name = func.overloadpacket.__name__
    base = name[len("_foreach_"):] if name.startswith("_foreach_") else name
    if base.endswith("_") and not base.endswith("__"):
        base = base[:-1]                               # in place
    view = any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)
    if view or base in FREE:
        cls = "free"
    elif base in DOTS:
        cls = "dot"
    elif base in ("max", "min") and func._overloadname == "other":
        cls = "elementwise"
    elif base in ELEMENTWISE:
        cls = "elementwise"
    elif base in REDUCTIONS:
        cls = "reduction"
    else:
        cls = "move"                # copies, gathers, fills, draws
    _KINDS[func] = (cls, base)
    return _KINDS[func]


def _dot_flops(base, args, out) -> tuple:
    """-> (FLOPs, the operands' dtype name) of one matrix product."""
    lhs = args[1] if base in _BIASED_DOTS else args[0]
    dtype = str(lhs.dtype).replace("torch.", "")
    if base in ("dot", "vdot"):
        return 2.0 * lhs.numel(), dtype
    k = lhs.shape[-1]
    if base == "addbmm":          # (b, n, k) x (b, k, m) summed over b
        return 2.0 * out.numel() * lhs.shape[0] * k, dtype
    return 2.0 * out.numel() * k, dtype


# functional collectives -> the reference's collective kinds
FUNCTIONAL_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}


def _foreign(x, fake_mode) -> bool:
    """A tensor of DTensor's sharding propagation: on the meta device, or
    fake in a mode other than the counted run's own."""
    if not isinstance(x, torch.Tensor):
        return False
    if x.device.type == "meta":
        return True
    mode = getattr(x, "fake_mode", None)
    return mode is not None and mode is not fake_mode


_PROPAGATION = ("_propagate_tensor_meta_non_cached",)
_patched = {}


def _hide_propagation(on: bool):
    """While a counter is active, mark the ops DTensor runs to propagate
    tensor metadata (global shapes, in the active fake-tensor mode when
    there is one) so that no counter counts them."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:
        return
    if on:
        _patched["depth"] = _patched.get("depth", 0) + 1
        if _patched["depth"] > 1:
            return
        for name in _PROPAGATION:
            orig = getattr(ShardingPropagator, name, None)
            if orig is None:
                continue

            def hidden(self, *a, _orig=orig, **k):
                _active.propagating = getattr(_active, "propagating", 0) + 1
                try:
                    return _orig(self, *a, **k)
                finally:
                    _active.propagating -= 1
            _patched[name] = orig
            setattr(ShardingPropagator, name, hidden)
        return
    _patched["depth"] -= 1
    if _patched["depth"]:
        return
    for name in _PROPAGATION:
        if name in _patched:
            setattr(ShardingPropagator, name, _patched.pop(name))


class OpCounter(TorchDispatchMode):
    """A dispatch mode that counts every aten op run inside it (module
    docstring); ``result()`` reads the counts in the reference's keys.
    With ``record=True`` it also keeps, by (op, operand shapes), the
    HBM bytes, FLOPs and collective bytes (``rows()``: what
    ``launch/attribute.py`` ranks)."""

    def __init__(self, record: bool = False):
        super().__init__()
        self.record = record
        self._rows = defaultdict(lambda: [0.0, 0.0, 0.0, 0])
        self._fake_mode = None
        self.flops_dot = 0.0
        self.flops_dot_by_dtype = defaultdict(float)
        self.flops_elementwise = 0.0
        self.hbm_bytes = 0.0
        self.n_ops = 0
        self.collective_bytes = defaultdict(float)
        self.collective_counts = defaultdict(float)
        self.custom_call_count = 0
        self._launches0 = 0

    def __enter__(self):
        _hide_propagation(True)
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
        modes = [m for m in _get_current_dispatch_mode_stack()
                 if isinstance(m, FakeTensorMode)]
        self._fake_mode = modes[-1] if modes else None
        self._launches0 = _launch_total()
        _counters().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _hide_propagation(False)
        _counters().remove(self)
        self.custom_call_count += _launch_total() - self._launches0
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR)
                                        for t in types):
            return NotImplemented      # count its local ops instead
        out = func(*args, **kwargs)
        if func.namespace not in ("aten", "_c10d_functional") \
                or getattr(_active, "propagating", 0):
            return out
        if any(_foreign(t, self._fake_mode)
               for t in _tensors([args, kwargs])):
            return out
        if func.namespace == "aten":
            self._count(func, args, kwargs, out)
        else:
            self._collective(func, args)
        return out

    def _collective(self, func, args):
        kind = FUNCTIONAL_COLLECTIVES.get(func.overloadpacket.__name__)
        if kind is None:                # wait_tensor and the like
            return
        nbytes = _bytes(args[0])
        self.collective_bytes[kind] += nbytes * (2.0 if kind == "all-reduce"
                                                 else 1.0)
        self.collective_counts[kind] += 1
        self._row(func, args, coll=nbytes * (2.0 if kind == "all-reduce"
                                             else 1.0))

    def _row(self, func, args, mem=0.0, flops=0.0, coll=0.0):
        if not self.record:
            return
        shapes = tuple(tuple(t.shape) for t in _tensors(args))[:3]
        r = self._rows[(func.overloadpacket.__name__, shapes)]
        r[0] += mem
        r[1] += flops
        r[2] += coll
        r[3] += 1

    def rows(self):
        """[(op, operand shapes, hbm bytes, flops, collective bytes,
        calls)] of a ``record=True`` count."""
        return [(k[0], k[1], *v) for k, v in self._rows.items()]

    def _count(self, func, args, kwargs, out):
        cls, base = _kind(func)
        self.n_ops += 1
        if cls == "free":
            return
        if out is None:                 # an in-place foreach op
            out = args[0]
        flops = 0.0
        if cls == "dot":
            f, dtype = _dot_flops(base, args, out)
            self.flops_dot += f
            self.flops_dot_by_dtype[dtype] += f
            flops = f
            if base in _BIASED_DOTS:
                self.flops_elementwise += out.numel()
                flops += out.numel()
        elif cls == "elementwise":
            flops = _elems(out)
            self.flops_elementwise += flops
        elif cls == "reduction":
            flops = _elems(args[0])
            self.flops_elementwise += flops
        mem = _bytes(args) + _bytes(kwargs) + _bytes(out)
        self.hbm_bytes += mem
        self._row(func, args, mem=mem, flops=flops)

    def result(self) -> Dict:
        return {
            "flops": self.flops_dot + self.flops_elementwise,
            "flops_dot": self.flops_dot,
            "flops_dot_by_dtype": dict(self.flops_dot_by_dtype),
            "flops_elementwise": self.flops_elementwise,
            "custom_call_count": self.custom_call_count,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "collective_bytes_total": float(sum(
                self.collective_bytes.values())),
            "n_ops": self.n_ops,
        }


def analyze(fn, *args, **kw) -> Dict:
    """Run ``fn(*args, **kw)`` under an ``OpCounter`` -> its counts:
    ``flops``, ``flops_dot`` (and ``flops_dot_by_dtype``),
    ``flops_elementwise``, ``custom_call_count``, ``hbm_bytes``,
    ``collective_bytes`` / ``collective_counts`` by kind,
    ``collective_bytes_total`` and ``n_ops`` (the reference's
    ``n_computations``)."""
    with OpCounter() as counter:
        fn(*args, **kw)
    return counter.result()


def roofline(analysis: Dict, n_chips: int,
             model_flops: float | None = None) -> Dict[str, float]:
    """The reference's roofline terms on the card. Every number in
    ``analysis`` is one rank's already. The compute term takes each dot
    dtype's FLOPs at its peak (``peak_flops``) and elementwise FLOPs at
    the fp32 rate; the collective term the NVLink rate up to 8 cards,
    the NIC rate beyond."""
    by = analysis.get("flops_dot_by_dtype") or {
        "float32": analysis["flops_dot"]}
    t_compute = (sum(f / peak_flops(d) for d, f in by.items())
                 + analysis["flops_elementwise"] / PEAK_FP32_FLOPS)
    t_memory = analysis["hbm_bytes"] / HBM_BW
    t_coll = analysis["collective_bytes_total"] / collective_bw(n_chips)
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    peak = peak_flops(max(by, key=by.get) if by else "float32")
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dominant,
        "step_time_lower_bound_s": max(t_compute, t_memory, t_coll),
        "peak_flops": peak,
    }
    if model_flops:
        out["model_flops_total"] = model_flops
        out["useful_flops_ratio"] = \
            model_flops / max(analysis["flops"] * n_chips, 1.0)
        out["mfu_upper_bound"] = (model_flops / n_chips / peak) / \
            max(out["step_time_lower_bound_s"], 1e-12)
    return out
