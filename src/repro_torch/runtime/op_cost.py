"""Op-counting cost model of eager PyTorch: the port's twin of
``repro/runtime/hlo_cost.py``.

The JAX package compiles a step and walks the compiled HLO: dots at
2·M·N·K, elementwise and reduction approximations, operand + result
bytes at fusion boundaries, and ring-model wire bytes for collectives.
The port has no compiled module, so :class:`CostCounter` (a
``TorchDispatchMode``) sees every ATen op as it runs and accumulates
the same quantities under the same keys (``flops``, ``bytes``,
``bytes_fused``, ``transcendentals``, ``collectives``, ``wire_bytes``),
with the counting rules of ``hlo_cost.py`` as far as eager PyTorch
allows:

* **views** (``view``, ``transpose``, ``expand``, ``slice``, ``select``,
  ``as_strided``, ``detach``, ``alias``, ...: every op whose schema says
  its output aliases its input) and allocations that launch nothing
  (``empty``) cost nothing;
* **matrix products** (``mm``, ``bmm``, ``addmm``, ``baddbmm``: what
  ``linear``, ``matmul`` and ``einsum`` decompose into before they reach
  the dispatcher) cost 2·M·N·K, batched (:data:`MATMUL_OPS`; their sum
  is also kept apart as ``matmul_flops``);
* **elementwise ops** cost one FLOP per output element, weighted by
  :data:`ELEMENTWISE_FLOP` (``hlo_cost._ELEMENTWISE_FLOP``'s weights
  under the ATen names); **transcendentals** (:data:`TRANSCENDENTAL`)
  count in both ``flops`` and ``transcendentals``;
* **reductions** count their input elements;
* **bytes** are the operand bytes plus the result bytes of every op
  that launches (a copy's destination counts once, written).  In eager
  mode every such op is its own trip to HBM, so ``bytes_fused``, the
  JAX twin's estimate of what XLA:TPU fusion leaves, equals ``bytes``
  here; the key is kept so that a record reads like the JAX twin's;
* **collectives** that reach the dispatcher (the ``c10d`` all-reduce,
  all-gather, reduce-scatter, send and recv) get ``hlo_cost.py``'s
  ring-model wire bytes, with n the process group's size.

The hand-written kernels are called through ``ctypes``, so the
dispatcher never sees them: each kernel wrapper (``kernels/
flash_attention.py``, ``fused_update.py``, ``rwkv6_scan.py``,
``mamba2_scan.py``) calls :func:`record_kernel` where it launches (on
``cuda``) or where its meta route returns (on ``meta``), with its
module's ``cost(...)`` formula (the same one ``chip_smoke.py``'s bounds
use).  Each record adds the call to ``kernels`` (calls, flops, bytes of
each kernel) and to the totals.  On the CPU the wrappers run their
plain versions, whose ATen ops the counter sees instead.

``memory`` follows the JAX dry-run's ``memory_analysis`` keys
(``argument_bytes``, ``output_bytes``, ``temp_bytes``,
``alias_bytes``): ``temp_bytes`` is the high-water mark of the live
bytes the counted code allocated (each new output storage is tracked by
a weakref finalizer until it is freed), the others come from the
argument and output trees given to :meth:`CostCounter.memory`.

Counting on the ``meta`` device (no data, nothing allocated) gives the
same totals as counting the same code on the card, op for op, as long
as the code takes no data-dependent branch; ``by_op`` keeps each ATen
op's calls, flops and bytes so that two counts can be told apart op by
op (:func:`op_differences`).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


# ---------------------------------------------------------------------------
# the op tables (ATen overload-packet names)

MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm", "addbmm")

# hlo_cost._ELEMENTWISE_FLOP under the ATen names; an elementwise op not
# listed costs 1 a result element, as there
ELEMENTWISE_FLOP = {
    "add": 1, "add_": 1, "sub": 1, "sub_": 1, "rsub": 1, "mul": 1,
    "mul_": 1, "div": 1, "div_": 1, "neg": 1, "maximum": 1, "minimum": 1,
    "abs": 1, "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1,
    "where": 1, "logical_and": 1, "logical_or": 1, "logical_xor": 1,
    "logical_not": 1, "bitwise_and": 1, "bitwise_or": 1, "bitwise_xor": 1,
    "bitwise_not": 1, "clamp": 2, "clamp_": 2, "clamp_min": 1,
    "clamp_max": 1, "floor": 1, "ceil": 1, "round": 1, "sign": 1,
    "remainder": 1, "fmod": 1, "pow": 1, "atan2": 1, "isfinite": 1,
    "reciprocal": 1, "masked_fill": 1, "masked_fill_": 1, "addcmul": 2,
    "addcmul_": 2, "addcdiv": 2, "addcdiv_": 2, "lerp": 2, "lerp_": 2,
}
# (flops, transcendentals) a result element; hlo_cost._TRANSCENDENTAL's
# ops under the ATen names count (1, 1); the fused activations and
# softmax count what XLA expands them into
TRANSCENDENTAL = {
    "exp": (1, 1), "exp_": (1, 1), "exp2": (1, 1), "log": (1, 1),
    "log2": (1, 1), "log10": (1, 1), "tanh": (1, 1), "rsqrt": (1, 1),
    "sqrt": (1, 1), "sigmoid": (1, 1), "sin": (1, 1), "cos": (1, 1),
    "erf": (1, 1), "expm1": (1, 1), "log1p": (1, 1), "tan": (1, 1),
    "silu": (2, 1), "gelu": (8, 1), "softplus": (3, 2), "elu": (3, 1),
    "selu": (4, 1), "silu_backward": (5, 1), "gelu_backward": (14, 2),
    "softplus_backward": (4, 1), "elu_backward": (3, 1),
    "tanh_backward": (3, 0), "sigmoid_backward": (3, 0),
    "_softmax": (5, 1), "_log_softmax": (5, 1),
    "_softmax_backward_data": (4, 0), "_log_softmax_backward_data": (4, 1),
}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
              "linalg_vector_norm", "argmax", "argmin", "var", "std",
              "var_mean", "std_mean", "logsumexp", "any", "all", "cumsum",
              "cumprod", "topk", "sort", "nll_loss_forward",
              "nll_loss_backward", "nll_loss2d_forward"}
# ops that move or fill data: bytes, no flops
MOVES = {"copy_", "_to_copy", "clone", "cat", "stack", "index",
         "index_select", "gather", "scatter", "scatter_", "scatter_add",
         "scatter_add_", "index_put", "index_put_", "index_add",
         "index_add_", "index_copy", "index_copy_", "embedding",
         "embedding_dense_backward", "repeat", "repeat_interleave",
         "fill_", "fill", "zero_", "zeros", "zeros_like", "ones",
         "ones_like", "full", "full_like", "new_zeros", "new_ones",
         "new_full", "constant_pad_nd", "flip", "roll", "tril", "triu",
         "one_hot", "arange", "masked_select", "_unsafe_index",
         "_unsafe_index_put", "select_scatter", "slice_scatter",
         "as_strided_scatter", "_reshape_copy", "lift_fresh_copy",
         "randn", "rand", "normal_", "uniform_", "bernoulli_",
         "random_", "_local_scalar_dense", "scalar_tensor"}
# ops that launch nothing
FREE = {"empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
        "resize_", "_has_compatible_shallow_copy_type", "sym_size",
        "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
        "record_stream", "_efficientzerotensor"}
# the c10d ops and their ring-model wire bytes (hlo_cost.py's rules):
# (name in the schema, kind)
COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
               "_allgather_base_": "all-gather",
               "allgather_into_tensor_coalesced_": "all-gather",
               "reduce_scatter_": "reduce-scatter",
               "_reduce_scatter_base_": "reduce-scatter",
               "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
               "send": "collective-permute", "recv_": "collective-permute",
               "broadcast_": "collective-permute"}


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of every distinct storage the tensors of a tree hold."""
    seen: Dict[int, int] = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def ring_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """``hlo_cost.py``'s ring-model bytes on the wire per device."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-gather":
        return result_bytes * frac
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * frac
    return float(result_bytes)


def _group_size(args) -> int:
    for a in args:
        size = getattr(a, "size", None)
        if callable(size) and not isinstance(a, torch.Tensor):
            try:
                return int(size())
            except Exception:       # noqa: BLE001 - not a process group
                continue
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 2


def _matmul_flops(name: str, args, out) -> float:
    """2·M·N·K of a product (batched), from the operands' shapes."""
    if name in ("mm", "bmm"):
        a = args[0]
    elif name in ("addmm", "baddbmm", "addbmm"):
        a = args[1]
    else:
        raise KeyError(name)
    k = a.shape[-1]
    return 2.0 * out.numel() * k if name != "addbmm" \
        else 2.0 * a.shape[0] * out.numel() * k


# ---------------------------------------------------------------------------
# the active counters: the kernel wrappers record into the innermost

_ACTIVE: List["CostCounter"] = []


def active() -> Optional["CostCounter"]:
    """The innermost :class:`CostCounter` that is counting, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, cost, *args, **kw) -> None:
    """Record one call of the hand-written kernel ``name`` at
    ``cost(*args, **kw)`` -> (FLOPs, bytes); a no-op (``cost`` is not
    called) when no counter is active."""
    c = active()
    if c is not None:
        c.add_kernel(name, *cost(*args, **kw))


class CostCounter(TorchDispatchMode):
    """Counts what runs under it (see the module note).  Use as a context
    manager; read :meth:`result` after it exits."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.matmul_flops = 0.0
        self.coll: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.by_op: Dict[str, List[float]] = {}
        self._live: Dict[int, int] = {}
        self._cur = 0
        self.peak = 0

    # ----------------------------------------------------------- context
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ----------------------------------------------------------- kernels
    def add_kernel(self, name: str, flops: float, nbytes: float,
                   transcendentals: float = 0.0) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)
        self.flops += float(flops)
        self.bytes += float(nbytes)
        self.transcendentals += float(transcendentals)

    # ------------------------------------------------------------ memory
    def _free(self, key: int) -> None:
        self._cur -= self._live.pop(key, 0)

    def _track(self, args, out) -> None:
        """Count each new storage among the outputs as allocated until
        its last tensor dies."""
        inputs = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._cur += n
            self.peak = max(self.peak, self._cur)
            weakref.finalize(st, self._free, key)

    def memory(self, arguments=None, outputs=None) -> Dict[str, float]:
        """The JAX dry-run's memory keys: the arguments' and outputs'
        bytes (distinct storages), the high-water mark of the bytes
        allocated while counting, and the outputs' bytes that alias
        arguments (the port's train steps update their state in
        place)."""
        arg = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
               for t in _tensors(arguments)}
        out = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
               for t in _tensors(outputs)}
        return {"argument_bytes": float(sum(arg.values())),
                "output_bytes": float(sum(out.values())),
                "temp_bytes": float(self.peak),
                "alias_bytes": float(sum(n for k, n in out.items()
                                         if k in arg))}

    # ----------------------------------------------------------- counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _op(self, name: str, flops: float, nbytes: float,
            trans: float = 0.0) -> None:
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        rec[3] += trans
        self.flops += flops
        self.bytes += nbytes
        self.transcendentals += trans

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._overloadpacket.__name__ if hasattr(
            func, "_overloadpacket") else str(func)
        if ns == "c10d":
            self._collective(name, args, out)
            return
        if ns != "aten":
            return
        if getattr(func, "is_view", False):
            return
        self._track((args, kwargs), out)       # empty() allocates too
        if name in FREE:
            return
        outs = list(_tensors(out))
        ins = list(_tensors((args, kwargs)))
        if name == "copy_":            # the destination is only written
            ins = ins[1:]
        nbytes = float(sum(_nbytes(t) for t in ins)
                       + sum(_nbytes(t) for t in outs))
        relems = float(sum(t.numel() for t in outs))
        if name in MATMUL_OPS:
            fl = _matmul_flops(name, args, outs[0])
            self.matmul_flops += fl
            self._op(name, fl, nbytes)
        elif name in TRANSCENDENTAL:
            f, tr = TRANSCENDENTAL[name]
            n = float(outs[0].numel()) if outs else 0.0
            self._op(name, f * n, nbytes, tr * n)
        elif name in REDUCTIONS:
            n = float(ins[0].numel()) if ins else 0.0
            self._op(name, n, nbytes)
        elif name in MOVES:
            self._op(name, 0.0, nbytes)
        else:
            self._op(name, relems * ELEMENTWISE_FLOP.get(name, 1), nbytes)

    def _collective(self, name: str, args, out) -> None:
        kind = COLLECTIVES.get(name)
        if kind is None:
            return
        n = _group_size(args)
        rb = float(sum(_nbytes(t) for t in _tensors(args)))
        if name == "send" or name == "recv_":
            rb = float(sum(_nbytes(t) for t in _tensors(args[0])))
        elif kind == "all-gather":
            rb = float(sum(_nbytes(t) for t in _tensors(args[0])))
        elif kind in ("all-reduce", "reduce-scatter", "all-to-all"):
            rb = float(sum(_nbytes(t) for t in _tensors(args[0])))
        wire = ring_wire_bytes(kind, rb, n)
        d = self.coll.setdefault(kind, {"count": 0.0, "result_bytes": 0.0,
                                        "wire_bytes": 0.0})
        d["count"] += 1
        d["result_bytes"] += rb
        d["wire_bytes"] += wire
        self.bytes += 2.0 * rb

    # ------------------------------------------------------------ result
    @property
    def wire_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.coll.values())

    def result(self) -> Dict[str, Any]:
        """``hlo_cost.analyze``'s keys, plus ``matmul_flops``, ``kernels``
        and ``by_op`` (each ATen op's [calls, flops, bytes,
        transcendentals])."""
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_fused": self.bytes,
                "transcendentals": self.transcendentals,
                "collectives": {k: dict(v) for k, v in self.coll.items()},
                "wire_bytes": self.wire_bytes,
                "matmul_flops": self.matmul_flops,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "by_op": {k: list(v) for k, v in self.by_op.items()}}


def op_differences(a: Dict[str, Any], b: Dict[str, Any]
                   ) -> List[Tuple[str, List[float], List[float]]]:
    """The ops whose [calls, flops, bytes, transcendentals] differ between
    two :meth:`CostCounter.result` records, and the kernels whose calls,
    flops or bytes differ: ``[(name, a's, b's)]``."""
    out = []
    for key in sorted(set(a["by_op"]) | set(b["by_op"])):
        x = a["by_op"].get(key, [0, 0.0, 0.0, 0.0])
        y = b["by_op"].get(key, [0, 0.0, 0.0, 0.0])
        if x != y:
            out.append((key, x, y))
    for key in sorted(set(a["kernels"]) | set(b["kernels"])):
        x = a["kernels"].get(key, {})
        y = b["kernels"].get(key, {})
        if x != y:
            out.append((f"kernel {key}",
                        [x.get(f, 0) for f in ("calls", "flops", "bytes")],
                        [y.get(f, 0) for f in ("calls", "flops", "bytes")]))
    return out

