"""Fused momentum-SGD update + SpecTrain prediction: the wrapper around
the Hopper CUDA kernel.

Twin of ``repro/kernels/fused_update.py`` (the Pallas TPU kernel).  The
kernel itself is ``csrc/fused_update.cu``; its source note says what it
computes, what bounds it on an H100 and what its simple design leaves
for later.  Where the Pallas kernel takes one flat array and returns new
ones, this wrapper takes a group of tensors sharing ``(lr, gamma, s)``
(a stage's parameter tree, or the outer tree) and updates them **in
place** in one launch: ``w`` and ``v`` are overwritten with ``w'`` and
``v'``, and each ``ŵ`` given is overwritten with the prediction.

On CUDA tensors :func:`fused_update` launches the kernel or raises; on
CPU tensors it computes :func:`repro_torch.kernels.ref.fused_update_ref`
and copies the results into the same tensors.  On ``meta`` tensors
(shapes only: the dry-run and the cost counter) it runs the CUDA
route's checks and launches nothing (no launch is counted).  On
``cuda`` and ``meta`` each group records :func:`cost` with an active
``runtime.op_cost.CostCounter``; any other device raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_update_ref
from repro_torch.runtime.op_cost import record_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the most non-empty tensors one launch takes (the kernel's table;
# ``repro_fused_update_max_tensors`` of the library, checked at load)
MAX_TENSORS = 64

# kernel launches since the last reset (the CPU path never counts)
launches = 0

_p = ctypes.c_void_p
_ARGTYPES = [_p, _p, _p, _p, _p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_double, ctypes.c_double, ctypes.c_double, _p]


def _lib():
    lib = build.library("fused_update")
    fn = lib.repro_fused_update
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.repro_fused_update_max_tensors.restype = ctypes.c_int
        if lib.repro_fused_update_max_tensors() != MAX_TENSORS:
            raise RuntimeError(
                f"the fused_update library takes "
                f"{lib.repro_fused_update_max_tensors()} tensors a launch, "
                f"the wrapper expects {MAX_TENSORS}")
    return fn


def load() -> None:
    """Build (at first use) and load the kernel's library."""
    _lib()


def cost(n: int, n_pred: int = 0, *, g_el: int = 4, what_el: int = 4
         ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one launch over ``n`` elements, ``n_pred`` of
    them with a prediction: w and v read and w', v' written in fp32, g
    read at ``g_el`` bytes and ŵ written at ``what_el``; 3 FLOPs for v'
    (two products and a sum), 2 for w' and 2 for ŵ an element."""
    return 5 * n + 2 * n_pred, 16 * n + g_el * n + what_el * n_pred


def _pairs_cost(pairs) -> Tuple[int, int]:
    """:func:`cost` of one launch over ``(w, v, g, ŵ)`` tuples."""
    wh_el = next((wh.element_size() for *_, wh in pairs if wh is not None),
                 4)
    return cost(sum(w.numel() for w, *_ in pairs),
                sum(w.numel() for w, *_, wh in pairs if wh is not None),
                g_el=pairs[0][2].element_size(), what_el=wh_el)


def _check(ws, vs, gs, whats) -> None:
    if not (len(ws) == len(vs) == len(gs) == len(whats)) or not ws:
        raise ValueError(f"w, v, g, ŵ lists differ in length or are empty: "
                         f"{len(ws)}, {len(vs)}, {len(gs)}, {len(whats)}")
    dev = ws[0].device
    g_dt = gs[0].dtype
    w_dts = {wh.dtype for wh in whats if wh is not None}
    if len(w_dts) > 1:
        raise TypeError(f"the ŵ tensors of one group differ in dtype: "
                        f"{w_dts}")
    for i, (w, v, g, wh) in enumerate(zip(ws, vs, gs, whats)):
        if w.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError(f"tensor {i}: w and v must be fp32, got "
                            f"{w.dtype}, {v.dtype}")
        if g.dtype not in _DTYPES or g.dtype != g_dt:
            raise TypeError(f"tensor {i}: g must be one of {tuple(_DTYPES)} "
                            f"and the group's {g_dt}, got {g.dtype}")
        if wh is not None and wh.dtype not in _DTYPES:
            raise TypeError(f"tensor {i}: ŵ must be one of "
                            f"{tuple(_DTYPES)}, got {wh.dtype}")
        for name, t in (("v", v), ("g", g), ("ŵ", wh)):
            if t is not None and t.shape != w.shape:
                raise ValueError(f"tensor {i}: {name} {tuple(t.shape)} != "
                                 f"w {tuple(w.shape)}")
        for t in (w, v, g, wh):
            if t is not None and t.device != dev:
                raise ValueError(f"tensor {i} is on {t.device}, the group "
                                 f"on {dev}")


def fused_update(ws: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                 gs: Sequence[torch.Tensor], *, lr: float, gamma: float,
                 s: float = 0.0,
                 whats: Optional[Sequence[Optional[torch.Tensor]]] = None
                 ) -> None:
    """In place, for every i: ``vs[i] <- gamma vs[i] + (1 - gamma) gs[i]``,
    ``ws[i] <- ws[i] - lr vs[i]`` and, where ``whats[i]`` is a tensor,
    ``whats[i] <- ws[i] - (s lr) vs[i]``.  w and v are fp32; g is fp32 or
    bf16 (one dtype per group); ŵ is fp32 or bf16.  On CUDA one launch
    covers the group; a group of more non-empty tensors than the
    kernel's table holds (64) raises."""
    ws, vs, gs = list(ws), list(vs), list(gs)
    whats = [None] * len(ws) if whats is None else list(whats)
    _check(ws, vs, gs, whats)
    dev = ws[0].device
    if dev.type == "cpu":
        for w, v, g, wh in zip(ws, vs, gs, whats):
            w2, v2, wh2 = fused_update_ref(
                w, v, g, lr=lr, gamma=gamma, s=s,
                what_dtype=None if wh is None else wh.dtype)
            w.copy_(w2)
            v.copy_(v2)
            if wh is not None:
                wh.copy_(wh2)
        return
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"fused_update runs on cuda, meta or cpu, not "
                         f"{dev}")
    for i, t in enumerate(ws + vs + gs
                         + [wh for wh in whats if wh is not None]):
        if not t.is_contiguous():
            raise ValueError(f"fused_update needs contiguous tensors "
                             f"(argument {i} has strides {t.stride()})")
    pairs = [(w, v, g, wh) for w, v, g, wh in zip(ws, vs, gs, whats)
             if w.numel()]
    if len(pairs) > MAX_TENSORS:
        raise ValueError(f"fused_update takes at most {MAX_TENSORS} "
                         f"non-empty tensors in one group, got {len(pairs)}")
    if not pairs:
        return
    record_kernel("fused_update", _pairs_cost, pairs)
    if dev.type == "meta":
        return
    fn = _lib()
    n = len(pairs)
    arr = lambda xs: (ctypes.c_void_p * n)(*xs)
    g_dt = _DTYPES[gs[0].dtype]
    w_dt = next((_DTYPES[wh.dtype] for wh in whats if wh is not None), 0)
    global launches
    with torch.cuda.device(dev):
        err = fn(arr([w.data_ptr() for w, _, _, _ in pairs]),
                 arr([v.data_ptr() for _, v, _, _ in pairs]),
                 arr([g.data_ptr() for _, _, g, _ in pairs]),
                 arr([wh.data_ptr() if wh is not None else None
                      for _, _, _, wh in pairs]),
                 (ctypes.c_longlong * n)(*[w.numel()
                                           for w, _, _, _ in pairs]),
                 n, g_dt, w_dt, float(lr), float(gamma), float(s),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_update launch failed: CUDA error {err}")
    launches += 1
