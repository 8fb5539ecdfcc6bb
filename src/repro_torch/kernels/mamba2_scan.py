"""Mamba-2 SSD recurrence: the wrapper around the Hopper CUDA kernels.

Twin of ``repro/kernels/mamba2_scan.py`` (the Pallas TPU kernel
``mamba2_scan``, body ``_ssd_kernel``).  The kernels are in
``csrc/mamba2_scan.cu``, whose source note says what each computes, what
bounds it on an H100 and what its design does about that.  Unlike the
Pallas kernel, whose in-chunk decay ratios leave fp32's range at small
decays, every kernel here is exact at any decay in [0, 1]; they take the
model-side layouts through strides, read the B/C group of each head by
index instead of repeating B and C per head, and take any s >= 1.
:func:`variant` picks the kernel by s:

  * s = 1: ``ssd_decode_kernel``, one decode step, bound by the bytes of
    the fp32 state (read and written once, float4 a thread);
  * 2 <= s < ``CHUNK_MIN_S``: ``ssd_kernel``, the recurrence step by step
    (the serving paths' short prompts);
  * s >= ``CHUNK_MIN_S``: ``ssd_scores_kernel``, each chunk's [64 x 64]
    decay matrix (running products) and scores for every chunk at once
    (into a scratch tensor the wrapper allocates), then
    ``ssd_chunk_kernel``, the chunks in order, the chunked dual form on
    the tensor cores (3xTF32 ``mma.sync``) (a long prompt).  The pair
    counts as one launch of the chunked variant.

This is routing by shape, not a fallback: each variant is exact and
each raises on what it does not take.  On CUDA tensors
:func:`mamba2_scan` launches its variant or raises; on CPU tensors it
computes :func:`repro_torch.kernels.ref.mamba2_ref`.

:func:`mamba2_scan_bwd` is the recurrence's backward (the training
path's), in ``csrc/mamba2_scan_bwd.cu`` on CUDA tensors, routed by s as
:func:`repro_torch.kernels.rwkv6_scan.bwd_variant` says:

  * s < ``CHUNK_MIN_S``: ``ssd_bwd_kernel``, the steps in reverse, one
    block a (batch row, head);
  * s >= ``CHUNK_MIN_S``: ``ssd_bwd_states_kernel`` (the chunks'
    boundary states and cotangents, a short walk over chunks of 64)
    then ``ssd_bwd_chunk_kernel`` (every chunk's gradients at once, a
    block per (chunk, head, batch row), the products on the tensor
    cores, 3xTF32 ``mma.sync``);

either then ``ssd_bwd_group_kernel`` (dB and dC summed over each group's
heads in head order), all deterministic and counting as one launch (and
one of ``launches_bwd_chunk`` for the chunked variant);
:func:`repro_torch.kernels.ref.mamba2_bwd_ref` on CPU tensors.

On ``meta`` tensors (shapes only: the dry-run and the cost counter)
both functions run the CUDA route's checks and allocations, scratch
included, and launch nothing (no launch is counted).  On ``cuda`` and
``meta`` each call records :func:`cost` / :func:`bwd_cost` with an
active ``runtime.op_cost.CostCounter``; any other device raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_cp_async_alignment
from repro_torch.kernels.ref import mamba2_bwd_ref, mamba2_ref
from repro_torch.kernels.rwkv6_scan import BWD_TILE, CHUNK_MIN_S, \
    bwd_variant, flops_type, recurrence_flops, variant
from repro_torch.runtime.op_cost import record_kernel

HEAD_DIMS = (16, 32, 64)         # for p and for n
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_YZ_MAX = 65535
_VARIANTS = {"step": 0, "decode": 1, "chunk": 2}

# kernel launches since the last reset (the CPU path never counts):
# all variants, and of them the decode and the chunked kernel's
launches = 0
launches_decode = 0
launches_chunk = 0
# backward kernel launches since the last reset (the CPU path never counts):
# all variants, and of them the chunked kernels'
launches_bwd = 0
launches_bwd_chunk = 0

_p = ctypes.c_void_p
_ARGTYPES = ([ctypes.c_int] + [_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 15 + [_p])
# one (batch row, head, chunk) record of the chunked kernel's scores: the
# [64 x 64] score matrix, A_i and T_j dt_j
_RECORD = 64 * 64 + 2 * 64
_BWD_ARGTYPES = ([ctypes.c_int] + [_p] * 17 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 18 + [_p])
_BWD_VARIANTS = {"step": 0, "chunk": 1}


def cost(b: int, s: int, h: int, p: int, n: int, g: int, *, el: int = 2
         ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one :func:`mamba2_scan` call, the work of the
    variant it runs: bytes, every input read once and y and S_T written
    once (x, B, C at ``el`` bytes; dt, decay, y and the states fp32);
    FLOPs, for the decode and stepwise kernels the fp32 recurrence's
    (``rwkv6_scan.recurrence_flops``), for the chunked kernels (s >= 64)
    the chunked form's tensor-core products, each counted once, per step
    and head 4 p n (C S^T, x^T B) + 128 p (the scores times x), and per
    step and B/C group 128 n (C B^T).  ``rwkv6_scan.flops_type`` names
    their type."""
    nbytes = (el * b * s * h * p             # x
              + 4 * b * s * h * p            # y (fp32)
              + 2 * 4 * b * s * h            # dt, decay
              + el * 2 * b * s * g * n       # B, C
              + 2 * 4 * b * h * p * n)       # S0 in, S_T out
    if variant(s) == "chunk":
        return b * s * (h * (4 * p * n + 128 * p) + g * 128 * n), nbytes
    return recurrence_flops(b, s, h, p, n), nbytes


def bwd_chunk_flops(b: int, s: int, h: int, p: int, n: int, *,
                    bf16: bool, passes: bool = False) -> float:
    """Tensor-core FLOPs of the chunked backward (2 a multiply-add;
    with ``passes``, times each product's mma passes, 1 to 3 as 3xTF32
    splits its fp32-derived operands, bf16 operands being exact), per
    (batch row, head, chunk of Q = 64), with tri = Q (Q + 1) / 2: the
    walk's two [p x n] updates over Q steps; C B^T, dy x^T, (C B^T o
    L)^T dy, N B, N^T C over the triangle; B G^T, dy S, x G in full."""
    pa = ((lambda x, y: 1 + (not x) + (not y)) if passes
          else (lambda x, y: 1))                # mma passes
    ex = bf16
    Q = CHUNK_MIN_S
    tri = Q * (Q + 1) // 2
    mac = (2 * p * n * Q * pa(False, ex)
           + tri * n * pa(ex, ex) + tri * p * pa(False, ex)
           + tri * p * pa(False, False)
           + 2 * tri * n * pa(False, ex)
           + Q * n * p * (pa(ex, False) + pa(False, False)
                          + pa(ex, False)))
    return 2.0 * mac * b * h * -(-s // Q)


def bwd_cost(b: int, s: int, h: int, p: int, n: int, g: int, *,
             el: int = 2) -> Tuple[float, int]:
    """(FLOPs, bytes) of one :func:`mamba2_scan_bwd` call: bytes, every
    input read once and every gradient written once; FLOPs, s < 64 (the
    stepwise kernels) the fp32 operations, per step and state entry 14:
    the state recomputed (3), the cotangent's update (+ dy C and x
    decay, 3) and four products summed (dC, G B, dB, ddecay); s >= 64
    the chunked form's tensor-core products, each counted once
    (:func:`bwd_chunk_flops`)."""
    nbytes = (2 * el * b * s * h * p         # x, dx
              + 4 * b * s * h * p            # dy (fp32)
              + 4 * 4 * b * s * h            # dt, decay, and grads
              + 4 * el * b * s * g * n       # B, C, dB, dC
              + 3 * 4 * b * h * p * n)       # S0, dS_T, dS0
    if bwd_variant(s) == "step":
        return 14 * b * s * h * p * n, nbytes
    return bwd_chunk_flops(b, s, h, p, n, bf16=el == 2), nbytes


def _lib():
    fn = build.library("mamba2_scan").repro_mamba2_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def chunk_smem_bytes(dtype: torch.dtype, n: int, scores: bool = False
                     ) -> int:
    """Dynamic shared memory of one ``ssd_chunk_kernel`` block, or with
    ``scores`` of one ``ssd_scores_kernel`` block."""
    fn = build.library("mamba2_scan").repro_mamba2_scan_chunk_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(_DTYPES[dtype], n, int(scores)))


def _bwd_lib():
    fn = build.library("mamba2_scan_bwd").repro_mamba2_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def bwd_smem_bytes(p: int, n: int, dtype: torch.dtype = None) -> int:
    """Dynamic shared memory of one ``ssd_bwd_kernel`` block, or with
    ``dtype`` of one ``ssd_bwd_chunk_kernel`` block."""
    lib = build.library("mamba2_scan_bwd")
    if dtype is None:
        fn = lib.repro_mamba2_scan_bwd_smem_bytes
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_longlong
        return int(fn(p, n))
    fn = lib.repro_mamba2_scan_bwd_chunk_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(_DTYPES[dtype], p, n))


def load() -> None:
    """Build (at first use) and load the forward kernels' library (the
    backward's builds at its first call)."""
    _lib()


def _check(x, dt, decay, B, C, S0) -> None:
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x and B must be 4-D, got {tuple(x.shape)} and "
                         f"{tuple(B.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    for name, t in (("dt", dt), ("decay", decay)):
        if t.shape != (b, s, h):
            raise ValueError(f"{name} must be {(b, s, h)}, got "
                             f"{tuple(t.shape)}")
    if B.shape[:2] != (b, s) or C.shape != B.shape:
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"be [{b}, {s}, g, n]")
    if g < 1 or h % g:
        raise ValueError(f"{h} heads do not group over {g} B/C groups")
    if p not in HEAD_DIMS or n not in HEAD_DIMS:
        raise ValueError(f"head size {p} or state size {n} not in "
                         f"{HEAD_DIMS}")
    if b < 1 or s < 1:
        raise ValueError(f"empty sequence {tuple(x.shape)}")
    if S0.shape != (b, h, p, n):
        raise ValueError(f"S0 must be {(b, h, p, n)}, got "
                         f"{tuple(S0.shape)}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must share one dtype of "
                        f"{tuple(_DTYPES)}, got {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    for name, t in (("dt", dt), ("decay", decay), ("S0", S0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {t.dtype}")
    if len({t.device for t in (x, dt, decay, B, C, S0)}) != 1:
        raise ValueError("x, dt, decay, B, C, S0 on different devices")


def mamba2_scan(x, dt, decay, B, C, S0, out=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, h, p] and B, C [b, s, g, n] (fp32 or bf16; head i reads
    group i // (h // g)), dt, decay [b, s, h] fp32, S0 [b, h, p, n] fp32
    -> (y [b, s, h, p] fp32, S_T [b, h, p, n] fp32).  S_T is written
    into ``out`` when given (contiguous fp32, S0 itself allowed: each
    state entry is read before it is written).  See ``mamba2_ref`` for
    the recurrence."""
    _check(x, dt, decay, B, C, S0)
    if out is not None and (out.shape != S0.shape or out.dtype !=
                            torch.float32 or out.device != S0.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous fp32 {tuple(S0.shape)} "
                         f"on {S0.device}")
    if x.device.type == "cpu":
        rep = x.shape[2] // B.shape[2]
        tr = lambda t: t.transpose(1, 2)
        per_head = lambda t: tr(t.repeat_interleave(rep, dim=2))
        y, sT = mamba2_ref(tr(x), tr(dt), tr(decay), per_head(B),
                           per_head(C), S0)
        return tr(y), sT if out is None else out.copy_(sT)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"mamba2_scan runs on cuda, meta or cpu, not "
                         f"{x.device}")
    for name, t in (("x", x), ("dt", dt), ("decay", decay), ("B", B),
                    ("C", C)):
        if min(t.stride()) < 0 or (t.dim() == 4 and t.stride(-1) != 1):
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"non-negative strides, got {t.stride()}")
    if not S0.is_contiguous():
        raise ValueError("S0 must be contiguous")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if b > _GRID_YZ_MAX or h > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    sT = out if out is not None else torch.empty(
        (b, h, p, n), dtype=torch.float32, device=x.device)
    kind = variant(s)
    scores = None
    if kind == "decode":                # float4 state reads and writes
        check_cp_async_alignment(S0=S0, out=sT)
    elif kind == "chunk":               # 16-byte cp.async tiles
        check_cp_async_alignment(x=x, B=B, C=C)
        n_chunks = -(-s // CHUNK_MIN_S)
        scores = torch.empty(b * h * n_chunks * _RECORD,
                             dtype=torch.float32, device=x.device)
    record_kernel("mamba2_scan", cost, b, s, h, p, n, g,
                  el=x.element_size())
    if x.device.type == "meta":
        return y, sT
    scores_ptr = None if scores is None else scores.data_ptr()
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_VARIANTS[kind], x.data_ptr(), dt.data_ptr(),
                 decay.data_ptr(), B.data_ptr(), C.data_ptr(),
                 S0.data_ptr(), y.data_ptr(), sT.data_ptr(), scores_ptr,
                 _DTYPES[x.dtype], p, n, b, s, h, g,
                 *x.stride()[:3], *dt.stride(), *decay.stride(),
                 *B.stride()[:3], *C.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"mamba2_scan ({kind}) launch failed: CUDA "
                           f"error {err}")
    global launches, launches_decode, launches_chunk
    launches += 1
    launches_decode += kind == "decode"
    launches_chunk += kind == "chunk"
    return y, sT


def mamba2_scan_bwd(x, dt, decay, B, C, S0, dy, dS_T):
    """The backward of :func:`mamba2_scan` from its inputs and the
    cotangents dy [b, s, h, p] (fp32, as y) and dS_T [b, h, p, n] (fp32)
    -> (dx [b, s, h, p] in x's dtype, ddt, ddecay [b, s, h] fp32, dB, dC
    [b, s, g, n] in B's dtype (each group's the sum over its heads), dS0
    [b, h, p, n] fp32): the gradient of the recurrence,
    ``mamba2_bwd_ref``'s formulas.  The kernels recompute the forward
    states from S0 into a scratch the wrapper allocates (s < 64: every
    ``BWD_TILE`` steps, b h ceil(s / 8) p n fp32; s >= 64: each chunk's
    boundary state and cotangent, 2 b h ceil(s / 64) p n fp32) and sum
    across state entries and heads in a fixed order, so two calls on the
    same inputs give the same bits."""
    _check(x, dt, decay, B, C, S0)
    if dy.shape != x.shape or dy.dtype != torch.float32:
        raise ValueError(f"dy must be fp32 {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if dS_T.shape != S0.shape or dS_T.dtype != torch.float32:
        raise ValueError(f"dS_T must be fp32 {tuple(S0.shape)}, got "
                         f"{tuple(dS_T.shape)} {dS_T.dtype}")
    if len({t.device for t in (x, dy, dS_T)}) != 1:
        raise ValueError("x, dy, dS_T on different devices")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.device.type == "cpu":
        rep = h // g
        tr = lambda t: t.transpose(1, 2)
        per_head = lambda t: tr(t.repeat_interleave(rep, dim=2))
        dx, ddt, ddecay, dBh, dCh, dS0 = mamba2_bwd_ref(
            tr(x), tr(dt), tr(decay), per_head(B), per_head(C), S0,
            tr(dy), dS_T)
        group = lambda t: tr(t.reshape(b, g, rep, s, n).sum(2)).to(B.dtype)
        return (tr(dx).to(x.dtype), tr(ddt), tr(ddecay), group(dBh),
                group(dCh), dS0)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"mamba2_scan_bwd runs on cuda, meta or cpu, not "
                         f"{x.device}")
    return _launch_bwd(x, dt, decay, B, C, S0, dy, dS_T)


def _launch_bwd(x, dt, decay, B, C, S0, dy, dS_T):
    """Launches the backward variant of s once and counts it (on meta:
    allocates its outputs and scratch and launches nothing); the
    arguments are checked by :func:`mamba2_scan_bwd`."""
    for name, t in (("x", x), ("dt", dt), ("decay", decay), ("B", B),
                    ("C", C), ("dy", dy)):
        if min(t.stride()) < 0 or (t.dim() == 4 and t.stride(-1) != 1):
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"non-negative strides, got {t.stride()}")
    for name, t in (("S0", S0), ("dS_T", dS_T)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if b > _GRID_YZ_MAX or h > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    kind = bwd_variant(s)
    if kind == "chunk":                 # 16-byte cp.async tiles
        check_cp_async_alignment(x=x, B=B, C=C, dy=dy)
        scratch = 2 * b * h * -(-s // CHUNK_MIN_S) * p * n
    else:
        scratch = b * h * -(-s // BWD_TILE) * p * n
    dev = x.device
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt, ddecay = (torch.empty((b, s, h), dtype=torch.float32, device=dev)
                   for _ in range(2))
    dB, dC = (torch.empty((b, s, g, n), dtype=B.dtype, device=dev)
              for _ in range(2))
    dS0 = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    ckpt = torch.empty(scratch, dtype=torch.float32, device=dev)
    dB_part, dC_part = (torch.empty(b * s * h * n, dtype=torch.float32,
                                    device=dev) for _ in range(2))
    record_kernel("mamba2_scan_bwd", bwd_cost, b, s, h, p, n, g,
                  el=x.element_size())
    if dev.type == "meta":
        return dx, ddt, ddecay, dB, dC, dS0
    fn = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_BWD_VARIANTS[kind], x.data_ptr(), dt.data_ptr(),
                 decay.data_ptr(), B.data_ptr(), C.data_ptr(),
                 S0.data_ptr(), dy.data_ptr(), dS_T.data_ptr(),
                 dx.data_ptr(), ddt.data_ptr(), ddecay.data_ptr(),
                 dB.data_ptr(), dC.data_ptr(), dS0.data_ptr(),
                 ckpt.data_ptr(), dB_part.data_ptr(), dC_part.data_ptr(),
                 _DTYPES[x.dtype], p, n, b, s, h, g,
                 *x.stride()[:3], *dt.stride(), *decay.stride(),
                 *B.stride()[:3], *C.stride()[:3], *dy.stride()[:3],
                 stream)
    if err != 0:
        raise RuntimeError(f"mamba2_scan_bwd ({kind}) launch failed: CUDA "
                           f"error {err}")
    global launches_bwd, launches_bwd_chunk
    launches_bwd += 1
    launches_bwd_chunk += kind == "chunk"
    return dx, ddt, ddecay, dB, dC, dS0
