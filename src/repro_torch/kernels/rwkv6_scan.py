"""RWKV-6 WKV recurrence: the wrapper around the Hopper CUDA kernels.

Twin of ``repro/kernels/rwkv6_scan.py`` (the Pallas TPU kernel
``rwkv6_scan``, body ``_wkv_kernel``).  The kernels are in
``csrc/rwkv6_scan.cu``, whose source note says what each computes, what
bounds it on an H100 and what its design does about that.  Unlike the
Pallas kernel, which divides by a running decay product inside a chunk
(valid only for w in [~0.5, 1)), every kernel here is exact at any decay
in [0, 1]; they take the model-side layout ``[b, s, h, hd]`` through
strides and any s >= 1.  :func:`variant` picks the kernel by s:

  * s = 1: ``wkv_decode_kernel``, one decode step, bound by the bytes
    of the fp32 state (read and written once, float4 a thread);
  * 2 <= s < ``CHUNK_MIN_S``: ``wkv_kernel``, the recurrence step by step
    (the serving paths' short prompts);
  * s >= ``CHUNK_MIN_S``: ``wkv_scores_kernel``, the diagonal scores of
    every chunk of 64 steps at once (into a scratch tensor the wrapper
    allocates), then ``wkv_chunk_kernel``, the chunks in order on the
    tensor cores (3xTF32 ``mma.sync``), the decay factors formed as
    products over sub-chunks of 16 (a long prompt).  The pair counts as
    one launch of the chunked variant.

This is routing by shape, not a fallback: each variant is exact and
each raises on what it does not take.  On CUDA tensors
:func:`rwkv6_scan` launches its variant or raises; on CPU tensors it
computes :func:`repro_torch.kernels.ref.rwkv6_ref`.

:func:`rwkv6_scan_bwd` is the recurrence's backward (the training
path's), in ``csrc/rwkv6_scan_bwd.cu`` on CUDA tensors, routed by s
(:func:`bwd_variant`):

  * s < ``CHUNK_MIN_S``: ``wkv_bwd_kernel``, the steps in reverse, one
    block a (batch row, head);
  * s >= ``CHUNK_MIN_S``: ``wkv_bwd_states_kernel`` (the chunks'
    boundary states and cotangents, a short walk over chunks of 64)
    then ``wkv_bwd_chunk_kernel`` (every chunk's gradients at once, a
    block per (chunk, head, batch row): sub-chunks of 16, the products
    across them on the tensor cores, 3xTF32 ``mma.sync``, the pairs
    inside one on the CUDA cores);

either then ``wkv_bwd_du_kernel`` (du's sum over the batch rows and
chunks in order), all deterministic and counting as one launch (and one
of ``launches_bwd_chunk`` for the chunked variant);
:func:`repro_torch.kernels.ref.rwkv6_bwd_ref` on CPU tensors.

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
from repro_torch.kernels.ref import rwkv6_bwd_ref, rwkv6_ref
from repro_torch.runtime.op_cost import record_kernel

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_YZ_MAX = 65535
# the shortest sequence the chunked tensor-core kernel takes
CHUNK_MIN_S = 64
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
_ARGTYPES = ([ctypes.c_int] + [_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [_p])
# diagonal scores of one (batch row, head, chunk) for the chunked kernel
_SCORES_PER_CHUNK = 4 * 16 * 16
_BWD_ARGTYPES = ([ctypes.c_int] + [_p] * 16 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 15 + [_p])
_BWD_VARIANTS = {"step": 0, "chunk": 1}
# steps per checkpoint of the backward kernel's forward walk
BWD_TILE = 8


def variant(s: int) -> str:
    """The kernel a call of sequence length ``s`` launches: ``"decode"``
    (s = 1), ``"step"`` (2 <= s < CHUNK_MIN_S) or ``"chunk"``."""
    if s == 1:
        return "decode"
    return "chunk" if s >= CHUNK_MIN_S else "step"


def bwd_variant(s: int) -> str:
    """The backward kernels a call of sequence length ``s`` launches:
    ``"step"`` (s < CHUNK_MIN_S) or ``"chunk"`` (both scans)."""
    return "chunk" if s >= CHUNK_MIN_S else "step"


def recurrence_flops(b: int, s: int, h: int, p: int, n: int) -> int:
    """FLOPs of a [p x n] recurrence run step by step (both scans), per
    step and state element 3 for the update (two products and a sum) and
    2 for the read-out (a product and a sum); rwkv6's bonus term folds to
    O(hd).  The work of the decode and stepwise kernels, in fp32 outside
    the tensor cores."""
    return 5 * b * s * h * p * n


def flops_type(s: int) -> str:
    """The type of the operations :func:`cost` and :func:`bwd_cost`
    count at sequence length ``s`` (the key of the card's peak rate):
    ``"tf32"`` for the chunked kernels' tensor-core products, else
    ``"float32"`` (both scans, forward and backward)."""
    return "tf32" if s >= CHUNK_MIN_S else "float32"


def cost(b: int, s: int, h: int, hd: int, *, el: int = 2
         ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one :func:`rwkv6_scan` call, the work of the
    variant it runs: bytes, every input read once and y and S_T written
    once (r, k, v and y at ``el`` bytes, w, u and the states fp32);
    FLOPs, for the decode and stepwise kernels the fp32 recurrence's
    (:func:`recurrence_flops`), for the chunked kernels (s >= 64) the
    chunked form's tensor-core products, each counted once (not per
    3xTF32 pass), per step and head 4 hd^2 (y and the state, sub-chunks
    of 16) + 32 hd (the diagonal scores times v); that form needs fewer
    operations than the recurrence, so the recurrence's count is no
    floor for it.  :func:`flops_type` names their type."""
    nbytes = (el * 4 * b * s * h * hd        # r, k, v in; y out
              + 4 * b * s * h * hd           # w
              + 4 * h * hd                   # u
              + 2 * 4 * b * h * hd * hd)     # S0 in, S_T out
    if variant(s) == "chunk":
        return b * s * h * (4 * hd * hd + 32 * hd), nbytes
    return recurrence_flops(b, s, h, hd, hd), nbytes


def bwd_chunk_flops(b: int, s: int, h: int, hd: int, *, bf16: bool,
                    passes: bool = False) -> float:
    """Tensor-core FLOPs of the chunked backward (2 a multiply-add;
    with ``passes``, times each product's mma passes, 1 to 3 as 3xTF32
    splits its fp32-derived operands, bf16 operands being exact), per
    (batch row, head, chunk of 64), sub-chunks of 16: the walk's 2 x 4
    [hd x hd] updates over 16 steps; the chunk's 3 states and 3
    cotangents; per sub-chunk dy S^T, v G^T, (k o K) G ([16 x hd x hd]),
    dy v^T and A^T dy ([16 x 16 x hd], A at its triangle of 136)."""
    pa = ((lambda x, y: 1 + (not x) + (not y)) if passes
          else (lambda x, y: 1))                # mma passes
    ex = bf16
    sub = 16 * hd * hd
    mac = (8 * sub * pa(False, ex) + 6 * sub * pa(False, ex)
           + 4 * (2 * sub * pa(ex, False) + sub * pa(False, False)
                  + 16 * 16 * hd * pa(ex, ex)
                  + 136 * hd * pa(False, ex)))
    return 2.0 * mac * b * h * -(-s // CHUNK_MIN_S)


def bwd_cost(b: int, s: int, h: int, hd: int, *, el: int = 2
             ) -> Tuple[float, int]:
    """(FLOPs, bytes) of one :func:`rwkv6_scan_bwd` call: bytes, every
    input read once and every gradient written once; FLOPs, s < 64 (the
    stepwise kernels) the fp32 operations, per step and state entry 14:
    the state recomputed (3), the cotangent's update (w G + r dy, 3) and
    four products summed (dr, dk, dv, dw); s >= 64 (the chunked kernels)
    the chunked form's tensor-core products, each counted once
    (:func:`bwd_chunk_flops`).  :func:`flops_type` names their type."""
    nbytes = (2 * el * 4 * b * s * h * hd    # r, k, v, dy; dr..dv
              - el * b * s * h * hd          # (3 grads, not 4)
              + 2 * 4 * b * s * h * hd       # w in, dw out
              + 2 * 4 * h * hd               # u, du
              + 3 * 4 * b * h * hd * hd)     # S0, dS_T, dS0
    if bwd_variant(s) == "step":
        return 14 * b * s * h * hd * hd, nbytes
    return bwd_chunk_flops(b, s, h, hd, bf16=el == 2), nbytes


def _lib():
    fn = build.library("rwkv6_scan").repro_rwkv6_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def chunk_smem_bytes(dtype: torch.dtype, hd: int, scores: bool = False
                     ) -> int:
    """Dynamic shared memory of one ``wkv_chunk_kernel`` block, or with
    ``scores`` of one ``wkv_scores_kernel`` block."""
    fn = build.library("rwkv6_scan").repro_rwkv6_scan_chunk_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(_DTYPES[dtype], hd, int(scores)))


def _bwd_lib():
    fn = build.library("rwkv6_scan_bwd").repro_rwkv6_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def bwd_smem_bytes(hd: int, dtype: torch.dtype = None) -> int:
    """Dynamic shared memory of one ``wkv_bwd_kernel`` block, or with
    ``dtype`` of one ``wkv_bwd_chunk_kernel`` block."""
    lib = build.library("rwkv6_scan_bwd")
    if dtype is None:
        fn = lib.repro_rwkv6_scan_bwd_smem_bytes
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_longlong
        return int(fn(hd))
    fn = lib.repro_rwkv6_scan_bwd_chunk_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    return int(fn(_DTYPES[dtype], hd))


def load() -> None:
    """Build (at first use) and load the forward kernels' library (the
    backward's builds at its first call)."""
    _lib()


def _check(r, k, v, w, u, S0) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be 4-D [b, s, h, hd], got "
                         f"{tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r "
                             f"{tuple(r.shape)}")
    b, s, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head size {hd} not in {HEAD_DIMS}")
    if b < 1 or s < 1:
        raise ValueError(f"empty sequence {tuple(r.shape)}")
    if u.shape != (h, hd):
        raise ValueError(f"u must be {(h, hd)}, got {tuple(u.shape)}")
    if S0.shape != (b, h, hd, hd):
        raise ValueError(f"S0 must be {(b, h, hd, hd)}, got "
                         f"{tuple(S0.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share one dtype of "
                        f"{tuple(_DTYPES)}, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("w", w), ("u", u), ("S0", S0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {t.dtype}")
    if len({t.device for t in (r, k, v, w, u, S0)}) != 1:
        raise ValueError("r, k, v, w, u, S0 on different devices")


def rwkv6_scan(r, k, v, w, u, S0, out=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v [b, s, h, hd] (fp32 or bf16), w [b, s, h, hd] fp32, u
    [h, hd] fp32, S0 [b, h, hd, hd] fp32 -> (y [b, s, h, hd] in r's
    dtype, S_T [b, h, hd, hd] fp32).  S_T is written into ``out`` when
    given (contiguous fp32, S0 itself allowed: each state entry is read
    before it is written).  See ``rwkv6_ref`` for the recurrence."""
    _check(r, k, v, w, u, S0)
    if out is not None and (out.shape != S0.shape or out.dtype !=
                            torch.float32 or out.device != S0.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous fp32 {tuple(S0.shape)} "
                         f"on {S0.device}")
    if r.device.type == "cpu":
        tr = lambda t: t.transpose(1, 2)
        y, sT = rwkv6_ref(tr(r), tr(k), tr(v), tr(w), u, S0)
        return tr(y).to(r.dtype), sT if out is None else out.copy_(sT)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan runs on cuda, meta or cpu, not "
                         f"{r.device}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"non-negative strides, got {t.stride()}")
    for name, t in (("u", u), ("S0", S0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, s, h, hd = r.shape
    if b > _GRID_YZ_MAX or h > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    y = torch.empty((b, s, h, hd), dtype=r.dtype, device=r.device)
    sT = out if out is not None else torch.empty(
        (b, h, hd, hd), dtype=torch.float32, device=r.device)
    kind = variant(s)
    scores = None
    if kind == "decode":                # float4 state reads and writes
        check_cp_async_alignment(S0=S0, out=sT)
    elif kind == "chunk":               # 16-byte cp.async tiles
        check_cp_async_alignment(r=r, k=k, v=v, w=w)
        n_chunks = -(-s // CHUNK_MIN_S)
        scores = torch.empty(b * h * n_chunks * _SCORES_PER_CHUNK,
                             dtype=torch.float32, device=r.device)
    record_kernel("rwkv6_scan", cost, b, s, h, hd, el=r.element_size())
    if r.device.type == "meta":
        return y, sT
    scores_ptr = None if scores is None else scores.data_ptr()
    fn = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(_VARIANTS[kind], r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 w.data_ptr(), u.data_ptr(), S0.data_ptr(), y.data_ptr(),
                 sT.data_ptr(), scores_ptr,
                 _DTYPES[r.dtype], hd, b, s, h,
                 *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *w.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan ({kind}) launch failed: CUDA "
                           f"error {err}")
    global launches, launches_decode, launches_chunk
    launches += 1
    launches_decode += kind == "decode"
    launches_chunk += kind == "chunk"
    return y, sT


def rwkv6_scan_bwd(r, k, v, w, u, S0, dy, dS_T):
    """The backward of :func:`rwkv6_scan` from its inputs and the
    cotangents dy [b, s, h, hd] (r's dtype) and dS_T [b, h, hd, hd]
    (fp32) -> (dr, dk, dv [b, s, h, hd] in r's dtype, dw [b, s, h, hd]
    fp32, du [h, hd] fp32, dS0 [b, h, hd, hd] fp32): the gradient of the
    recurrence, ``rwkv6_bwd_ref``'s formulas.  The kernels recompute the
    forward states from S0 into a scratch the wrapper allocates (s < 64:
    every ``BWD_TILE`` steps, b h ceil(s / 8) hd^2 fp32; s >= 64: each
    chunk's boundary state and cotangent, 2 b h ceil(s / 64) hd^2 fp32)
    and sum across state entries in a fixed order, so two calls on the
    same inputs give the same bits."""
    _check(r, k, v, w, u, S0)
    if dy.shape != r.shape or dy.dtype != r.dtype:
        raise ValueError(f"dy must be {tuple(r.shape)} {r.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if dS_T.shape != S0.shape or dS_T.dtype != torch.float32:
        raise ValueError(f"dS_T must be fp32 {tuple(S0.shape)}, got "
                         f"{tuple(dS_T.shape)} {dS_T.dtype}")
    if len({t.device for t in (r, dy, dS_T)}) != 1:
        raise ValueError("r, dy, dS_T on different devices")
    if r.device.type == "cpu":
        tr = lambda t: t.transpose(1, 2)
        dr, dk, dv, dw, du, dS0 = rwkv6_bwd_ref(
            tr(r), tr(k), tr(v), tr(w), u, S0, tr(dy), dS_T)
        return (tr(dr).to(r.dtype), tr(dk).to(r.dtype), tr(dv).to(r.dtype),
                tr(dw), du, dS0)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan_bwd runs on cuda, meta or cpu, not "
                         f"{r.device}")
    return _launch_bwd(r, k, v, w, u, S0, dy, dS_T)


def _launch_bwd(r, k, v, w, u, S0, dy, dS_T):
    """Launches the backward variant of s once and counts it (on meta:
    allocates its outputs and scratch and launches nothing); the
    arguments are checked by :func:`rwkv6_scan_bwd`."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("dy", dy)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"non-negative strides, got {t.stride()}")
    for name, t in (("u", u), ("S0", S0), ("dS_T", dS_T)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, s, h, hd = r.shape
    if b > _GRID_YZ_MAX or h > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    kind = bwd_variant(s)
    n_chunks = -(-s // CHUNK_MIN_S)
    if kind == "chunk":                 # 16-byte cp.async tiles
        check_cp_async_alignment(r=r, k=k, v=v, w=w, dy=dy)
        scratch, parts = 2 * b * h * n_chunks * hd * hd, b * h * n_chunks
    else:
        scratch, parts = b * h * -(-s // BWD_TILE) * hd * hd, b * h
    dev = r.device
    dr, dk, dv = (torch.empty((b, s, h, hd), dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty((b, s, h, hd), dtype=torch.float32, device=dev)
    du = torch.empty((h, hd), dtype=torch.float32, device=dev)
    dS0 = torch.empty((b, h, hd, hd), dtype=torch.float32, device=dev)
    ckpt = torch.empty(scratch, dtype=torch.float32, device=dev)
    du_part = torch.empty(parts * hd, dtype=torch.float32, device=dev)
    record_kernel("rwkv6_scan_bwd", bwd_cost, b, s, h, hd,
                  el=r.element_size())
    if dev.type == "meta":
        return dr, dk, dv, dw, du, dS0
    fn = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_BWD_VARIANTS[kind], r.data_ptr(), k.data_ptr(),
                 v.data_ptr(), w.data_ptr(), u.data_ptr(), S0.data_ptr(),
                 dy.data_ptr(), dS_T.data_ptr(), dr.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                 dS0.data_ptr(), ckpt.data_ptr(), du_part.data_ptr(),
                 _DTYPES[r.dtype], hd, b, s, h,
                 *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *w.stride()[:3], *dy.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_bwd ({kind}) launch failed: CUDA "
                           f"error {err}")
    global launches_bwd, launches_bwd_chunk
    launches_bwd += 1
    launches_bwd_chunk += kind == "chunk"
    return dr, dk, dv, dw, du, dS0
