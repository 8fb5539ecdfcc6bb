"""Flash attention forward: the wrapper around the Hopper CUDA kernel.

Twin of ``repro/kernels/flash_attention.py::flash_fwd`` (the Pallas TPU
kernel).  The kernel itself is ``csrc/flash_fwd.cu``; its source note
says what it computes, what bounds it on an H100 and what its simple
design leaves for later.  Unlike the Pallas kernel it takes the
model-side layout and indexes the KV head as ``h // G``, so it serves
GQA without folding, and it takes a query position offset and a key
count, so one kernel serves causal prefill and each decode step.

On CUDA tensors :func:`flash_fwd` launches the kernel or raises; on CPU
tensors it computes :func:`repro_torch.kernels.ref.flash_fwd_ref`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_fwd_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_YZ_MAX = 65535

# kernel launches since the last reset (the CPU path never counts)
launches = 0

_c = ctypes.c_int
_ll = ctypes.c_longlong
_p = ctypes.c_void_p
_ARGTYPES = ([_p] * 5 + [_c] * 6 + [_ll] * 9
             + [_c, _c, _c, ctypes.c_float, _p])


def _lib():
    lib = build.library("flash_fwd")
    fn = lib.repro_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def load() -> None:
    """Build (at first use) and load the kernel's library."""
    _lib()


def _check(q, k, v, q_offset: int, kv_len: int) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D [b, s, heads, d], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    b, sq, H, d = q.shape
    bk, sk, KV, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head_dim")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{tuple(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if b < 1 or sq < 1:
        raise ValueError(f"empty query {tuple(q.shape)}")
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len={kv_len} outside [1, {sk}]")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset} < 0")


def flash_fwd(q, k, v, *, causal: bool, q_offset: int = 0,
              kv_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [b, sq, H, d]; k, v: [b, sk, KV, d] -> (o [b, sq, H, d] in q's
    dtype, lse [b, H, sq] fp32).  See ``flash_fwd_ref`` for the masks."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    _check(q, k, v, q_offset, kv_len)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"non-negative strides, got {t.stride()}")
    b, sq, H, d = q.shape
    KV = k.shape[2]
    if b > _GRID_YZ_MAX or H > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} or heads {H} exceed the launch grid")
    o = torch.empty((b, sq, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, H, sq), dtype=torch.float32, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _DTYPES[q.dtype], d, b, sq, H, KV,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(bool(causal)), q_offset, kv_len,
                 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    global launches
    launches += 1
    return o, lse
