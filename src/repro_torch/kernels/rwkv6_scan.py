"""RWKV-6 WKV recurrence: the wrapper around the Hopper CUDA kernel.

Twin of ``repro/kernels/rwkv6_scan.py`` (the Pallas TPU kernel
``rwkv6_scan``).  The kernel itself is ``csrc/rwkv6_scan.cu``; its source
note says what it computes, what bounds it on an H100 and what its
simple design leaves for later.  Unlike the Pallas kernel it computes the
recurrence step by step (exact at any decay in (0, 1], where the Pallas
kernel's in-chunk rescaling holds only for w in [~0.5, 1)), takes the
model-side layout ``[b, s, h, hd]`` through strides, and takes any
s >= 1, so one kernel serves prefill and each decode step.

On CUDA tensors :func:`rwkv6_scan` launches the kernel or raises; on CPU
tensors it computes :func:`repro_torch.kernels.ref.rwkv6_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rwkv6_ref

HEAD_DIMS = (16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_YZ_MAX = 65535

# kernel launches since the last reset (the CPU path never counts)
launches = 0

_p = ctypes.c_void_p
_ARGTYPES = [_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [_p]


def _lib():
    fn = build.library("rwkv6_scan").repro_rwkv6_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def load() -> None:
    """Build (at first use) and load the kernel's library."""
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
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cuda or cpu, not {r.device}")
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
    fn = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), S0.data_ptr(), y.data_ptr(), sT.data_ptr(),
                 _DTYPES[r.dtype], hd, b, s, h,
                 *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *w.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err}")
    global launches
    launches += 1
    return y, sT
