"""Model-side entry points of the port's kernels.

Twin of ``repro/kernels/ops.py``.  Each public wrapper takes the model's
layout and goes to the kernel on CUDA tensors and to its plain version
on CPU tensors (``kernels/ref.py``).  :func:`flash_attention` is
differentiable, as the JAX twin's ``custom_vjp`` is: its backward is the
flash backward (two kernels on the card, ``flash_bwd_ref`` on the CPU),
never autograd of the plain forward.  The two recurrences
(:func:`rwkv6_scan`, :func:`mamba2_scan`) are differentiable too: their
forward is the scan kernels, their backward a backward kernel of each
on the card (``rwkv6_bwd_ref`` / ``mamba2_bwd_ref`` on the CPU), the
gradient XLA takes of the JAX package's jnp scans, which train its SSM
families (its Pallas scans have no backward).  Their in-place state
path (``out=``) serves only and raises under autograd.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import rwkv6_scan as r6


# ---------------------------------------------------------------------------
# timing hook: obs.MetricsRegistry.kernel_hook() plugs in here.  When no
# hook is set (the default) the wrappers are untouched; with one set, the
# timed path synchronises the card before each clock read, which
# serialises launches, so it is for diagnosis, not for serving.

_timing_hook: Optional[Callable[[str, float], None]] = None


def set_timing_hook(hook: Optional[Callable[[str, float], None]]) -> None:
    """Install (or clear, with ``None``) a ``hook(kernel_name, microseconds)``
    called after each public kernel wrapper returns."""
    global _timing_hook
    _timing_hook = hook


def _timed(name: str, fn, *args, **kw):
    if _timing_hook is None:
        return fn(*args, **kw)
    flat = [t for a in args
            for t in (a if isinstance(a, (list, tuple)) else (a,))]
    devices = {a.device for a in flat
               if isinstance(a, torch.Tensor) and a.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    for dev in devices:
        torch.cuda.synchronize(dev)
    _timing_hook(name, (time.perf_counter() - t0) * 1e6)
    return out


# cost hook: with a ``runtime.op_cost.CostCounter`` active, every call of
# these wrappers is recorded by the kernel module it reaches, with that
# module's ``cost()``, where the kernel launches (cuda) or where its meta
# route returns (meta): one record a launch, under the names of
# :func:`launch_counts` (``op_cost.record_kernel``).  The CPU route runs
# the plain version, whose ATen ops the counter sees instead.


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {"flash_fwd": fa.launches, "flash_bwd_dq": fa.launches_dq,
            "flash_bwd_dkv": fa.launches_dkv, "fused_update": fu.launches,
            "rwkv6_scan": r6.launches, "mamba2_scan": m2.launches,
            "rwkv6_scan_bwd": r6.launches_bwd,
            "mamba2_scan_bwd": m2.launches_bwd}


def variant_counts() -> Dict[str, int]:
    """Launches of kernel variants since the last reset, each a part of
    its :func:`launch_counts` total: the bf16 tensor-core kernels of
    ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` (the rest went
    to the fp32 FMA kernels), and the scans' decode (s = 1) and chunked
    (s >= 64) kernels (the rest went to the stepwise ones), and the
    scans' chunked backward kernels (s >= 64; the rest went to the
    stepwise backward)."""
    return {"flash_fwd_mma": fa.launches_mma,
            "flash_bwd_dq_mma": fa.launches_dq_mma,
            "flash_bwd_dkv_mma": fa.launches_dkv_mma,
            "rwkv6_scan_decode": r6.launches_decode,
            "rwkv6_scan_chunk": r6.launches_chunk,
            "mamba2_scan_decode": m2.launches_decode,
            "mamba2_scan_chunk": m2.launches_chunk,
            "rwkv6_scan_bwd_chunk": r6.launches_bwd_chunk,
            "mamba2_scan_bwd_chunk": m2.launches_bwd_chunk}


def reset_launch_counts() -> None:
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    fa.launches_mma = fa.launches_dq_mma = fa.launches_dkv_mma = 0
    fu.launches = r6.launches = m2.launches = 0
    r6.launches_decode = r6.launches_chunk = 0
    m2.launches_decode = m2.launches_chunk = 0
    r6.launches_bwd = m2.launches_bwd = 0
    r6.launches_bwd_chunk = m2.launches_bwd_chunk = 0


# ---------------------------------------------------------------------------
# flash attention


class _FlashAttention(torch.autograd.Function):
    """Forward ``fa.flash_fwd`` (saving q, k, v, o, lse), backward
    ``fa.flash_bwd``: the twin of the JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_len):
        o, lse = _timed("flash_fwd", fa.flash_fwd, q, k, v, causal=causal,
                        q_offset=q_offset, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.flash_kw = dict(causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _timed("flash_bwd", fa.flash_bwd, q, k, v, o, lse,
                            do.contiguous(), **ctx.flash_kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, *, q_offset: int = 0,
                    kv_len: Optional[int] = None):
    """q: [b, sq, H, dk]; k: [b, sk, KV, dk]; v: [b, sk, KV, dv] (H % KV
    == 0; the card takes the width pairs of ``flash_attention.
    WIDTH_PAIRS``).  Returns o: [b, sq, H, dv].  Query row i sits at
    position ``q_offset + i``; keys at positions >= ``kv_len`` are
    masked.  Differentiable in q, k and v through the flash backward."""
    return _FlashAttention.apply(q, k, v, causal, q_offset, kv_len)


def flash_attention_paged(q, k_pages, v_pages, pages, kv_lens, *,
                          ranges_checked: bool = False):
    """The pipelined engine's decode wave: q [R, 1, H, dk] against one
    layer's paged KV buffer k_pages, v_pages [n_pages + 1, page_seq, KV,
    dk | dv]; row r sees the first ``kv_lens[r]`` keys of page
    ``pages[r]`` (int32 [R] tensors on q's device).  Returns o [R, 1, H,
    dv].  One kernel launch for all rows, counted under ``flash_fwd``;
    forward only (serving).  See ``flash_attention.flash_fwd_paged``,
    also for ``ranges_checked``."""
    o, _ = _timed("flash_fwd", fa.flash_fwd_paged, q, k_pages, v_pages,
                  pages, kv_lens, ranges_checked=ranges_checked)
    return o


# ---------------------------------------------------------------------------
# fused momentum update + SpecTrain prediction


def fused_update(ws, vs, gs, *, lr: float, gamma: float, s: float = 0.0,
                 whats=None) -> None:
    """In-place momentum-SGD update of a group of fp32 tensors sharing
    ``(lr, gamma, s)``, writing the prediction ``w' - s lr v'`` into each
    given ``whats[i]``.  See ``kernels/fused_update.py``."""
    _timed("fused_update", fu.fused_update, ws, vs, gs, lr=lr,
           gamma=gamma, s=s, whats=whats)


# ---------------------------------------------------------------------------
# recurrences


class _RWKV6Scan(torch.autograd.Function):
    """Forward ``r6.rwkv6_scan`` (saving its inputs), backward
    ``r6.rwkv6_scan_bwd``, which recomputes the states from S0."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, S0):
        y, sT = _timed("rwkv6_scan", r6.rwkv6_scan, r, k, v, w, u, S0)
        ctx.save_for_backward(r, k, v, w, u, S0)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        return _timed("rwkv6_scan_bwd", r6.rwkv6_scan_bwd,
                      *ctx.saved_tensors, dy.contiguous(), dsT.contiguous())


class _Mamba2Scan(torch.autograd.Function):
    """Forward ``m2.mamba2_scan`` (saving its inputs), backward
    ``m2.mamba2_scan_bwd``, which recomputes the states from S0."""

    @staticmethod
    def forward(ctx, x, dt, decay, B, C, S0):
        y, sT = _timed("mamba2_scan", m2.mamba2_scan, x, dt, decay, B, C,
                       S0)
        ctx.save_for_backward(x, dt, decay, B, C, S0)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        return _timed("mamba2_scan_bwd", m2.mamba2_scan_bwd,
                      *ctx.saved_tensors, dy.contiguous(), dsT.contiguous())


def _differentiable(name: str, out, *ts) -> bool:
    """Whether autograd records this call; the in-place ``out`` serves
    only and raises when it would."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)):
        return False
    if out is not None:
        raise ValueError(
            f"{name}: out= writes the state in place for serving; a call "
            f"that autograd records takes out=None (the training path's "
            f"state=None)")
    return True


def rwkv6_scan(r, k, v, w, u, S0, out=None):
    """Model-side layout: r, k, v, w [b, s, h, hd]; u [h, hd]; S0
    [b, h, hd, hd] fp32 -> (y [b, s, h, hd] in r's dtype, S_T fp32),
    S_T written into ``out`` if given (``out=S0`` updates the state in
    place).  Differentiable in every input (not with ``out``).  See
    ``kernels/rwkv6_scan.py``."""
    if _differentiable("rwkv6_scan", out, r, k, v, w, u, S0):
        return _RWKV6Scan.apply(r, k, v, w, u, S0)
    return _timed("rwkv6_scan", r6.rwkv6_scan, r, k, v, w, u, S0, out)


def mamba2_scan(x, dt, decay, B, C, S0, out=None):
    """Model-side layouts: x [b, s, h, p]; dt, decay [b, s, h]; B, C
    [b, s, g, n] (the group of head i is i // (h // g), read in place);
    S0 [b, h, p, n] fp32 -> (y [b, s, h, p] fp32, S_T fp32), S_T written
    into ``out`` if given (``out=S0`` updates the state in place).
    Differentiable in every input (not with ``out``).  See
    ``kernels/mamba2_scan.py``."""
    if _differentiable("mamba2_scan", out, x, dt, decay, B, C, S0):
        return _Mamba2Scan.apply(x, dt, decay, B, C, S0)
    return _timed("mamba2_scan", m2.mamba2_scan, x, dt, decay, B, C, S0,
                  out)
