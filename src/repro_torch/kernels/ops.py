"""Model-side entry points of the port's kernels.

Twin of ``repro/kernels/ops.py``.  Each public wrapper takes the model's
layout and goes to the kernel on CUDA tensors and to its plain version
on CPU tensors (``kernels/ref.py``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import flash_attention as fa


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
    devices = {a.device for a in args
               if isinstance(a, torch.Tensor) and a.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    for dev in devices:
        torch.cuda.synchronize(dev)
    _timing_hook(name, (time.perf_counter() - t0) * 1e6)
    return out


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {"flash_fwd": fa.launches}


def reset_launch_counts() -> None:
    fa.launches = 0


# ---------------------------------------------------------------------------
# flash attention


def flash_attention(q, k, v, causal: bool = True, *, q_offset: int = 0,
                    kv_len: Optional[int] = None):
    """q: [b, sq, H, d]; k, v: [b, sk, KV, d] (H % KV == 0).
    Returns o: [b, sq, H, d].  Query row i sits at position
    ``q_offset + i``; keys at positions >= ``kv_len`` are masked."""
    o, _ = _timed("flash_fwd", fa.flash_fwd, q, k, v, causal=causal,
                  q_offset=q_offset, kv_len=kv_len)
    return o
