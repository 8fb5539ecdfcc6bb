"""Plain PyTorch versions of the port's kernels.

The CPU tests hold the port against the JAX package through these, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.  The
kernel wrappers call them only for tensors that lie on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# flash attention


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None):
    """q: [b,h,sq,d]; k,v: [b,hkv,sk,d] (GQA: h % hkv == 0).  fp32 softmax.

    Twin of ``repro.kernels.ref.attention_ref`` (kernel layout, causal
    mask aligned to the last query row, probabilities cast back to
    q's dtype before the value product)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale or 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k).float() * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v)
    return o.reshape(b, h, sq, v.shape[-1])


def flash_fwd_ref(q, k, v, *, causal: bool, q_offset: int = 0,
                  kv_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the flash forward kernel computes, in the model-side layout.

    q: [b, sq, H, d]; k, v: [b, sk, KV, d] with H % KV == 0, query head
    ``h`` reading KV head ``h // (H // KV)``.  Query row ``i`` sits at
    position ``q_offset + i``; keys at positions ``>= kv_len`` are
    masked, and ``causal`` also masks keys after the query's position.
    The softmax runs in fp32 with the Pallas kernel's -1e30 mask and
    ``max(l, 1e-30)`` guard.  Returns ``o`` [b, sq, H, d] in q's dtype
    and the fp32 log-sum-exp ``lse`` [b, H, sq]."""
    b, sq, H, d = q.shape
    sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    kv_len = sk if kv_len is None else kv_len
    qf = q.float().reshape(b, sq, KV, G, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (
        1.0 / math.sqrt(d))
    kpos = torch.arange(sk, device=q.device)
    mask = (kpos < kv_len)[None, :].expand(sq, sk)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = mask & (kpos[None, :] <= qpos[:, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o / lsum.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(lsum)).reshape(b, H, sq)
    return o.reshape(b, sq, H, d).to(q.dtype), lse
