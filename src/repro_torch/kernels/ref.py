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

    q: [b, sq, H, dk]; k: [b, sk, KV, dk]; v: [b, sk, KV, dv] with
    H % KV == 0, query head ``h`` reading KV head ``h // (H // KV)``; any
    widths (the kernels take the pairs of
    ``flash_attention.WIDTH_PAIRS``), scale ``1 / sqrt(dk)``.  Query row
    ``i`` sits at position ``q_offset + i``; keys at positions
    ``>= kv_len`` are masked, and ``causal`` also masks keys after the
    query's position.
    The softmax runs in fp32 with the Pallas kernel's -1e30 mask and
    ``max(l, 1e-30)`` guard.  Returns ``o`` [b, sq, H, dv] in q's dtype
    and the fp32 log-sum-exp ``lse`` [b, H, sq]."""
    sq, sk = q.shape[1], k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    kpos = torch.arange(sk, device=q.device)
    mask = (kpos < kv_len)[None, :].expand(sq, sk)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = mask & (kpos[None, :] <= qpos[:, None])
    return _masked_attention(q, k, v, mask)


def flash_fwd_paged_ref(q, k_pages, v_pages, pages, kv_lens
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the flash forward kernel computes on paged rows (the decode
    wave): q [R, 1, H, dk]; k_pages, v_pages [n_pages + 1, page_seq, KV,
    dk | dv]; pages, kv_lens int [R].  Row r attends, without a causal mask, to
    the first ``kv_lens[r]`` keys of page ``pages[r]``: the pages are
    gathered and :func:`flash_fwd_ref`'s arithmetic runs with each row's
    own length.  Returns (o [R, 1, H, dv], lse [R, H, 1] fp32)."""
    pages, kv_lens = pages.long(), kv_lens.long()
    k, v = k_pages[pages], v_pages[pages]
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = (kpos[None, :] < kv_lens[:, None])[:, None, None, None, :]
    return _masked_attention(q, k, v, mask)


def _masked_attention(q, k, v, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward's arithmetic: q [b, sq, H, dk] against k, v
    [b, sk, KV, dk | dv] (query head h reads KV head h // (H // KV)) where
    ``mask`` (broadcast to [b, KV, G, sq, sk]) is true; fp32 softmax
    with the -1e30 mask value and the max(l, 1e-30) guard."""
    b, sq, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(b, sq, KV, G, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (
        1.0 / math.sqrt(d))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    lsum = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o / lsum.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(lsum)).reshape(b, H, sq)
    return o.reshape(b, sq, H, v.shape[-1]).to(q.dtype), lse


def flash_dl(o, do) -> torch.Tensor:
    """dl = rowsum(o * do) in fp32, [b, sq, H, dv] -> [b, H, sq]: the term
    the flash backward subtracts from do.v.  Computed in plain torch
    before the backward kernels run, as the JAX package computes it
    outside its Pallas kernels."""
    return (o.float() * do.float()).sum(-1).permute(0, 2, 1).contiguous()


def flash_bwd_ref(q, k, v, o, lse, do, *, causal: bool, q_offset: int = 0,
                  kv_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the flash backward kernels compute, in the model-side layout.

    q: [b, sq, H, dk]; o, do: [b, sq, H, dv]; k: [b, sk, KV, dk]; v:
    [b, sk, KV, dv]; lse: [b, H, sq] fp32 from the forward; any widths.
    The masks are :func:`flash_fwd_ref`'s.  Written out as the Pallas
    kernels' formulas (not autograd of the forward), all in fp32:

        dl = rowsum(o * do)
        p  = where(mask, exp(s * scale - lse), 0)
        ds = p * (do.v^T - dl) * scale
        dq = ds k,   dk = sum over the group's G heads of ds^T q,
        dv = sum over the group's G heads of p^T do

    Returns (dq in q's dtype, dk and dv in k's dtype)."""
    b, sq, H, d = q.shape
    sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    kv_len = sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, KV, G, d)
    dof = do.float().reshape(b, sq, KV, G, v.shape[-1])
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    kpos = torch.arange(sk, device=q.device)
    mask = (kpos < kv_len)[None, :].expand(sq, sk)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = mask & (kpos[None, :] <= qpos[:, None])
    lse_g = lse.reshape(b, KV, G, sq)
    p = torch.where(mask, torch.exp(s - lse_g[..., None]),
                    torch.zeros_like(s))
    dl = flash_dl(o, do).reshape(b, KV, G, sq)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - dl[..., None]) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, sq, H, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(k.dtype)


# ---------------------------------------------------------------------------
# recurrences: sequential scans over time in fp32 (no chunking)


def rwkv6_ref(r, k, v, w, u, S0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 WKV recurrence, one step at a time.

    Twin of ``repro.kernels.ref.rwkv6_ref`` (kernel layout): r, k, v, w
    [b, h, s, hd]; u [h, hd]; S0 [b, h, hd, hd] (key x value).  Per step

        y_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T

    all in fp32.  Exact at any decay in (0, 1]: no running product is
    divided out.  Returns (y [b, h, s, hd] fp32, S_T fp32)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    S = S0.float()
    ys = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]          # [b, h, hd, hd]
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               S + u[..., :, None] * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(ys, dim=2), S


def mamba2_ref(x, dt, decay, B, C, S0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 SSD recurrence, one step at a time.

    Twin of ``repro.kernels.ref.mamba2_ref`` (kernel layout): x
    [b, h, s, p]; dt, decay [b, h, s]; B, C [b, h, s, n] (already one per
    head); S0 [b, h, p, n].  Per step

        S <- decay_t S + (dt_t x_t) B_t^T,   y_t = S C_t

    all in fp32.  Returns (y [b, h, s, p] fp32, S_T fp32)."""
    x, dt, decay, B, C = (t.float() for t in (x, dt, decay, B, C))
    S = S0.float()
    ys = []
    for t in range(x.shape[2]):
        S = S * decay[:, :, t, None, None] + (
            (dt[:, :, t, None] * x[:, :, t])[..., :, None]
            * B[:, :, t, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", S, C[:, :, t]))
    return torch.stack(ys, dim=2), S


def rwkv6_bwd_ref(r, k, v, w, u, S0, dy, dS_T):
    """The backward of :func:`rwkv6_ref`, one step at a time in reverse.

    The formulas the backward kernel computes (not autograd of the
    forward), all in fp32, in :func:`rwkv6_ref`'s kernel layout (dy
    [b, h, s, hd], dS_T [b, h, hd, hd]).  The states S_{t-1} come from a
    forward pass (never from dividing by w_t, which may be 0).  With G
    the cotangent of S_t, from G = dS_T:

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
        dk_t = u o r_t (v_t . dy_t) + G v_t
        dv_t = (sum_i u_i r_ti k_ti) dy_t + G^T k_t
        dw_t = rowsum(G o S_{t-1})
        du  += r_t o k_t (v_t . dy_t)          (summed over b and t)
        G   <- diag(w_t) G + r_t dy_t^T

    Returns (dr, dk, dv, dw [b, h, s, hd], du [h, hd], dS0 = G) in fp32."""
    r, k, v, w, dy = (t.float() for t in (r, k, v, w, dy))
    u = u.float()
    S = S0.float()
    prev = []                                   # S_{t-1} for every t
    for t in range(r.shape[2]):
        prev.append(S)
        S = w[:, :, t, :, None] * S + k[:, :, t, :, None] * v[:, :, t, None, :]
    G = dS_T.float()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(r[:, :, 0])
    for t in reversed(range(r.shape[2])):
        rt, kt, vt, wt, dyt = (a[:, :, t] for a in (r, k, v, w, dy))
        vdy = (vt * dyt).sum(-1, keepdim=True)
        dr[:, :, t] = (torch.einsum("bhij,bhj->bhi", prev[t], dyt)
                       + u * kt * vdy)
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", G, vt) + u * rt * vdy
        dv[:, :, t] = (torch.einsum("bhij,bhi->bhj", G, kt)
                       + (u * rt * kt).sum(-1, keepdim=True) * dyt)
        dw[:, :, t] = (G * prev[t]).sum(-1)
        du = du + rt * kt * vdy
        G = wt[..., :, None] * G + rt[..., :, None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), G


def mamba2_bwd_ref(x, dt, decay, B, C, S0, dy, dS_T):
    """The backward of :func:`mamba2_ref`, one step at a time in reverse.

    The formulas the backward kernel computes (not autograd of the
    forward), all in fp32, in :func:`mamba2_ref`'s kernel layout (B, C
    one per head; dy [b, h, s, p], dS_T [b, h, p, n]).  The states come
    from a forward pass (never from dividing by decay_t, which may be
    0).  With G the cotangent of S_t, from G = dS_T:

        G       <- G + dy_t C_t^T
        dC_t     = S_t^T dy_t
        dx_t     = dt_t G B_t
        ddt_t    = x_t . (G B_t)
        dB_t     = G^T (dt_t x_t)
        ddecay_t = sum(G o S_{t-1})
        G       <- decay_t G

    Returns (dx [b, h, s, p], ddt, ddecay [b, h, s], dB, dC [b, h, s, n]
    per head, dS0 = G) in fp32."""
    x, dt, decay, B, C, dy = (t.float() for t in (x, dt, decay, B, C, dy))
    S = S0.float()
    states = [S]                                # S_t, t = -1 .. s-1
    for t in range(x.shape[2]):
        S = S * decay[:, :, t, None, None] + (
            (dt[:, :, t, None] * x[:, :, t])[..., :, None]
            * B[:, :, t, None, :])
        states.append(S)
    G = dS_T.float()
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    ddt, ddecay = torch.empty_like(dt), torch.empty_like(decay)
    for t in reversed(range(x.shape[2])):
        xt, Bt, Ct, dyt = (a[:, :, t] for a in (x, B, C, dy))
        G = G + dyt[..., :, None] * Ct[..., None, :]
        dC[:, :, t] = torch.einsum("bhpn,bhp->bhn", states[t + 1], dyt)
        gb = torch.einsum("bhpn,bhn->bhp", G, Bt)
        dx[:, :, t] = dt[:, :, t, None] * gb
        ddt[:, :, t] = (xt * gb).sum(-1)
        dB[:, :, t] = torch.einsum("bhpn,bhp->bhn", G,
                                   dt[:, :, t, None] * xt)
        ddecay[:, :, t] = (G * states[t]).sum((-2, -1))
        G = decay[:, :, t, None, None] * G
    return dx, ddt, ddecay, dB, dC, G


# ---------------------------------------------------------------------------
# fused momentum update + SpecTrain prediction


def fused_update_ref(w, v, g, *, lr: float, gamma: float, s: float,
                     what_dtype: Optional[torch.dtype] = None):
    """Momentum-SGD update (Eqs. 1-2) and weight prediction (Eq. 4).

    Twin of ``repro.kernels.ref.fused_update_ref``.  Returns (w', v', ŵ):

        v' = gamma * v + (1 - gamma) * g        (fp32)
        w' = w - lr * v'                        (w's dtype)
        ŵ  = w' - (s * lr) * v'                 (``what_dtype``, default
                                                 w's dtype)

    ``1 - gamma`` and ``s * lr`` are formed in double on the host, as the
    Pallas kernel forms them, then rounded to fp32 with every product."""
    vf = gamma * v.float() + (1.0 - gamma) * g.float()
    wf = w.float() - lr * vf
    what = wf - (s * lr) * vf
    return (wf.to(w.dtype), vf,
            what.to(w.dtype if what_dtype is None else what_dtype))
