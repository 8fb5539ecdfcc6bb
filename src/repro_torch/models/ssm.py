"""Attention-free sequence mixers: RWKV-6 ("Finch") and Mamba-2 (SSD)
(twin of ``repro/models/ssm.py``).

Both mixers take a whole sequence ``x [b, s, d]`` and an optional
recurrent state; with a state they write the state after the sequence
into it in place (it views one layer's slot of the model's cache, as a
KV cache does in ``attention.gqa_apply``) and return its leaves, so one
call serves a prompt (prefill) and a one-token decode step alike.
Without a state (training and the reference forward) they start from
zeros and are differentiable.  On a tensor axis (``models.tensor_axis``)
a rank holds the heads ``spec_for_leaf(logical_rules)`` gives it and
reads its widths off the weights: rwkv6's token shift, LoRA mixes and
decay are replicated, the decay narrowed to the rank's heads, the scan
and the per-head group norm run at H / T heads and ``wo`` / ``wcv`` are
row-parallel; mamba2's ``w_zx`` (its z and x blocks), ``w_dt`` and the
x conv are the rank's heads, B and C replicated, the gated norm's mean
over the whole ``d_in`` through one all-reduce of the sums of squares,
``w_out`` row-parallel.  The recurrence itself goes through
``kernels.ops.rwkv6_scan`` / ``kernels.ops.mamba2_scan``: the
hand-written kernels on the card (forward, and under autograd the
backward kernel), the sequential plain versions on the CPU, for every
sequence length.  The JAX package's chunked XLA forms (``USE_CHUNKED``,
off by default) are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import tensor_axis as tp
from repro_torch.models.layers import ParamSpec, groupnorm_heads

State = Dict[str, Any]

# ===========================================================================
# RWKV-6 time-mix + channel-mix
# ===========================================================================

_RWKV_LORA_MIX = 32
_RWKV_LORA_DECAY = 64


def rwkv6_tm_specs(cfg):
    d = cfg.d_model
    return {
        "mu_x": ParamSpec((d,), ("embed",), "uniform", 0.5),
        "mus": ParamSpec((5, d), (None, "embed"), "uniform", 0.5),
        "mix_A": ParamSpec((d, 5 * _RWKV_LORA_MIX), ("embed", None)),
        "mix_B": ParamSpec((5, _RWKV_LORA_MIX, d), (None, None, "embed")),
        "w0": ParamSpec((d,), ("embed",), "uniform", 1.0),
        "dw_A": ParamSpec((d, _RWKV_LORA_DECAY), ("embed", None)),
        "dw_B": ParamSpec((_RWKV_LORA_DECAY, d), (None, "embed")),
        "u": ParamSpec((d,), ("heads",), "uniform", 0.5),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "gn_scale": ParamSpec((d,), ("heads",), "ones"),
        "gn_bias": ParamSpec((d,), ("heads",), "zeros"),
    }


def rwkv6_cm_specs(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_ck": ParamSpec((d,), ("embed",), "uniform", 0.5),
        "mu_cr": ParamSpec((d,), ("embed",), "uniform", 0.5),
        "wck": ParamSpec((d, ff), ("embed", "mlp")),
        "wcv": ParamSpec((ff, d), ("mlp", "embed")),
        "wcr": ParamSpec((d, d), ("embed", "embed2")),
    }


def _token_shift(x, prev):
    """prev: [b, d], the token before x[:, 0] (zeros at stream start)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def rwkv6_tm_apply(cfg, p, x, state: Optional[State] = None
                   ) -> Tuple[torch.Tensor, Optional[State]]:
    """x: [b, s, d] (already normed).  state carries (x_tm, S), updated
    in place."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    b, s, _ = x.shape
    dt = x.dtype
    # the heads this rank holds (models.tensor_axis): all, or H / T
    dl = p["wr"].shape[-1]
    H = dl // hd
    blk = tp.rank_block(d, dl)
    prev = state["x_tm"] if state is not None else x.new_zeros((b, d))
    xp = _token_shift(x, prev)
    sx = xp - x
    xxx = x + sx * p["mu_x"].to(dt)
    zmix = torch.tanh(xxx @ p["mix_A"].to(dt)).reshape(
        b, s, 5, _RWKV_LORA_MIX)
    mix = torch.einsum("bsfk,fkd->bsfd", zmix, p["mix_B"].to(dt))
    comp = x[:, :, None, :] + sx[:, :, None, :] * (
        p["mus"].to(dt)[None, None] + mix)
    xw = comp[:, :, 0]
    # the mixes entering the rank's heads take copy_in (one for the four)
    xk, xv, xr, xg = (comp[:, :, 1:] if blk is None
                      else tp.copy_in(comp[:, :, 1:])).unbind(2)

    logw = p["w0"].float() + (
        torch.tanh(xw @ p["dw_A"].to(dt)) @ p["dw_B"].to(dt)).float()
    w = torch.exp(-torch.exp(logw))                       # [b, s, d] in (0, 1)
    if blk is not None:     # computed whole, narrowed to the rank's heads
        w = tp.copy_in(w)[..., blk * dl:(blk + 1) * dl]

    r = (xr @ p["wr"].to(dt)).reshape(b, s, H, hd)
    k = (xk @ p["wk"].to(dt)).reshape(b, s, H, hd)
    v = (xv @ p["wv"].to(dt)).reshape(b, s, H, hd)
    g = F.silu(xg @ p["wg"].to(dt))
    wh = w.reshape(b, s, H, hd)
    u = p["u"].float().reshape(H, hd)

    S0 = (state["S"] if state is not None
          else torch.zeros((b, H, hd, hd), dtype=torch.float32,
                           device=x.device))
    y, _ = ops.rwkv6_scan(r, k, v, wh, u, S0,
                          out=None if state is None else S0)   # y in dt
    y = groupnorm_heads(y.reshape(b, s, dl), p["gn_scale"], p["gn_bias"],
                        H)
    out = (y * g) @ p["wo"].to(dt)
    if blk is not None:
        out = tp.reduce_out(out)
    if state is None:
        return out, None
    state["x_tm"].copy_(x[:, -1, :])
    return out, {"x_tm": state["x_tm"], "S": state["S"]}


def rwkv6_cm_apply(cfg, p, x, state: Optional[State] = None):
    """state carries x_cm, updated in place."""
    dt = x.dtype
    b = x.shape[0]
    prev = (state["x_cm"] if state is not None
            else x.new_zeros((b, cfg.d_model)))
    xp = _token_shift(x, prev)
    sx = xp - x
    xk = x + sx * p["mu_ck"].to(dt)
    xr = x + sx * p["mu_cr"].to(dt)
    # on a tensor axis: wck column- and wcv row-parallel, the sum over
    # the ranks before the replicated receptance gate
    split = tp.rank_block(cfg.d_ff, p["wck"].shape[-1]) is not None
    if split:
        xk = tp.copy_in(xk)
    h = torch.square(torch.relu(xk @ p["wck"].to(dt)))
    v = h @ p["wcv"].to(dt)
    if split:
        v = tp.reduce_out(v)
    out = torch.sigmoid(xr @ p["wcr"].to(dt)) * v
    if state is None:
        return out, None
    state["x_cm"].copy_(x[:, -1, :])
    return out, {"x_cm": state["x_cm"]}


def rwkv6_init_state(cfg, batch: int, dtype, device) -> State:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    return {"x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
            "S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device)}


# ===========================================================================
# Mamba-2 (SSD)
# ===========================================================================


def mamba2_specs(cfg):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    bc = 2 * s.n_groups * s.d_state
    return {
        "w_zx": ParamSpec((d, 2 * d_in), ("embed", "ssm")),
        "w_bc": ParamSpec((d, bc), ("embed", None)),
        "w_dt": ParamSpec((d, nh), ("embed", "heads")),
        "conv_x_w": ParamSpec((s.conv_kernel, d_in), (None, "ssm")),
        "conv_x_b": ParamSpec((d_in,), ("ssm",), "zeros"),
        "conv_bc_w": ParamSpec((s.conv_kernel, bc), (None, None)),
        "conv_bc_b": ParamSpec((bc,), (None,), "zeros"),
        "A_log": ParamSpec((nh,), ("heads",), "uniform", 1.0),
        "D": ParamSpec((nh,), ("heads",), "ones"),
        "dt_bias": ParamSpec((nh,), ("heads",), "uniform", 1.0),
        "norm_scale": ParamSpec((d_in,), ("ssm",), "ones"),
        "w_out": ParamSpec((d_in, d), ("ssm", "embed")),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv.  x: [b, s, c]; w: [k, c]; conv_state:
    [b, k-1, c], the last k-1 inputs before x.  The new state is the last
    k-1 rows of ``[conv_state, x]``, so after a prompt shorter than k-1
    it still holds part of the old state (zeros at stream start)."""
    kk = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], kk - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, j:j + x.shape[1], :] * w[j][None, None, :]
            for j in range(kk))
    new_state = xp[:, -(kk - 1):, :] if conv_state is not None else None
    return y + b[None, None, :], new_state


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus switches to
    # the identity above a threshold)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba2_apply(cfg, p, x, state: Optional[State] = None
                 ) -> Tuple[torch.Tensor, Optional[State]]:
    """x: [b, s, d] (already normed).  state carries (conv_x, conv_bc,
    S), updated in place."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    hd = s.head_dim
    b, sl, _ = x.shape
    dt_ = x.dtype
    # the heads this rank holds (models.tensor_axis): all, or nh / T,
    # w_zx as the pair of its z and x blocks (sharding.TENSOR_PARTS)
    d_in_l = p["w_zx"].shape[-1] // 2
    nh = p["w_dt"].shape[-1]
    blk = tp.rank_block(d_in, d_in_l)
    if nh * hd != d_in_l:
        raise ValueError(f"mamba2: {nh} heads of {hd} held against "
                         f"{d_in_l} of w_zx's columns")
    xi = x if blk is None else tp.copy_in(x)

    z, xr = (xi @ p["w_zx"].to(dt_)).chunk(2, dim=-1)
    bc = x @ p["w_bc"].to(dt_)
    delta = _softplus((xi @ p["w_dt"].to(dt_)).float()
                      + p["dt_bias"].float())               # [b, s, nh]

    cs_x = state["conv_x"] if state is not None else None
    cs_bc = state["conv_bc"] if state is not None else None
    xr, new_cs_x = _causal_conv(xr, p["conv_x_w"].to(dt_),
                                p["conv_x_b"].to(dt_), cs_x)
    bc, new_cs_bc = _causal_conv(bc, p["conv_bc_w"].to(dt_),
                                 p["conv_bc_b"].to(dt_), cs_bc)
    xr = F.silu(xr)
    bc = F.silu(bc)
    if blk is not None:     # B and C serve every head
        bc = tp.copy_in(bc)
    B, C = bc.chunk(2, dim=-1)
    B = B.reshape(b, sl, s.n_groups, s.d_state)             # views of bc
    C = C.reshape(b, sl, s.n_groups, s.d_state)

    a = -torch.exp(p["A_log"].float())                      # (nh,)
    decay = torch.exp(a[None, None, :] * delta)             # [b, s, nh]
    xh = xr.reshape(b, sl, nh, hd)

    S0 = (state["S"] if state is not None
          else torch.zeros((b, nh, hd, s.d_state), dtype=torch.float32,
                           device=x.device))
    y, _ = ops.mamba2_scan(xh, delta, decay, B, C, S0,
                           out=None if state is None else S0)  # y fp32
    y = y + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, sl, d_in_l).to(dt_)

    # gated RMSNorm, its mean over the whole d_in: on a tensor axis the
    # ranks' sums of squares summed (reduce_out), that total entering
    # the rank's elements (copy_in)
    y = y * F.silu(z)
    yf = y.float()
    if blk is None:
        ms = yf.square().mean(dim=-1, keepdim=True)
    else:
        ms = tp.copy_in(tp.reduce_out(
            yf.square().sum(dim=-1, keepdim=True))) / d_in
    y = (yf * torch.rsqrt(ms + 1e-5) * p["norm_scale"].float()).to(dt_)
    out = y @ p["w_out"].to(dt_)
    if blk is not None:
        out = tp.reduce_out(out)

    if state is None:
        return out, None
    state["conv_x"].copy_(new_cs_x)
    state["conv_bc"].copy_(new_cs_bc)
    return out, {k: state[k] for k in ("conv_x", "conv_bc", "S")}


def mamba2_init_state(cfg, batch: int, dtype, device) -> State:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    bc = 2 * s.n_groups * s.d_state
    return {
        "conv_x": torch.zeros((batch, s.conv_kernel - 1, d_in),
                              dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, s.conv_kernel - 1, bc),
                               dtype=dtype, device=device),
        "S": torch.zeros((batch, nh, s.head_dim, s.d_state),
                         dtype=torch.float32, device=device),
    }
