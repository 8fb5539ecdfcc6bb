"""The chunked tensor-core forms of the two scans' backward kernels,
emulated on the CPU, against ``jax.grad`` of the JAX package's scan
oracles.

``csrc/mamba2_scan_bwd.cu`` and ``csrc/rwkv6_scan_bwd.cu`` take s >= 64
(``CHUNK_MIN_S``) on kernels that cannot run here.  This file carries
plain-torch emulations of their algorithms, :func:`emulate_ssd_bwd_chunked`
and :func:`emulate_wkv_bwd_chunked`, which keep what decides their
numbers:

  * time in chunks of 64 steps, a state S before each chunk and the
    cotangent G of the state after it, each found by a short walk over
    the chunks (forward for S, in reverse for G: ``ssd_bwd_states_kernel``,
    ``wkv_bwd_states_kernel``), then every chunk's gradients at once from
    its S and G (``ssd_bwd_chunk_kernel``, ``wkv_bwd_chunk_kernel``);
  * for RWKV-6 (a decay per channel) sub-chunks of 16 inside a chunk,
    each with its reference point: S and G carried from one to the next
    on the tensor cores, the pairs inside a sub-chunk on the CUDA cores
    in fp32 (the forward's structure, ``csrc/rwkv6_scan.cu``);
  * every decay factor a product of decays formed by running
    multiplications, never a quotient, never the exponential of a
    difference of sums; a masked step of a partial last chunk has decay 1
    and zero inputs;
  * the decay gradients without a quotient: ddecay_t = <G_t, S_{t-1}>
    (Mamba-2) and dw_t = rowsum(G_t o S_{t-1}) (RWKV-6) split into terms
    whose factors are products of the decays on either side of step t;
  * each product with an fp32-derived operand split into two TF32 parts
    and summed as a_hi b_hi + a_hi b_lo + a_lo b_hi (3xTF32, as
    ``tests/test_torch_scan_chunked.py`` emulates the forward's).

Tolerance: every output within 2e-5 of its largest magnitude (``BWD_TOL``)
of ``jax.vjp`` of ``repro/models/ssm.py``'s ``rwkv6_wkv_ref`` and
``mamba2_ssd_ref`` (the scans XLA differentiates to train these
families), at s = 64, 100 (a partial last chunk), 130 and 512, with exact
zero decays, nonzero S0 and dS_T, and Mamba-2 at g = 1 and g > 1.  A
contrast test shows why the decay gradient takes no quotient: formed as
d(log a) / a it is not finite at an exact zero decay.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.bench import scan_bwd_phases as phases
from test_torch_scan_chunked import CSRC, mm3, ssd_chunk_factors, \
    wkv_diag_scores, wkv_sub_factors
from test_torch_threads import one_thread  # noqa: F401

BWD_TOL = 2e-5          # of each output's largest magnitude
CHUNK, SUB = 64, 16
NSUB = CHUNK // SUB


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pad(t, c0, n, val):
    """Steps [c0, c0 + n) of a kernel-layout [b, h, s, ...] tensor padded
    to a whole chunk with ``val``."""
    fill = torch.full((*t.shape[:2], CHUNK - n, *t.shape[3:]), val)
    return torch.cat([t[:, :, c0:c0 + n], fill], 2)


# ---------------------------------------------------------------------------
# Mamba-2: one scalar decay a head and step


def emulate_ssd_bwd_chunked(x, dt, decay, B, C, S0, dy, dS_T, *,
                            passes: int = 3):
    """``mamba2_scan_bwd``'s chunked algorithm.  Model layouts: x, dy
    [b, s, h, p]; dt, decay [b, s, h]; B, C [b, s, g, n]; S0, dS_T
    [b, h, p, n] -> (dx, ddt, ddecay, dB, dC (each group's the sum over
    its heads in head order), dS0), fp32.  Per chunk, with L_ij =
    prod_{j<m<=i} a_m, A_i = prod_{m<=i} a_m, T_j = prod_{j<m<64} a_m
    (``ssd_chunk_factors``), S the state before the chunk and G the
    cotangent of the state after it:

        dx    = diag(dt) (((C B^T) o L)^T dy + diag(T) B G^T)
        ddt_j = x_j . (dx_j's bracket)
        dC    = diag(A) dy S + ((dy x^T) o L o dt) B
        dB    = ((dy x^T) o L o dt)^T C + diag(T dt) x G
        G    <- A_63 G + dy^T diag(A) C                  (the chunk before)
        ddecay_t = A_{t-1} R_t + Z_t + T_t (A_{t-1} <G, S> + F_t)

    with u_i = dy_i . S C_i, R_t = sum_{i>=t} L_it u_i, v_j = dt_j x_j .
    G B_j, F_t = sum_{j<t} L_{t-1,j} v_j and Z_t = sum_{i>=t} L_it P_i(t),
    P_i(t) = sum_{j<t} L_{t-1,j} dt_j (dy_i . x_j)(C_i . B_j), each a
    running recurrence over t (a product of decays, no quotient)."""
    b, s, h, p = x.shape
    g, nn = B.shape[2], B.shape[3]
    rep = h // g
    tr = lambda t: t.float().transpose(1, 2)
    X, DT, AD, DY = tr(x), tr(dt), tr(decay), tr(dy)
    Bh, Ch = (tr(t.repeat_interleave(rep, dim=2)) for t in (B, C))
    chunks = []
    for c0 in range(0, s, CHUNK):
        n = min(CHUNK, s - c0)
        xc, dyc, Bc, Cc, dtc = (_pad(t, c0, n, 0.0)
                                for t in (X, DY, Bh, Ch, DT))
        ac = _pad(AD, c0, n, 1.0)         # a masked step decays nothing
        chunks.append((c0, n, xc, dyc, Bc, Cc, dtc, ac)
                      + ssd_chunk_factors(ac))
    last = lambda A: A[..., -1, None, None]
    # ssd_bwd_states_kernel: the state before every chunk, the cotangent
    # of the state after every chunk
    S, Sb = S0.float(), []
    for c0, n, xc, dyc, Bc, Cc, dtc, ac, L, A, T in chunks:
        Sb.append(S)
        S = mm3((xc * (T * dtc)[..., None]).transpose(-1, -2), Bc,
                init=last(A) * S, passes=passes)
    G, Gb = dS_T.float(), [None] * len(chunks)
    for c in reversed(range(len(chunks))):
        c0, n, xc, dyc, Bc, Cc, dtc, ac, L, A, T = chunks[c]
        Gb[c] = G
        G = mm3((dyc * A[..., None]).transpose(-1, -2), Cc,
                init=last(A) * G, passes=passes)
    dS0 = G
    # ssd_bwd_chunk_kernel: every chunk's gradients
    dx, dBh, dCh = torch.zeros(b, h, s, p), torch.zeros(b, h, s, nn), \
        torch.zeros(b, h, s, nn)
    ddt, dde = torch.zeros(b, h, s), torch.zeros(b, h, s)
    strict = torch.tril(torch.ones(CHUNK, CHUNK), -1)
    for c, (c0, n, xc, dyc, Bc, Cc, dtc, ac, L, A, T) in enumerate(chunks):
        S, G = Sb[c], Gb[c]
        CB = mm3(Cc, Bc.transpose(-1, -2), passes=passes)      # [i, j]
        DX = mm3(dyc, xc.transpose(-1, -2), passes=passes)     # [i, j]
        dtj = dtc[..., None, :]
        M = CB * L
        N = DX * L * dtj
        W = DX * CB * dtj * strict
        H = mm3(Bc, G.transpose(-1, -2), passes=passes)        # [j, p]
        v = dtc * (xc * H).sum(-1)
        brk = mm3(M.transpose(-1, -2), dyc, init=T[..., None] * H,
                  passes=passes)
        dx[:, :, c0:c0 + n] = (dtc[..., None] * brk)[:, :, :n]
        ddt[:, :, c0:c0 + n] = (xc * brk).sum(-1)[:, :, :n]
        dYS = mm3(dyc, S, passes=passes)                       # [i, n]
        u = (dYS * Cc).sum(-1)
        dC = mm3(N, Bc, init=A[..., None] * dYS, passes=passes)
        dB = mm3(N.transpose(-1, -2), Cc,
                 init=(T * dtc)[..., None] * mm3(xc, G, passes=passes),
                 passes=passes)
        dCh[:, :, c0:c0 + n] = dC[:, :, :n]
        dBh[:, :, c0:c0 + n] = dB[:, :, :n]
        # the decay gradient: P_i(t) along each row i, Z_t the column sums
        # of L o P; R and F running recurrences over t
        P = torch.zeros(b, h, CHUNK)
        LP = torch.zeros(b, h, CHUNK, CHUNK)
        for t in range(CHUNK):
            LP[..., :, t] = L[..., :, t] * P
            P = ac[..., t, None] * P + W[..., :, t]
        Z = LP.sum(-2)
        R, F = torch.zeros(b, h, CHUNK), torch.zeros(b, h, CHUNK)
        acc = torch.zeros(b, h)
        for t in reversed(range(CHUNK)):
            acc = u[..., t] + (ac[..., t + 1] * acc if t + 1 < CHUNK
                               else 0.0)
            R[..., t] = acc
        acc = torch.zeros(b, h)
        for t in range(CHUNK):
            F[..., t] = acc
            acc = ac[..., t] * acc + v[..., t]
        Aprev = torch.cat([torch.ones(b, h, 1), A[..., :-1]], -1)
        gs = (G * S).sum((-2, -1))[..., None]
        d = Aprev * R + Z + T * (Aprev * gs + F)
        dde[:, :, c0:c0 + n] = d[:, :, :n]
    group = lambda t: t.reshape(b, g, rep, s, nn).sum(2).transpose(1, 2)
    back = lambda t: t.transpose(1, 2)
    return (back(dx), back(ddt), back(dde), group(dBh), group(dCh), dS0)


# ---------------------------------------------------------------------------
# RWKV-6: a decay per channel, sub-chunks of 16 with reference points


def _wkv_sub_grads(rs, ks, vs, ws, dys, u, S, G, passes):
    """One sub-chunk's gradients from S (the state at its first step) and
    G (the cotangent of the state after its last), kernel layout [b, h,
    16, hd]: the cross terms on the tensor cores, the pairs inside the
    sub-chunk on the CUDA cores by running products."""
    Qf, Kf, _ = wkv_sub_factors(ws)
    dYS = mm3(dys, S.transpose(-1, -2), passes=passes)     # [t, i]
    VG = mm3(vs, G.transpose(-1, -2), passes=passes)       # [s, i]
    E = mm3(dys, vs.transpose(-1, -2), passes=passes)      # [t, s]
    A = wkv_diag_scores(rs, ks, ws, u)                     # [t, s]
    dv = mm3(A.transpose(-1, -2), dys, init=mm3(ks * Kf, G, passes=passes),
             passes=passes)
    gs = (G * S).sum(-1)[..., None, :]                     # [1, i]
    Ed = torch.diagonal(E, dim1=-2, dim2=-1)[..., None]    # E_tt
    zero = torch.zeros_like(rs[..., 0, :])
    dr, dk, F, R, bt = ([zero] * SUB for _ in range(5))
    for t in range(SUB):
        fac = torch.ones_like(zero)             # prod_{s<m<t} w_m
        for s_ in reversed(range(t)):
            dr[t] = dr[t] + ks[..., s_, :] * fac * E[..., t, s_, None]
            F[t] = F[t] + ks[..., s_, :] * fac * VG[..., s_, :]
            fac = fac * ws[..., s_, :]
        fac = torch.ones_like(zero)             # prod_{t<m<tau} w_m
        for tau in range(t + 1, SUB):
            dk[t] = dk[t] + rs[..., tau, :] * fac * E[..., tau, t, None]
            R[t] = R[t] + rs[..., tau, :] * fac * dYS[..., tau, :]
            fac = fac * ws[..., tau, :]
    for tau in range(SUB):
        # P_tau(t) = sum_{s<t} prod_{s<m<t} w_m k_s E[tau, s], t <= tau
        Pt, P = [], torch.zeros_like(zero)
        for t in range(tau):
            Pt.append(P)
            P = ws[..., t, :] * P + ks[..., t, :] * E[..., tau, t, None]
        fac = torch.ones_like(zero)             # prod_{t<m<tau} w_m
        for t in reversed(range(tau)):
            bt[t] = bt[t] + rs[..., tau, :] * fac * Pt[t]
            fac = fac * ws[..., t, :]
    st = lambda xs: torch.stack(xs, -2)
    uq = u[..., None, :]
    dr = Qf * dYS + st(dr) + uq * ks * Ed
    dk = Kf * VG + st(dk) + uq * rs * Ed
    dw = Kf * Qf * gs + Kf * st(F) + Qf * st(R) + st(bt)
    du = (rs * ks * Ed).sum(-2)
    return dr, dk, dv, dw, du


def emulate_wkv_bwd_chunked(r, k, v, w, u, S0, dy, dS_T, *,
                            passes: int = 3):
    """``rwkv6_scan_bwd``'s chunked algorithm.  Model layout: r, k, v, w,
    dy [b, s, h, hd]; u [h, hd]; S0, dS_T [b, h, hd, hd] (key x value) ->
    (dr, dk, dv, dw, du [h, hd], dS0), fp32.  Per sub-chunk of 16 with
    Q_t = prod_{start<=m<t} w_m, K_s = prod_{s<m<end} w_m, W its whole
    product (per channel, ``wkv_sub_factors``), S the state at its first
    step and G the cotangent of the state after its last:

        dr_t = Q_t o (S dy_t) + sum_{s<t} k_s o prod_{s<m<t} w (v_s . dy_t)
               + u o k_t (v_t . dy_t)
        dk_s = K_s o (G v_s) + sum_{t>s} r_t o prod_{s<m<t} w (v_s . dy_t)
               + u o r_s (v_s . dy_s)
        dv   = (k o K) G + A^T dy       (A: the forward's scores, bonus
                                         on the diagonal)
        dw_t = K_t Q_t rowsum(G o S) + K_t F_t + Q_t R_t + b_t
        S   <- diag(W) S + (k o K)^T v,   G <- diag(W) G + (r o Q)^T dy

    with F_t = sum_{s<t} prod_{s<m<t} w k_s (G v_s), R_t = sum_{t'>t}
    prod_{t<m<t'} w r_t' (S dy_t') and b_t the pairs s < t < t' inside
    the sub-chunk, each factor a running product of decays."""
    b, s, h, hd = r.shape
    tr = lambda t: t.float().transpose(1, 2)
    R_, K_, V_, W_, DY = (tr(t) for t in (r, k, v, w, dy))
    uu = u.float()[None]
    chunks = []
    for c0 in range(0, s, CHUNK):
        n = min(CHUNK, s - c0)
        tiles = [_pad(t, c0, n, 0.0) for t in (R_, K_, V_, DY)]
        wc = _pad(W_, c0, n, 1.0)         # a masked step decays nothing
        subs = []
        for lo in range(0, CHUNK, SUB):
            sl = slice(lo, lo + SUB)
            rs, ks, vs, dys = (t[:, :, sl] for t in tiles)
            subs.append((rs, ks, vs, wc[:, :, sl], dys)
                        + wkv_sub_factors(wc[:, :, sl]))
        chunks.append((c0, n, subs))

    def step_S(S, sub):
        rs, ks, vs, ws, dys, Qf, Kf, Wf = sub
        return mm3((ks * Kf).transpose(-1, -2), vs,
                   init=Wf[..., None] * S, passes=passes)

    def step_G(G, sub):
        rs, ks, vs, ws, dys, Qf, Kf, Wf = sub
        return mm3((rs * Qf).transpose(-1, -2), dys,
                   init=Wf[..., None] * G, passes=passes)
    # wkv_bwd_states_kernel: the boundary states and cotangents
    S, Sb = S0.float(), []
    for c0, n, subs in chunks:
        Sb.append(S)
        for sub in subs:
            S = step_S(S, sub)
    G, Gb = dS_T.float(), [None] * len(chunks)
    for c in reversed(range(len(chunks))):
        Gb[c] = G
        for sub in reversed(chunks[c][2]):
            G = step_G(G, sub)
    dS0 = G
    # wkv_bwd_chunk_kernel: every chunk's gradients
    out = [torch.zeros(b, h, s, hd) for _ in range(4)]
    du = torch.zeros(h, hd)
    for c, (c0, n, subs) in enumerate(chunks):
        Ss = [Sb[c]]
        for sub in subs[:-1]:
            Ss.append(step_S(Ss[-1], sub))
        G = Gb[c]
        for q in reversed(range(NSUB)):
            rs, ks, vs, ws, dys = subs[q][:5]
            grads = _wkv_sub_grads(rs, ks, vs, ws, dys, uu, Ss[q], G,
                                   passes)
            lo = c0 + q * SUB
            m = max(0, min(SUB, c0 + n - lo))
            for o, gr in zip(out, grads[:4]):
                o[:, :, lo:lo + m] = gr[:, :, :m]
            du = du + grads[4].sum(0)
            G = step_G(G, subs[q])
    back = lambda t: t.transpose(1, 2)
    return tuple(back(o) for o in out) + (du, dS0)


# ---------------------------------------------------------------------------
# inputs, and the JAX package's gradients


def _rwkv_case(seed, b, s, h, hd):
    """The models' decays (w = exp(-exp(logw)), logw in [-3, 4.2]: down to
    ~1e-29) with exact zeros and ones, nonzero S0 and dS_T."""
    rng = np.random.default_rng(seed)
    f = lambda *sh, sc=1.0: (rng.standard_normal(sh) * sc).astype(
        np.float32)
    w = np.exp(-np.exp(rng.uniform(-3.0, 4.2, (b, s, h, hd))))
    w = w.astype(np.float32)
    w.flat[::13] = 0.0
    w.flat[5::17] = 1.0
    return (f(b, s, h, hd), f(b, s, h, hd, sc=0.3), f(b, s, h, hd), w,
            f(h, hd, sc=0.3), f(b, h, hd, hd, sc=0.3), f(b, s, h, hd),
            f(b, h, hd, hd, sc=0.3))


def _mamba_case(seed, b, s, h, p, n, g):
    """zamba2's decays (exp(-U(0, 11.5)): down to ~1e-5) with exact zeros
    and ones, dt = softplus(N(0, 1)), nonzero S0 and dS_T."""
    rng = np.random.default_rng(seed)
    f = lambda *sh, sc=1.0: (rng.standard_normal(sh) * sc).astype(
        np.float32)
    decay = np.exp(-rng.uniform(0.0, 11.5, (b, s, h))).astype(np.float32)
    decay.flat[::11] = 0.0
    decay.flat[4::13] = 1.0
    dt = np.log1p(np.exp(f(b, s, h))).astype(np.float32)
    return (f(b, s, h, p), dt, decay, f(b, s, g, n, sc=0.5),
            f(b, s, g, n, sc=0.5), f(b, h, p, n, sc=0.3), f(b, s, h, p),
            f(b, h, p, n, sc=0.3))


def _jax_grads(fn, args):
    """jax.vjp of the oracle at the inputs, with the cotangents dy, dS_T."""
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args[:6]))
    return [np.asarray(a) for a in vjp((jnp.asarray(args[6]),
                                        jnp.asarray(args[7])))]


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _check_all(names, got, want):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert np.isfinite(g).all(), name
        err = _rel_err(g, w)
        assert err <= BWD_TOL, f"{name}: {err:.3e} of its max"


RWKV_NAMES = ("dr", "dk", "dv", "dw", "du", "dS0")
MAMBA_NAMES = ("dx", "ddt", "ddecay", "dB", "dC", "dS0")


# ---------------------------------------------------------------------------
# the emulations against jax.grad of the oracles


@pytest.mark.parametrize("s", [64, 100, 130, 512])
def test_emulated_wkv_bwd_matches_jax_grad(s):
    b, h, hd = (1, 1, 16) if s == 512 else (2, 2, 16)
    args = _rwkv_case(200 + s, b, s, h, hd)
    assert (args[3] == 0).any() and args[3][args[3] > 0].min() < 1e-25
    want = _jax_grads(jssm.rwkv6_wkv_ref, args)
    got = emulate_wkv_bwd_chunked(*map(_t, args))
    _check_all(RWKV_NAMES, got, want)


def test_emulated_wkv_bwd_full_head_size():
    """hd 64 (rwkv6-7b's), bf16-rounded r, k, v, dy (the main path's:
    exact in TF32)."""
    args = list(_rwkv_case(260, 1, 100, 1, 64))
    for i in (0, 1, 2, 6):
        args[i] = _t(args[i]).to(torch.bfloat16).float().numpy()
    want = _jax_grads(jssm.rwkv6_wkv_ref, args)
    got = emulate_wkv_bwd_chunked(*map(_t, args))
    _check_all(RWKV_NAMES, got, want)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [64, 100, 130, 512])
def test_emulated_ssd_bwd_matches_jax_grad(s, g):
    args = _mamba_case(300 + s + g, 2, s, 4, 16, 32, g)
    assert (args[2] == 0).any()
    want = _jax_grads(jssm.mamba2_ssd_ref, args)
    got = emulate_ssd_bwd_chunked(*map(_t, args))
    _check_all(MAMBA_NAMES, got, want)


def test_emulated_ssd_bwd_full_width():
    """zamba2-1.2b's p 64, n 64, g 1, bf16-rounded x, B, C."""
    args = list(_mamba_case(390, 1, 130, 2, 64, 64, 1))
    for i in (0, 3, 4):
        args[i] = _t(args[i]).to(torch.bfloat16).float().numpy()
    want = _jax_grads(jssm.mamba2_ssd_ref, args)
    got = emulate_ssd_bwd_chunked(*map(_t, args))
    _check_all(MAMBA_NAMES, got, want)


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_emulations_match_plain_backward(kind):
    """The emulation and the wrapper's CPU path (the plain backward, the
    kernels' oracle) on the same inputs, at 2e-5 of each output's
    largest magnitude, in the wrappers' output layouts."""
    if kind == "rwkv6":
        args = [_t(a) for a in _rwkv_case(410, 1, 130, 2, 32)]
        got = emulate_wkv_bwd_chunked(*args)
        want = r6.rwkv6_scan_bwd(*args)
        names = RWKV_NAMES
    else:
        args = [_t(a) for a in _mamba_case(411, 1, 130, 4, 32, 16, 2)]
        got = emulate_ssd_bwd_chunked(*args)
        want = m2.mamba2_scan_bwd(*args)
        names = MAMBA_NAMES
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
    _check_all(names, got, [w.numpy() for w in want])


# ---------------------------------------------------------------------------
# why the decay gradients take no quotient


def _ddecay_by_quotient(kind, args):
    """The decay gradient as other implementations form it, from the
    states after each step (no S_{t-1} kept): d(log a)_t = <G_t, S_t> -
    (the step's input term), then divided by a_t.  Kernel layout, plain
    fp32 steps."""
    if kind == "mamba2":
        x, dt, decay, B, C, S0, dy, dS_T = (_t(a) for a in args)
        S, G, states = S0, dS_T, []
        for t in range(x.shape[1]):
            S = decay[:, t, :, None, None] * S + (
                (dt[:, t, :, None] * x[:, t])[..., None]
                * B[:, t, :, None, :])
            states.append(S)
        out = torch.zeros_like(decay)
        for t in reversed(range(x.shape[1])):
            G = G + dy[:, t, :, :, None] * C[:, t, :, None, :]
            inp = ((dt[:, t, :, None] * x[:, t])[..., None]
                   * B[:, t, :, None, :])
            out[:, t] = ((G * (states[t] - inp)).sum((-2, -1))
                         / decay[:, t])
            G = decay[:, t, :, None, None] * G
        return out
    r, k, v, w, u, S0, dy, dS_T = (_t(a) for a in args)
    S, G, states = S0, dS_T, []
    for t in range(r.shape[1]):
        S = w[:, t, ..., None] * S + k[:, t, ..., None] * v[:, t, :, None, :]
        states.append(S)
    out = torch.zeros_like(w)
    for t in reversed(range(r.shape[1])):
        kv = k[:, t, ..., None] * v[:, t, :, None, :]
        out[:, t] = (G * (states[t] - kv)).sum(-1) / w[:, t]
        G = w[:, t, ..., None] * G + r[:, t, ..., None] * dy[:, t, :, None]
    return out


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_decay_gradient_by_quotient_fails_at_zero_decay(kind):
    """d(log a) / a is 0 / 0 at an exact zero decay (a reset): not finite
    there, while the product form the kernels take is finite and within
    2e-5 of jax.grad on the same inputs."""
    if kind == "rwkv6":
        args = _rwkv_case(500, 1, 70, 1, 16)
        want = _jax_grads(jssm.rwkv6_wkv_ref, args)[3]
        got = emulate_wkv_bwd_chunked(*map(_t, args))[3]
        zero = args[3] == 0
    else:
        args = _mamba_case(501, 1, 70, 2, 16, 16, 1)
        want = _jax_grads(jssm.mamba2_ssd_ref, args)[2]
        got = emulate_ssd_bwd_chunked(*map(_t, args))[2]
        zero = args[2] == 0
    assert zero.any()
    assert np.isfinite(got.numpy()).all()
    assert _rel_err(got, want) <= BWD_TOL
    bad = _ddecay_by_quotient(kind, args).numpy()
    assert not np.isfinite(bad[zero]).any()
    assert np.isfinite(want).all()


def test_single_tf32_product_misses_tolerance():
    """One TF32 product where the kernels take three: the backward
    leaves the 2e-5 envelope that 3xTF32 keeps (fp32 inputs)."""
    args = _mamba_case(510, 1, 130, 2, 16, 32, 1)
    want = _jax_grads(jssm.mamba2_ssd_ref, args)
    one = emulate_ssd_bwd_chunked(*map(_t, args), passes=1)
    assert max(_rel_err(g, w) for g, w in zip(one, want)) > BWD_TOL


# ---------------------------------------------------------------------------
# the kernels' source, and the wrappers' routing


@pytest.mark.parametrize("src,name", [
    ("mamba2_scan_bwd.cu", "ssd_bwd_states_kernel"),
    ("mamba2_scan_bwd.cu", "ssd_bwd_chunk_kernel"),
    ("rwkv6_scan_bwd.cu", "wkv_bwd_states_kernel"),
    ("rwkv6_scan_bwd.cu", "wkv_bwd_chunk_kernel")])
def test_bwd_kernel_source_forms_decays_by_products(src, name):
    """The chunked backward kernels divide only integers (index
    arithmetic by compile-time constants, and heads by groups) and take
    no exponential, logarithm or reciprocal: every decay factor and every
    decay gradient is formed by multiplying decays.  Their products run
    on the tensor cores (``mma.sync ... tf32`` through
    ``scan_mma.cuh``)."""
    text = re.sub(r"//[^\n]*", "", (CSRC / src).read_text())
    start = re.search(rf"\b{name}\(Params p\)", text).start()
    depth, i = 0, text.index("{", start)
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            break
    body = text[i:j + 1]
    divisors = re.findall(r"/\s*\(?\s*([\w:.]+)", body)
    for d in divisors:
        assert re.fullmatch(r"\d+|[A-Z][A-Z0-9_]*|sizeof|p\.[hg]", d), d
    banned = re.findall(r"\b(?:__)?(?:exp2?f?|log2?f?|fdividef|frcp\w*|"
                        r"rcp\w*|ex2\w*|lg2\w*)\b", body)
    assert not banned, banned
    assert "sm::warp_mma<" in body
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in \
        (CSRC / "scan_mma.cuh").read_text()


@pytest.mark.parametrize("s,want", [(1, "step"), (12, "step"),
                                    (63, "step"), (64, "chunk"),
                                    (100, "chunk"), (2048, "chunk")])
def test_bwd_wrappers_route_by_sequence_length(s, want):
    assert r6.bwd_variant(s) == want and m2.bwd_variant(s) == want


def test_cpu_bwd_counts_no_variant():
    """The CPU path (the plain backward) counts no launch; the chunked
    backward variants have their keys."""
    ops.reset_launch_counts()
    for s in (12, 64):
        a = [_t(x) for x in _rwkv_case(5, 1, s, 2, 16)]
        r6.rwkv6_scan_bwd(*a)
        a = [_t(x) for x in _mamba_case(5, 1, s, 2, 16, 16, 1)]
        m2.mamba2_scan_bwd(*a)
    assert set(ops.launch_counts().values()) == {0}
    assert set(ops.variant_counts().values()) == {0}
    assert {"rwkv6_scan_bwd_chunk", "mamba2_scan_bwd_chunk"} <= \
        set(ops.variant_counts())


@pytest.mark.parametrize("src", sorted(phases.KERNELS))
def test_phase_profiler_marks_every_barrier(src):
    """``bench/scan_bwd_phases.py`` finds its kernels in the backward
    sources by pattern: each kernel it names is found, every barrier of
    its body gets one mark and a label, the counters and the entry point
    that reads them are added once, and the include it rewrites is
    there.  A change to the sources that the profiler no longer reads
    fails here, not on the card."""
    text = (CSRC / f"{src}.cu").read_text()
    assert '#include "scan_mma.cuh"' in text
    out, labels = phases.instrument(text, phases.KERNELS[src])
    mark = "_last = _n; }"
    for name in phases.KERNELS[src]:
        i, j = phases._body(text, name)
        barriers = sum("__syncthreads();" in line.split("//")[0]
                       for line in text[i:j].split("\n"))
        assert barriers > 1, name
        assert barriers + 1 < phases.SLOTS, name
        n = sorted(k for nm, k in labels if nm == name)
        assert n == list(range(barriers + 1)), name
        a, b = phases._body(out, name)
        assert out[a:b].count(mark) == barriers, name
    assert out.count("__device__ unsigned long long g_phase[") == 1
    assert out.count('extern "C" int repro_phase_read(') == 1
