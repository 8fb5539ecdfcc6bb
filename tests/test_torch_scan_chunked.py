"""The chunked tensor-core forms of the two scan kernels, emulated on the
CPU, against the JAX package's sequential recurrences.

``csrc/rwkv6_scan.cu::wkv_chunk_kernel`` and ``csrc/mamba2_scan.cu::
ssd_chunk_kernel`` (the variants the wrappers take at s >= 64) cannot run
here.  This file carries plain-torch emulations of their algorithms,
:func:`emulate_wkv_chunked` and :func:`emulate_ssd_chunked`, which keep
what decides their numbers:

  * time in chunks of 64 steps (the kernels' cp.async tiles), and for
    RWKV-6 sub-chunks of 16 with the state carried from one sub-chunk's
    first step (its reference point) to the next;
  * every decay factor a product of the decays in its span, formed by
    running multiplications in the kernels' order, never a quotient and
    never the exponential of a difference of cumulative sums; a masked
    step of a partial last chunk has decay 1;
  * each product with an fp32-derived operand split into two TF32 parts
    (hi: 13 low mantissa bits rounded away, ties away from zero; lo = x -
    hi, of which the tensor core reads the TF32 part) and computed as
    a_hi b_hi + a_hi b_lo + a_lo b_hi, as the
    kernels' three ``mma.sync.m16n8k8`` TF32 products with an fp32
    accumulator do (an operand that is already TF32, as a bf16 value
    is, has a zero low part);
  * RWKV-6's diagonal sub-chunk scores and its bonus on the CUDA cores
    in fp32, their product with v on the tensor cores.

Tolerances: 2e-5 (atol and rtol) on y and S_T against the JAX package's
sequential ``repro/kernels/ref.py`` scans (``SCAN_TOL`` of the card
checks), at the decays the models draw (RWKV-6 down to ~1e-30, Mamba-2
down to ~1e-5) with exact zeros among them; atol 5e-3 / rtol 1e-3 against
the Pallas kernels in interpret mode inside their envelope, as
``tests/test_torch_ssm.py`` holds the plain versions.  Two contrast tests
show why the design is what it is: one TF32 product in place of three
misses 2e-5 in both kernels, and factors formed as exp of differences of
chunk-start cumulative sums miss it at RWKV-6's decays.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as r6
from test_torch_ssm import _jax_mamba_ref, _mamba_inputs, _rwkv_inputs
from test_torch_ssm import _t, _tr
from test_torch_threads import one_thread  # noqa: F401

CHUNK_TOL = 2e-5
PALLAS_ATOL, PALLAS_RTOL = 5e-3, 1e-3
CHUNK, SUB = 64, 16
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"


# ---------------------------------------------------------------------------
# TF32 and the 3xTF32 product


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as the kernels round: half a TF32 unit added to the magnitude
    bits, the 13 low bits cleared (what ``cvt.rna.tf32.f32`` gives)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 operand: its TF32 part, the
    13 low mantissa bits ignored (towards zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """x = hi + lo: hi rounded to TF32, lo = x - hi (exact in fp32) as
    the tensor core reads it."""
    hi = tf32(x)
    return hi, tf32_trunc(x - hi)


def mm3(a, b, init=None, passes: int = 3):
    """a @ b as the kernels form it on the tensor cores: both operands
    split into TF32 parts, the small products first into the fp32
    accumulator (which starts at ``init``), then a_hi b_hi.  ``passes=1``
    is a single TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = torch.zeros(()) if init is None else init
    if passes == 3:
        acc = acc + al @ bh
        acc = acc + ah @ bl
    return acc + ah @ bh


# ---------------------------------------------------------------------------
# RWKV-6: sub-chunks of 16, state carried at each reference point


def wkv_sub_factors(w):
    """Factors of one sub-chunk of decays w [..., 16, hd], by running
    products: Q[t] = prod_{m<t} w_m (query side, from the reference
    point), K[s] = prod_{s<m<16} w_m (key side, to the next reference
    point), W = prod_m w_m (the sub-chunk's decay, the key-side walker's
    last product)."""
    n = w.shape[-2]
    fac = torch.ones_like(w[..., 0, :])
    Q = []
    for t in range(n):
        Q.append(fac)
        fac = fac * w[..., t, :]
    fac = torch.ones_like(w[..., 0, :])
    K = [None] * n
    for s in reversed(range(n)):
        K[s] = fac
        fac = fac * w[..., s, :]
    return torch.stack(Q, -2), torch.stack(K, -2), fac


def wkv_diag_scores(r, k, w, u):
    """The diagonal sub-chunk's scores on the CUDA cores: A[t, s] =
    sum_d r_td kf_d for s < t with kf = k_s o prod_{s<m<t} w_m carried
    along t by running products, and the bonus A[t, t] = sum_d r_td u_d
    k_td."""
    n = r.shape[-2]
    A = torch.zeros(*r.shape[:-2], n, n)
    for s in range(n):
        A[..., s, s] = (r[..., s, :] * (u * k[..., s, :])).sum(-1)
        kf = k[..., s, :]
        for t in range(s + 1, n):
            A[..., t, s] = (r[..., t, :] * kf).sum(-1)
            kf = kf * w[..., t, :]
    return A


def _cumsum_sub_factors(cs, lo):
    """The rejected form: the same factors as exp of differences of
    cumulative log-decay sums ``cs`` taken from the chunk's start (cs[t]
    = sum_{m<t} log w_m), for the sub-chunk starting at ``lo``."""
    hi = lo + SUB
    ref = cs[..., lo:lo + 1, :]
    Q = torch.exp(cs[..., lo:hi, :] - ref)
    K = torch.exp(cs[..., hi:hi + 1, :] - cs[..., lo + 1:hi + 1, :])
    return Q, K, torch.exp(cs[..., hi, :] - cs[..., lo, :])


def _cumsum_diag_scores(r, k, cs, lo, u):
    A = torch.zeros(*r.shape[:-2], SUB, SUB)
    for s in range(SUB):
        A[..., s, s] = (r[..., s, :] * (u * k[..., s, :])).sum(-1)
        for t in range(s + 1, SUB):
            fac = torch.exp(cs[..., lo + t, :] - cs[..., lo + s + 1, :])
            A[..., t, s] = (r[..., t, :] * (k[..., s, :] * fac)).sum(-1)
    return A


def emulate_wkv_chunked(r, k, v, w, u, S0, *, passes: int = 3,
                        factors: str = "product"):
    """``wkv_chunk_kernel``'s algorithm.  Model layout: r, k, v, w
    [b, s, h, hd]; u [h, hd]; S0 [b, h, hd, hd] (key x value) -> (y
    [b, s, h, hd], S_T), fp32.  Per sub-chunk I of 16 steps with S the
    state at its first step:

        y_I = (r_I o Q_I) S + A_I v_I,    S <- diag(W_I) S + (k_I o K_I)^T v_I

    the products on the tensor cores (3xTF32), the factors and the
    diagonal scores A_I on the CUDA cores in fp32."""
    tr = lambda t: t.float().transpose(1, 2)        # [b, h, s, hd]
    r, k, v, w = tr(r), tr(k), tr(v), tr(w)
    u = u.float()
    S = S0.float().clone()
    b, h, s, hd = r.shape
    y = torch.zeros(b, h, s, hd)
    for c0 in range(0, s, CHUNK):
        n = min(CHUNK, s - c0)
        pad = lambda t, val: torch.cat(
            [t[:, :, c0:c0 + n], torch.full((b, h, CHUNK - n, hd), val)], 2)
        rc, kc, vc = pad(r, 0.0), pad(k, 0.0), pad(v, 0.0)
        wc = pad(w, 1.0)                  # a masked step decays nothing
        if factors == "cumsum":
            cs = torch.cat([torch.zeros(b, h, 1, hd),
                            torch.cumsum(torch.log(wc), 2)], 2)
        for lo in range(0, CHUNK, SUB):
            sl = slice(lo, lo + SUB)
            rs, ks, vs, ws = rc[:, :, sl], kc[:, :, sl], vc[:, :, sl], \
                wc[:, :, sl]
            if factors == "product":
                Q, K, W = wkv_sub_factors(ws)
                A = wkv_diag_scores(rs, ks, ws, u[None])
            else:
                Q, K, W = _cumsum_sub_factors(cs, lo)
                A = _cumsum_diag_scores(rs, ks, cs, lo, u[None])
            yI = mm3(A, vs, init=mm3(rs * Q, S, passes=passes),
                     passes=passes)
            y[:, :, c0 + lo:c0 + min(lo + SUB, n)] = yI[:, :, :max(
                0, min(SUB, n - lo))]
            S = mm3((ks * K).transpose(-1, -2), vs, init=W[..., None] * S,
                    passes=passes)
    return y.transpose(1, 2), S


# ---------------------------------------------------------------------------
# Mamba-2: one [64 x 64] decay matrix per head and chunk


def ssd_chunk_factors(a):
    """Factors of one chunk of scalar decays a [..., 64], by running
    products along each row of L (the kernels' order: from the diagonal
    outwards): L[i, j] = prod_{j<m<=i} a_m for j <= i (0 above the
    diagonal), A[i] = prod_{m<=i} a_m = L[i, 0] a_0, T[j] = L[63, j] =
    prod_{j<m<64} a_m."""
    n = a.shape[-1]
    L = torch.zeros(*a.shape[:-1], n, n)
    idx = torch.arange(n)
    diag = torch.ones(*a.shape[:-1], n)
    L[..., idx, idx] = diag
    for d in range(1, n):                 # diagonal d from diagonal d - 1
        i = idx[d:]
        diag = diag[..., 1:] * a[..., i - d + 1]
        L[..., i, i - d] = diag
    A = L[..., :, 0] * a[..., :1]
    return L, A, L[..., n - 1, :]


def _cumsum_ssd_factors(a):
    cs = torch.cumsum(torch.log(a), -1)          # sum_{m<=i} log a_m
    L = torch.tril(torch.exp(cs[..., :, None] - cs[..., None, :]))
    return L, torch.exp(cs), torch.exp(cs[..., -1:] - cs)


def emulate_ssd_chunked(x, dt, decay, B, C, S0, *, passes: int = 3,
                        factors: str = "product"):
    """``ssd_chunk_kernel``'s algorithm.  Model layouts: x [b, s, h, p];
    dt, decay [b, s, h]; B, C [b, s, g, n]; S0 [b, h, p, n] -> (y
    [b, s, h, p], S_T), fp32.  Per chunk, with S the state before it:

        y = diag(A) (C S^T) + ((C B^T) o L o dt) X
        S <- A_63 S + (X o (T dt))^T B

    every product on the tensor cores (3xTF32)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    tr = lambda t: t.float().transpose(1, 2)
    x, dt, decay = tr(x), tr(dt), tr(decay)
    B, C = (tr(t.repeat_interleave(rep, dim=2)) for t in (B, C))
    S = S0.float().clone()
    y = torch.zeros(b, h, s, p)
    for c0 in range(0, s, CHUNK):
        n = min(CHUNK, s - c0)

        def pad(t, val):
            fill = torch.full((*t.shape[:2], CHUNK - n, *t.shape[3:]), val)
            return torch.cat([t[:, :, c0:c0 + n], fill], 2)

        xc, Bc, Cc, dtc = pad(x, 0.0), pad(B, 0.0), pad(C, 0.0), pad(dt, 0.0)
        ac = pad(decay, 1.0)              # a masked step decays nothing
        L, A, T = (ssd_chunk_factors(ac) if factors == "product"
                   else _cumsum_ssd_factors(ac))
        G = mm3(Cc, Bc.transpose(-1, -2), passes=passes)
        M = G * L * dtc[..., None, :]
        Y = A[..., None] * mm3(Cc, S.transpose(-1, -2), passes=passes)
        Y = mm3(M, xc, init=Y, passes=passes)
        y[:, :, c0:c0 + n] = Y[:, :, :n]
        Xs = xc * (T * dtc)[..., None]
        S = mm3(Xs.transpose(-1, -2), Bc, init=A[..., -1, None, None] * S,
                passes=passes)
    return y.transpose(1, 2), S


# ---------------------------------------------------------------------------
# inputs, and the sequential references


def _rwkv_case(seed, b, s, h, hd, zeros=0.05, logw=(-3.0, 4.25)):
    """The models' decays (w = exp(-exp(logw)), down to ~1e-30) with a
    share of exact zeros (a reset)."""
    r, k, v, w, u, S0 = _rwkv_inputs(seed, b, s, h, hd, logw=logw)
    rng = np.random.default_rng(seed + 1000)
    w = np.where(rng.random(w.shape) < zeros, 0.0, w).astype(np.float32)
    return r, k, v, w, u, S0


def _mamba_case(seed, b, s, h, p, n, g, zeros=0.05):
    x, dt, decay, B, C, S0 = _mamba_inputs(seed, b, s, h, p, n, g)
    rng = np.random.default_rng(seed + 1000)
    decay = np.where(rng.random(decay.shape) < zeros, 0.0,
                     decay).astype(np.float32)
    return x, dt, decay, B, C, S0


def _jax_rwkv_ref(r, k, v, w, u, S0):
    y, sT = jref.rwkv6_ref(*(_tr(a) for a in (r, k, v, w)), u, S0)
    return _tr(np.asarray(y)), np.asarray(sT)


def _err(got, want):
    """max |got - want| beyond the 2e-5 atol + rtol envelope (<= 0 when
    within), and the max abs difference."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    d = np.abs(got - want)
    return float((d - CHUNK_TOL - CHUNK_TOL * np.abs(want)).max()), \
        float(d.max())


def _within(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=CHUNK_TOL, rtol=CHUNK_TOL)


# ---------------------------------------------------------------------------
# the emulations against the JAX sequential scans


@pytest.mark.parametrize("s", [64, 65, 127, 200])
def test_emulated_wkv_chunked_matches_jax_ref(s):
    args = _rwkv_case(50 + s, 2, s, 2, 32)
    w = args[3]
    assert w.min() == 0.0 and w[w > 0].min() < 1e-29
    yj, sj = _jax_rwkv_ref(*args)
    y, sT = emulate_wkv_chunked(*(_t(a) for a in args))
    _within(y, yj)
    _within(sT, sj)


def test_emulated_wkv_chunked_full_head_size():
    """hd 64 (rwkv6-7b's), bf16-rounded r, k, v (the main path's: exact
    in TF32, so their low parts are zero)."""
    args = list(_rwkv_case(70, 1, 130, 2, 64))
    for i in range(3):
        args[i] = _t(args[i]).to(torch.bfloat16).float().numpy()
    yj, sj = _jax_rwkv_ref(*args)
    y, sT = emulate_wkv_chunked(*(_t(a) for a in args))
    _within(y, yj)
    _within(sT, sj)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("s", [64, 65, 127, 200])
def test_emulated_ssd_chunked_matches_jax_ref(s, g):
    args = _mamba_case(80 + s + g, 2, s, 4, 16, 32, g)
    decay = args[2]
    assert decay.min() == 0.0 and decay[decay > 0].min() < 2e-5
    yj, sj = _jax_mamba_ref(*args)
    y, sT = emulate_ssd_chunked(*(_t(a) for a in args))
    _within(y, yj)
    _within(sT, sj)


def test_emulated_ssd_chunked_full_width():
    """zamba2-1.2b's p 64, n 64, g 1, bf16-rounded x, B, C."""
    args = list(_mamba_case(90, 1, 130, 2, 64, 64, 1))
    for i in (0, 3, 4):
        args[i] = _t(args[i]).to(torch.bfloat16).float().numpy()
    yj, sj = _jax_mamba_ref(*args)
    y, sT = emulate_ssd_chunked(*(_t(a) for a in args))
    _within(y, yj)
    _within(sT, sj)


def test_emulations_carry_state_across_calls():
    """A prompt in two calls (the prefill then the next prefill or
    decode call) gives the one-call result, with the split off the
    chunk and sub-chunk boundaries."""
    r, k, v, w, u, S0 = (_t(a) for a in _rwkv_case(95, 1, 150, 2, 16))
    y, sT = emulate_wkv_chunked(r, k, v, w, u, S0)
    y1, s1 = emulate_wkv_chunked(r[:, :70], k[:, :70], v[:, :70],
                                 w[:, :70], u, S0)
    y2, s2 = emulate_wkv_chunked(r[:, 70:], k[:, 70:], v[:, 70:],
                                 w[:, 70:], u, s1)
    _within(torch.cat([y1, y2], 1), y)
    _within(s2, sT)
    x, dt, de, B, C, S0 = (_t(a) for a in _mamba_case(96, 1, 150, 2, 16,
                                                       16, 1))
    y, sT = emulate_ssd_chunked(x, dt, de, B, C, S0)
    cut = lambda lo, hi: [t[:, lo:hi] for t in (x, dt, de, B, C)]
    y1, s1 = emulate_ssd_chunked(*cut(0, 70), S0)
    y2, s2 = emulate_ssd_chunked(*cut(70, 150), s1)
    _within(torch.cat([y1, y2], 1), y)
    _within(s2, sT)


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode, inside their envelope


@pytest.mark.parametrize("s,chunk", [(64, 32), (128, 64)])
def test_emulated_wkv_matches_pallas_in_envelope(s, chunk):
    args = _rwkv_inputs(100 + s, 1, s, 2, 32, w_range=(0.5, 1.0))
    yj, sj = jops.rwkv6_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                             interpret=True)
    y, sT = emulate_wkv_chunked(*(_t(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=PALLAS_ATOL,
                               rtol=PALLAS_RTOL)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sj),
                               atol=PALLAS_ATOL, rtol=PALLAS_RTOL)


@pytest.mark.parametrize("g", [1, 2])
def test_emulated_ssd_matches_pallas_in_envelope(g):
    args = _mamba_inputs(110 + g, 2, 64, 4, 16, 32, g,
                         decay_range=(0.5, 1.0))
    yj, sj = jops.mamba2_scan(*(jnp.asarray(a) for a in args), chunk=32,
                              interpret=True)
    y, sT = emulate_ssd_chunked(*(_t(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=PALLAS_ATOL,
                               rtol=PALLAS_RTOL)
    np.testing.assert_allclose(sT.numpy(), np.asarray(sj),
                               atol=PALLAS_ATOL, rtol=PALLAS_RTOL)


# ---------------------------------------------------------------------------
# why the design is what it is


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_single_tf32_product_misses_tolerance(kind):
    """One TF32 product (about three digits) where the kernels take
    three: the result leaves the 2e-5 envelope that 3xTF32 keeps."""
    if kind == "rwkv6":
        args = _rwkv_case(120, 1, 130, 2, 32)
        want = _jax_rwkv_ref(*args)
        emulate = emulate_wkv_chunked
    else:
        args = _mamba_case(121, 1, 130, 4, 16, 32, 1)
        want = _jax_mamba_ref(*args)
        emulate = emulate_ssd_chunked
    targs = [_t(a) for a in args]
    for got, ref_ in zip(emulate(*targs), want):       # 3xTF32: within
        assert _err(got, ref_)[0] <= 0
    one = emulate(*targs, passes=1)
    assert max(_err(got, ref_)[0] for got, ref_ in zip(one, want)) > 0


def test_cumsum_factors_miss_tolerance_at_small_decays():
    """Factors as exp of differences of cumulative log-decay sums from
    the chunk's start: their error scales with the sums, which reach
    hundreds at RWKV-6's decays (down to ~1e-30), not with the factor;
    the product form stays within 2e-5 on the same inputs (no exact
    zeros here: log 0 would make the rejected form NaN outright).  At
    Mamba-2's decays (down to ~1e-5, sums of tens) the rejected form
    happens to stay inside 2e-5, so it is not a contrast there."""
    args = _rwkv_case(130, 1, 128, 2, 32, zeros=0.0)
    want = _jax_rwkv_ref(*args)
    targs = [_t(a) for a in args]
    for got, ref_ in zip(emulate_wkv_chunked(*targs), want):
        assert _err(got, ref_)[0] <= 0
    bad = emulate_wkv_chunked(*targs, factors="cumsum")
    assert max(_err(got, ref_)[0] for got, ref_ in zip(bad, want)) > 0


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.5, 1.0), (0.999, 1.0)])
def test_factors_never_exceed_one(lo, hi):
    """Every factor is a product of decays in (0, 1], so it is <= 1
    (and >= 0) whatever the decays: the key side and query side of RWKV-6
    and Mamba-2's L, A and T, including the span-long products."""
    rng = np.random.default_rng(int(1000 * lo))
    w = torch.from_numpy(rng.uniform(lo, hi, (3, SUB, 64)).astype(
        np.float32))
    w[0, 3] = 1.0                                   # masked steps
    w[1, 5, :7] = 0.0                               # resets
    for f in wkv_sub_factors(w):
        assert float(f.max()) <= 1.0 and float(f.min()) >= 0.0
    a = torch.from_numpy(rng.uniform(lo, hi, (3, CHUNK)).astype(np.float32))
    a[0, 40:] = 1.0
    a[1, 9] = 0.0
    for f in ssd_chunk_factors(a):
        assert float(f.max()) <= 1.0 and float(f.min()) >= 0.0
    # A[t, s]'s factor, from the diagonal scores with unit r, k
    ones = torch.ones(3, SUB, 64)
    A = wkv_diag_scores(ones, ones, w, torch.zeros(64))
    assert float(A.max()) <= 64.0 and float(A.min()) >= 0.0


def test_wkv_factor_splits_at_the_reference_point():
    """Query side x key side = the span's product: for t in a sub-chunk
    and s in the one before, Q_I[t] K_{I-1}[s] W... reduces to
    prod_{s<m<t} w_m, the recurrence's own factor."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.uniform(0.3, 1.0, (2 * SUB, 8)).astype(
        np.float32))
    Q1, _, _ = wkv_sub_factors(w[SUB:])
    _, K0, _ = wkv_sub_factors(w[:SUB])
    for s, t in ((0, SUB), (5, SUB + 9), (SUB - 1, 2 * SUB - 1)):
        want = torch.prod(w[s + 1:t].double(), 0)
        np.testing.assert_allclose((K0[s] * Q1[t - SUB]).numpy(),
                                   want.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# the kernels' source: no quotient of decays, no exponential


def _kernel_body(path: Path, name: str) -> str:
    text = re.sub(r"//[^\n]*", "", path.read_text())
    start = text.index(f" {name}(")
    depth, i = 0, text.index("{", start)
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError(f"{name}: unbalanced braces")


@pytest.mark.parametrize("src,name", [
    ("rwkv6_scan.cu", "wkv_chunk_kernel"),
    ("rwkv6_scan.cu", "wkv_scores_kernel"),
    ("mamba2_scan.cu", "ssd_chunk_kernel"),
    ("mamba2_scan.cu", "ssd_scores_kernel"),
    ("rwkv6_scan.cu", "wkv_decode_kernel"),
    ("mamba2_scan.cu", "ssd_decode_kernel")])
def test_kernel_source_forms_decays_by_products(src, name):
    """The new kernels divide only integers (index arithmetic by
    compile-time constants, and heads by groups), and take no
    exponential, logarithm or reciprocal: every decay factor is formed
    by multiplying decays.  The chunked ones run their products on the
    tensor cores in TF32 (``mma.sync ... tf32``, through
    ``scan_mma.cuh``)."""
    body = _kernel_body(CSRC / src, name)
    divisors = re.findall(r"/\s*\(?\s*([\w:.]+)", body)
    assert divisors
    for d in divisors:
        assert re.fullmatch(r"\d+|[A-Z][A-Z0-9_]*|sizeof|p\.[hg]", d), d
    banned = re.findall(r"\b(?:__)?(?:exp2?f?|log2?f?|fdividef|frcp\w*|"
                        r"rcp\w*|ex2\w*|lg2\w*)\b", body)
    assert not banned, banned
    if "chunk" in name:
        assert "sm::mma3<" in body
        assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in \
            (CSRC / "scan_mma.cuh").read_text()


# ---------------------------------------------------------------------------
# the wrappers' routing by shape


@pytest.mark.parametrize("s,want", [(1, "decode"), (2, "step"),
                                    (12, "step"), (63, "step"),
                                    (64, "chunk"), (2048, "chunk")])
def test_wrappers_route_by_sequence_length(s, want):
    assert r6.variant(s) == want and m2.variant(s) == want
    assert r6.CHUNK_MIN_S == m2.CHUNK_MIN_S == 64


def test_cpu_path_counts_no_variant():
    ops.reset_launch_counts()
    for s in (1, 12, 64):
        ops.rwkv6_scan(*(_t(a) for a in _rwkv_inputs(5, 1, s, 2, 16)))
        ops.mamba2_scan(*(_t(a) for a in _mamba_inputs(5, 1, s, 2, 16, 16,
                                                       1)))
    assert set(ops.launch_counts().values()) == {0}
    assert set(ops.variant_counts().values()) == {0}
    assert {"rwkv6_scan_decode", "rwkv6_scan_chunk", "mamba2_scan_decode",
            "mamba2_scan_chunk"} <= set(ops.variant_counts())


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_vector_alignment_check(kind):
    """The decode and chunked kernels copy 16 bytes at a time: their
    wrappers refuse a state or an input whose pointer or strides are not
    multiples of 16 bytes (a pure check; it runs on CPU tensors)."""
    check = (r6 if kind == "rwkv6" else m2).check_cp_async_alignment
    good = torch.zeros(2, 70, 4, 16)
    check(x=good)
    with pytest.raises(ValueError, match="16 bytes"):
        check(x=good[:, :, :, 1:])
    wide = torch.zeros(2, 70, 4, 17)[..., :16]
    with pytest.raises(ValueError, match="head stride"):
        check(x=wide)
    state = torch.zeros(1, 64, 64, 64)
    check(S0=state, out=state)
    with pytest.raises(ValueError, match="S0: data pointer"):
        check(S0=torch.zeros(4 * 64 * 64 + 1)[1:].view(1, 4, 64, 64))
