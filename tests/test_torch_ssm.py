"""The port's RWKV-6 and Mamba-2/hybrid serving path against the JAX
package's.

Inputs are drawn with numpy from a seed; weights are the JAX model's,
carried over by ``repro_torch.models.from_jax_params``.  Everything runs
on the CPU in fp32, where the port's scan wrappers compute their plain
versions (``kernels/ref.py``), the sequential recurrences.

Tolerances:
  * 1e-5 (abs and rel) for the plain recurrences against the JAX
    package's sequential scans (``repro/kernels/ref.py``,
    ``repro/models/ssm.py``): the same fp32 steps, other summation
    order; at decays down to ~1e-30 (rwkv6) and ~1e-5 (mamba2);
  * atol 5e-3 / rtol 1e-3 against the Pallas kernels in interpret mode,
    ``tests/test_kernels.py``'s, inside their envelope (w and decay in
    [0.5, 1), s a multiple of the chunk);
  * 1e-5 for single blocks, 1e-4 for whole-model logits and caches;
  * exact tokens for the engines.

The load-bearing claims: the port's ``SimpleEngine``, which prefills in
one scan-kernel call per layer, emits exactly the JAX ``SimpleEngine``'s
tokens, which steps ``decode_step`` over the prompt; and the Pallas
chunked forms depart from the recurrence at the decays these models
draw, where the port's stay exact.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.planner import serve_plan as jserve_plan
from repro.serve import SimpleEngine as JSimpleEngine
from repro.serve import poisson_trace as jpoisson_trace
from repro_torch import configs as tconfigs
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.launch import serve as tlaunch
from repro_torch.models import Model, from_jax_params
from repro_torch.models import layers as tl
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.planner import serve_plan
from repro_torch.serve import SimpleEngine, poisson_trace
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401

SCAN_TOL = 1e-5
PALLAS_ATOL, PALLAS_RTOL = 5e-3, 1e-3
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4

# the zamba2 tiny configs: stage sizes (2, 2), and a ragged (3, 2) whose
# first stage ends in a short segment that fires no shared block
ARCHS = [("rwkv6-7b", 4), ("zamba2-1.2b", 4), ("zamba2-1.2b", 5)]
ARCH_IDS = ["rwkv6", "zamba2-2-2", "zamba2-3-2"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol, rtol=None):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol,
        rtol=tol if rtol is None else rtol)


def _tr(a):
    """[b, s, h, ...] <-> [b, h, s, ...] (numpy)."""
    return np.swapaxes(a, 1, 2)


# ---------------------------------------------------------------------------
# inputs of the two recurrences, as the models draw their decays


def _rwkv_inputs(seed, b, s, h, hd, *, logw=(-3.0, 4.2), w_range=None):
    """Model layout [b, s, h, hd].  w = exp(-exp(logw)), logw uniform in
    ``logw`` (up to 4.2: w down to ~1e-29), or w uniform in
    ``w_range``."""
    rng = np.random.default_rng(seed)
    f = lambda *sh, sc=1.0: rng.standard_normal(sh, dtype=np.float32) * sc
    r, k, v = f(b, s, h, hd), f(b, s, h, hd, sc=0.3), f(b, s, h, hd)
    if w_range is None:
        w = np.exp(-np.exp(rng.uniform(*logw, (b, s, h, hd))))
    else:
        w = rng.uniform(*w_range, (b, s, h, hd))
    return (r, k, v, w.astype(np.float32), f(h, hd, sc=0.3),
            f(b, h, hd, hd, sc=0.1))


def _mamba_inputs(seed, b, s, h, p, n, g, *, neg_log_decay=(0.0, 11.5),
                  decay_range=None, S0_scale=0.1):
    """Model layouts: x [b, s, h, p]; dt, decay [b, s, h]; B, C
    [b, s, g, n].  decay = exp(-U(neg_log_decay)) (down to ~1e-5), or
    uniform in ``decay_range``."""
    rng = np.random.default_rng(seed)
    f = lambda *sh, sc=1.0: rng.standard_normal(sh, dtype=np.float32) * sc
    x = f(b, s, h, p)
    dt = np.log1p(np.exp(f(b, s, h))).astype(np.float32)
    if decay_range is None:
        decay = np.exp(-rng.uniform(*neg_log_decay, (b, s, h)))
    else:
        decay = rng.uniform(*decay_range, (b, s, h))
    return (x, dt, decay.astype(np.float32), f(b, s, g, n, sc=0.5),
            f(b, s, g, n, sc=0.5), f(b, h, p, n, sc=S0_scale))


def _jax_mamba_ref(x, dt, decay, B, C, S0):
    """JAX's kernel-layout oracle on model-layout inputs (groups
    repeated to heads as ``repro/kernels/ops.py`` repeats them)."""
    rep = x.shape[2] // B.shape[2]
    Bh, Ch = (np.repeat(t, rep, axis=2) for t in (B, C))
    y, sT = jref.mamba2_ref(_tr(x), np.moveaxis(dt, 1, 2),
                            np.moveaxis(decay, 1, 2), _tr(Bh), _tr(Ch), S0)
    return _tr(np.asarray(y)), np.asarray(sT)


# ---------------------------------------------------------------------------
# (a) configs


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_ssm_configs_match_jax(arch, smoke):
    import dataclasses
    j, t = jget_config(arch), tconfigs.get_config(arch)
    if smoke:
        j, t = jsmoke_config(j), tconfigs.smoke_config(t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.hd, j.vocab_padded, j.param_count()) == \
        (t.hd, t.vocab_padded, t.param_count())


# ---------------------------------------------------------------------------
# (b) the plain recurrences against the JAX sequential scans


@pytest.mark.parametrize("s", [1, 7, 37])
def test_rwkv6_ref_matches_jax_scans(s):
    r, k, v, w, u, S0 = _rwkv_inputs(s, 2, s, 3, 16)
    assert w.min() < 1e-20           # the decays the models draw
    # kernel layout: repro/kernels/ref.py
    yj, sj = jref.rwkv6_ref(*(_tr(a) for a in (r, k, v, w)), u, S0)
    yt, st = ref.rwkv6_ref(*(_t(_tr(a)) for a in (r, k, v, w)), _t(u),
                           _t(S0))
    _close(yt, yj, SCAN_TOL)
    _close(st, sj, SCAN_TOL)
    # model layout: repro/models/ssm.py against the port's wrapper
    yj, sj = jssm.rwkv6_wkv_ref(r, k, v, w, u, S0)
    yt, st = ops.rwkv6_scan(*(_t(a) for a in (r, k, v, w, u, S0)))
    assert yt.shape == r.shape and yt.dtype == torch.float32
    _close(yt, yj, SCAN_TOL)
    _close(st, sj, SCAN_TOL)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s", [1, 7, 37])
def test_mamba2_ref_matches_jax_scans(s, g):
    x, dt, decay, B, C, S0 = _mamba_inputs(10 + s, 2, s, 4, 16, 16, g)
    assert decay.min() < 1e-3 or s == 1
    yj, sj = _jax_mamba_ref(x, dt, decay, B, C, S0)
    yt, st = ops.mamba2_scan(*(_t(a) for a in (x, dt, decay, B, C, S0)))
    assert yt.shape == x.shape and yt.dtype == torch.float32
    _close(yt, yj, SCAN_TOL)
    _close(st, sj, SCAN_TOL)
    # model layout: repro/models/ssm.py
    yj, sj = jssm.mamba2_ssd_ref(x, dt, decay, B, C, S0)
    _close(yt, yj, SCAN_TOL)
    _close(st, sj, SCAN_TOL)
    # kernel layout: the port's plain version alone
    rep = 4 // g
    Bh, Ch = (_tr(np.repeat(a, rep, axis=2)) for a in (B, C))
    yk, sk = ref.mamba2_ref(_t(_tr(x)), _t(np.moveaxis(dt, 1, 2)),
                            _t(np.moveaxis(decay, 1, 2)), _t(Bh), _t(Ch),
                            _t(S0))
    _close(yk.transpose(1, 2), yt, 0)
    _close(sk, st, 0)


def test_scans_carry_state_across_calls():
    """Two halves with the state carried == one run (the prefill then
    decode contract), for both recurrences."""
    args = [_t(a) for a in _rwkv_inputs(3, 1, 20, 2, 16)]
    y, sT = ops.rwkv6_scan(*args)
    r, k, v, w, u, S0 = args
    y1, s1 = ops.rwkv6_scan(r[:, :13], k[:, :13], v[:, :13], w[:, :13], u,
                            S0)
    y2, s2 = ops.rwkv6_scan(r[:, 13:], k[:, 13:], v[:, 13:], w[:, 13:], u,
                            s1)
    _close(torch.cat([y1, y2], 1), y, SCAN_TOL)
    _close(s2, sT, SCAN_TOL)
    x, dt, de, B, C, S0 = (_t(a) for a in _mamba_inputs(4, 1, 20, 2, 16,
                                                        32, 1))
    y, sT = ops.mamba2_scan(x, dt, de, B, C, S0)
    cut = lambda t, lo, hi: t[:, lo:hi]
    y1, s1 = ops.mamba2_scan(*(cut(t, 0, 1) for t in (x, dt, de, B, C)), S0)
    y2, s2 = ops.mamba2_scan(*(cut(t, 1, 20) for t in (x, dt, de, B, C)),
                             s1)
    _close(torch.cat([y1, y2], 1), y, SCAN_TOL)
    _close(s2, sT, SCAN_TOL)


# ---------------------------------------------------------------------------
# (c) against the Pallas kernels in interpret mode, inside their envelope


@pytest.mark.parametrize("b,h,s,hd,chunk", [(1, 2, 64, 32, 32),
                                            (2, 3, 32, 16, 16)])
def test_rwkv6_scan_matches_pallas_in_envelope(b, h, s, hd, chunk):
    args = _rwkv_inputs(20 + hd, b, s, h, hd, w_range=(0.5, 1.0))
    yj, sj = jops.rwkv6_scan(*(jnp.asarray(a) for a in args), chunk=chunk,
                             interpret=True)
    yt, st = ops.rwkv6_scan(*(_t(a) for a in args))
    _close(yt, yj, PALLAS_ATOL, PALLAS_RTOL)
    _close(st, sj, PALLAS_ATOL, PALLAS_RTOL)


@pytest.mark.parametrize("g", [1, 2])
def test_mamba2_scan_matches_pallas_in_envelope(g):
    args = _mamba_inputs(30 + g, 2, 64, 4, 16, 32, g,
                         decay_range=(0.5, 1.0))
    yj, sj = jops.mamba2_scan(*(jnp.asarray(a) for a in args), chunk=32,
                              interpret=True)
    yt, st = ops.mamba2_scan(*(_t(a) for a in args))
    _close(yt, yj, PALLAS_ATOL, PALLAS_RTOL)
    _close(st, sj, PALLAS_ATOL, PALLAS_RTOL)


# ---------------------------------------------------------------------------
# (d) the reference kernels' numeric envelope: the Pallas chunked forms
# rescale by the running decay product inside a chunk and depart from the
# recurrence at small decays; the port's plain version does not


@pytest.mark.parametrize("kind,top,floor", [
    ("rwkv6", 2.0, 1e-3), ("rwkv6", 4.2, 1e-25),
    ("mamba2", 8.6, 2e-4), ("mamba2", 11.5, 2e-5)])
def test_pallas_departs_at_small_decays_port_does_not(kind, top, floor):
    b, h, s, d, chunk = 1, 2, 64, 64, 32
    if kind == "rwkv6":
        args = _rwkv_inputs(40, b, s, h, d, logw=(-3.0, top))
        decay = args[3]
        yp, _ = jops.rwkv6_scan(*(jnp.asarray(a) for a in args),
                                chunk=chunk, interpret=True)
        ys, _ = jssm.rwkv6_wkv_ref(*args)
        yt, _ = ops.rwkv6_scan(*(_t(a) for a in args))
    else:
        args = _mamba_inputs(41, b, s, h, d, d, 1,
                             neg_log_decay=(0.0, top), S0_scale=0.0)
        decay = args[2]
        yp, _ = jops.mamba2_scan(*(jnp.asarray(a) for a in args),
                                 chunk=chunk, interpret=True)
        ys, _ = jssm.mamba2_ssd_ref(*args)
        yt, _ = ops.mamba2_scan(*(_t(a) for a in args))
    assert decay.min() < floor
    ys = np.asarray(ys)
    scale = np.abs(ys).max()
    # the chunked Pallas form is off by a sizeable share of |y| ...
    assert np.abs(np.asarray(yp) - ys).max() > 0.1 * scale
    # ... the port's recurrence is within fp32 rounding of the scan
    _close(yt, ys, SCAN_TOL)


# ---------------------------------------------------------------------------
# (e) the wrappers' contract on the CPU


def test_scan_wrappers_cpu_path_never_counts():
    ops.reset_launch_counts()
    ops.rwkv6_scan(*(_t(a) for a in _rwkv_inputs(5, 1, 3, 2, 16)))
    ops.mamba2_scan(*(_t(a) for a in _mamba_inputs(5, 1, 3, 2, 16, 16, 1)))
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["hd", "dtype", "w_dtype", "u_shape",
                                 "S0_shape", "empty", "out_shape",
                                 "out_dtype"])
def test_rwkv6_wrapper_rejects(bad):
    r, k, v, w, u, S0 = (_t(a) for a in _rwkv_inputs(6, 1, 3, 2, 16))
    out = None
    if bad == "hd":
        r, k, v, w = (t[..., :8] for t in (r, k, v, w))
        u, S0 = u[:, :8], S0[:, :, :8, :8]
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "S0_shape":
        S0 = S0[..., :8]
    elif bad == "out_shape":
        out = S0[:, :1].clone()
    elif bad == "out_dtype":
        out = S0.double()
    else:
        r, k, v, w = (t[:, :0] for t in (r, k, v, w))
    with pytest.raises((ValueError, TypeError)):
        ops.rwkv6_scan(r, k, v, w, u, S0, out=out)


@pytest.mark.parametrize("bad", ["groups", "n", "dt_dtype", "C_shape",
                                 "S0_shape", "out_shape", "out_strided"])
def test_mamba2_wrapper_rejects(bad):
    x, dt, de, B, C, S0 = (_t(a) for a in _mamba_inputs(7, 1, 3, 4, 16,
                                                        16, 2))
    out = None
    if bad == "groups":
        B, C = (torch.cat([t, t[:, :, :1]], 2) for t in (B, C))
    elif bad == "n":
        B, C, S0 = B[..., :12], C[..., :12], S0[..., :12]
    elif bad == "dt_dtype":
        dt = dt.double()
    elif bad == "C_shape":
        C = C[:, :2]
    elif bad == "out_shape":
        out = S0[..., :8].clone()
    elif bad == "out_strided":
        out = S0.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        S0 = S0[:, :2]
    with pytest.raises((ValueError, TypeError)):
        ops.mamba2_scan(x, dt, de, B, C, S0, out=out)


@pytest.mark.parametrize("kind", ["rwkv6", "mamba2"])
def test_scans_write_state_in_place(kind):
    """``out=S0`` (the models' call) gives the same y and S_T as a fresh
    S_T, written over S0."""
    if kind == "rwkv6":
        args = [_t(a) for a in _rwkv_inputs(9, 2, 7, 2, 16)]
        scan = ops.rwkv6_scan
    else:
        args = [_t(a) for a in _mamba_inputs(9, 2, 7, 4, 16, 32, 2)]
        scan = ops.mamba2_scan
    y, sT = scan(*args)
    S0 = args[-1].clone()
    y_in, sT_in = scan(*args[:-1], S0, out=S0)
    assert sT_in is S0
    _close(y_in, y, 0)
    _close(S0, sT, 0)


def test_scans_differentiate_through_their_backward():
    """Under autograd each scan's gradient is its backward wrapper's (the
    plain backward on the CPU, the backward kernel on the card), equal
    bit for bit; the in-place state path (``out=``) serves only and
    raises there, and still runs without autograd."""
    cases = ((ops.rwkv6_scan, r6.rwkv6_scan_bwd,
              [_t(a) for a in _rwkv_inputs(8, 1, 3, 2, 16)]),
             (ops.mamba2_scan, m2.mamba2_scan_bwd,
              [_t(a) for a in _mamba_inputs(8, 1, 3, 2, 16, 16, 1)]))
    rng = np.random.default_rng(0)
    for scan, bwd, args in cases:
        leaves = [a.clone().requires_grad_() for a in args]
        y, sT = scan(*leaves)
        dy = _t(rng.standard_normal(tuple(y.shape)).astype(np.float32))
        dsT = _t(rng.standard_normal(tuple(sT.shape)).astype(np.float32))
        got = torch.autograd.grad((y, sT), leaves, (dy, dsT))
        for g, w in zip(got, bwd(*args, dy, dsT)):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="serving"):
            scan(*leaves[:-1], leaves[-1], out=args[-1].clone())
        with torch.no_grad():
            S0 = args[-1].clone()
            scan(*args[:-1], S0, out=S0)


# ---------------------------------------------------------------------------
# (f) blocks, with the JAX weights


def _models(arch, n_layers, seed=0):
    jc = tiny_cfg(arch, n_layers=n_layers, pipe=2)
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    tc = port_cfg(jc)
    return jm, jp, Model(tc, device="cpu"), from_jax_params(_np(jp), tc,
                                                            device="cpu")


@pytest.fixture(scope="module", params=ARCHS, ids=ARCH_IDS)
def models(request):
    return _models(*request.param)


@pytest.fixture(scope="module")
def rwkv():
    return _models("rwkv6-7b", 4)


@pytest.fixture(scope="module")
def zamba():
    return _models("zamba2-1.2b", 4)


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["stages"][0]["layers"]),
            tl.tree_map(lambda _, a: a[0], tp["stages"][0]["layers"]))


def _state_pair(seed, shapes):
    rng = np.random.default_rng(seed)
    st = {k: rng.standard_normal(s, dtype=np.float32) * 0.5
          for k, s in shapes.items()}
    return ({k: jnp.asarray(a) for k, a in st.items()},
            {k: _t(a) for k, a in st.items()})


def _copy(state):
    """A fresh copy of a port state (the mixers update theirs in
    place)."""
    return None if state is None else {k: a.clone() for k, a in
                                       state.items()}


def _close_tree(got, want, tol):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k], tol)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 5])
def test_rwkv6_time_and_channel_mix(rwkv, s, with_state):
    jm, jp, tm, tp = rwkv
    jc, tc = jm.cfg, tm.cfg
    pj, pt = _layer0(jp, tp)
    d, H = jc.d_model, jc.n_heads
    x = np.random.default_rng(50 + s).standard_normal(
        (2, s, d), dtype=np.float32)
    sj = st = None
    if with_state:
        sj, st = _state_pair(51, {"x_tm": (2, d), "x_cm": (2, d),
                                  "S": (2, H, d // H, d // H)})
    oj, nj = jssm.rwkv6_tm_apply(jc, pj["tm"], jnp.asarray(x), sj)
    ot, nt = tssm.rwkv6_tm_apply(tc, pt["tm"], _t(x), _copy(st))
    _close(ot, oj, LAYER_TOL)
    _close_tree(nt, nj, LAYER_TOL)
    oj, nj = jssm.rwkv6_cm_apply(jc, pj["cm"], jnp.asarray(x), sj)
    ot, nt = tssm.rwkv6_cm_apply(tc, pt["cm"], _t(x), _copy(st))
    _close(ot, oj, LAYER_TOL)
    _close_tree(nt, nj, LAYER_TOL)
    # the whole block, whose state is updated in place
    xj, _, _, nj = jtr.block_apply(jc, pj, jnp.asarray(x), state=sj)
    xt, aux, cache, nt = ttr.block_apply(tc, pt, _t(x), state=st)
    assert aux is None and cache is None
    _close(xt, xj, LAYER_TOL)
    _close_tree(nt, nj, LAYER_TOL)
    if with_state:
        assert all(nt[k] is st[k] for k in st)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 5])
def test_mamba2_apply(zamba, s, with_state):
    """With a state, prompts of 1 and 2 tokens (shorter than the conv's
    k - 1 = 3) leave part of the old conv state in the new one."""
    jm, jp, tm, tp = zamba
    jc, tc = jm.cfg, tm.cfg
    pj, pt = _layer0(jp, tp)
    sc = jc.ssm
    d_in = sc.expand * jc.d_model
    nh = d_in // sc.head_dim
    bc = 2 * sc.n_groups * sc.d_state
    x = np.random.default_rng(60 + s).standard_normal(
        (2, s, jc.d_model), dtype=np.float32)
    sj = st = None
    if with_state:
        sj, st = _state_pair(61, {
            "conv_x": (2, sc.conv_kernel - 1, d_in),
            "conv_bc": (2, sc.conv_kernel - 1, bc),
            "S": (2, nh, sc.head_dim, sc.d_state)})
    oj, nj = jssm.mamba2_apply(jc, pj["mamba"], jnp.asarray(x), sj)
    ot, nt = tssm.mamba2_apply(tc, pt["mamba"], _t(x), _copy(st))
    _close(ot, oj, LAYER_TOL)
    _close_tree(nt, nj, LAYER_TOL)
    if with_state and s < sc.conv_kernel - 1:
        _close(nt["conv_x"][:, :sc.conv_kernel - 1 - s],
               st["conv_x"][:, s:], 0)
    # the whole block, whose state is updated in place
    xj, _, _, nj = jtr.block_apply(jc, pj, jnp.asarray(x), state=sj)
    xt, _, _, nt = ttr.block_apply(tc, pt, _t(x), state=st)
    _close(xt, xj, LAYER_TOL)
    _close_tree(nt, nj, LAYER_TOL)
    if with_state:
        assert all(nt[k] is st[k] for k in st)


@pytest.mark.parametrize("s", [1, 3])
def test_causal_conv_state(s):
    rng = np.random.default_rng(70 + s)
    x, w, b = (rng.standard_normal(sh, dtype=np.float32)
               for sh in ((2, s, 6), (4, 6), (6,)))
    cs = rng.standard_normal((2, 3, 6), dtype=np.float32)
    for state in (None, cs):
        yj, nj = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   None if state is None
                                   else jnp.asarray(state))
        yt, nt = tssm._causal_conv(_t(x), _t(w), _t(b),
                                   None if state is None else _t(state))
        _close(yt, yj, LAYER_TOL)
        assert (nt is None) == (nj is None)
        if nt is not None:
            _close(nt, nj, 0)


@pytest.mark.parametrize("mode", ["sequence", "prefill", "decode"])
def test_shared_block_apply(zamba, mode):
    jm, jp, tm, tp = zamba
    jc, tc = jm.cfg, tm.cfg
    pj = jp["stages"][1]["shared"]
    pt = tp["stages"][1]["shared"]
    rng = np.random.default_rng(80)
    KV, hd = jc.n_kv_heads, jc.hd
    if mode == "decode":
        pos = 5
        x = rng.standard_normal((2, 1, jc.d_model), dtype=np.float32)
        kv = {k: rng.standard_normal((2, 12, KV, hd), dtype=np.float32)
              for k in ("k", "v")}
        for a in kv.values():
            a[:, pos:] = 0.0
        xj, cj = jtr.shared_block_apply(
            jc, pj, jnp.asarray(x), pos=jnp.asarray(pos, jnp.int32),
            cache={k: jnp.asarray(a) for k, a in kv.items()})
        ct = {k: _t(a) for k, a in kv.items()}
        xt, ct = ttr.shared_block_apply(tc, pt, _t(x), cache=ct, pos=pos)
        _close(xt, xj, LAYER_TOL)
        _close_tree(ct, cj, LAYER_TOL)
        return
    x = rng.standard_normal((2, 7, jc.d_model), dtype=np.float32)
    cache = {} if mode == "prefill" else None
    xj, cj = jtr.shared_block_apply(jc, pj, jnp.asarray(x), cache=cache)
    xt, ct = ttr.shared_block_apply(tc, pt, _t(x),
                                    cache={} if cache is not None else None)
    _close(xt, xj, LAYER_TOL)
    _close_tree(ct, cj, LAYER_TOL)


# ---------------------------------------------------------------------------
# (g) the whole model: prefill and decode against JAX's decode_step


def _jax_stepped(jm, jp, toks, max_seq):
    """JAX ``decode_step`` stepped over the prompt from a fresh cache (what
    the JAX ``SimpleEngine`` prefills with)."""
    decode = jax.jit(jm.decode_step)
    cache = jm.init_cache(toks.shape[0], max_seq)
    for i in range(toks.shape[1]):
        lg, cache = decode(jp, cache, jnp.asarray(toks[:, i:i + 1],
                                                  jnp.int32),
                           jnp.asarray(i, jnp.int32))
    return lg, cache, decode


def _close_cache(ct, cj, tol):
    assert set(ct) == set(cj)
    for group in cj:
        assert set(ct[group]) == set(cj[group])
        for k in cj[group]:
            assert tuple(ct[group][k].shape) == cj[group][k].shape, (group, k)
            assert ct[group][k].dtype == getattr(torch, str(
                cj[group][k].dtype)), (group, k)
            _close(ct[group][k], cj[group][k], tol)


@pytest.mark.parametrize("b,s", [(1, 1), (2, 6)])
def test_prefill_and_decode_match_jax(models, b, s):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(90 + s)
    toks = rng.integers(0, jm.cfg.vocab_size, (b, s))
    lj, cj, decode = _jax_stepped(jm, jp, toks, 16)
    ops.reset_launch_counts()
    lt, ct = tm.prefill(tp, {"tokens": _t(toks)}, 16)
    assert lt.shape == (b, s, jm.cfg.vocab_padded)
    _close(lt[:, -1:], lj, MODEL_TOL)
    _close_cache(ct, cj, MODEL_TOL)
    for pos in range(s, s + 3):
        tok = rng.integers(0, jm.cfg.vocab_size, (b, 1))
        lj, cj = decode(jp, cj, jnp.asarray(tok, jnp.int32),
                        jnp.asarray(pos, jnp.int32))
        lt, ct = tm.decode_step(tp, ct, _t(tok), pos)
        assert lt.shape == (b, 1, jm.cfg.vocab_padded)
        _close(lt, lj, MODEL_TOL)
        _close_cache(ct, cj, MODEL_TOL)
    assert set(ops.launch_counts().values()) == {0}


def test_prefill_then_decode_matches_longer_prefill(models):
    """The decode step at position n reproduces the prefill's row n and
    state (the property that lets the engine prefill in one call)."""
    _, _, tm, tp = models
    toks = _t(np.random.default_rng(95).integers(0, tm.cfg.vocab_size,
                                                 (1, 6)))
    full, cfull = tm.prefill(tp, {"tokens": toks}, 16)
    _, cache = tm.prefill(tp, {"tokens": toks[:, :5]}, 16)
    last, cache = tm.decode_step(tp, cache, toks[:, 5:], 5)
    _close(last[0, 0], full[0, 5], MODEL_TOL)
    for group in cfull:
        for k in cfull[group]:
            _close(cache[group][k], cfull[group][k], MODEL_TOL)


def test_forward_matches_jax(models):
    """The whole-sequence forward without state (``stage_apply``, with
    the shared blocks of hybrid models)."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(96).integers(0, jm.cfg.vocab_size, (2, 7))
    lj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, aux = tm.forward(tp, {"tokens": _t(toks)})
    _close(lt, lj, MODEL_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("n_layers,pipe", [(4, 2), (5, 2), (3, 1), (7, 2),
                                           (1, 1), (6, 3)])
def test_shared_slots_match_jax(n_layers, pipe):
    jc = tiny_cfg("zamba2-1.2b", n_layers=n_layers, pipe=pipe)
    jm, tm = JModel(jc), Model(port_cfg(jc), device="cpu")
    want = jm.init_cache(1, 8)["shared"]["k"].shape
    got = tm.init_cache(1, 8)["shared"]["k"].shape
    assert tuple(got) == want
    # the slots decode consumes: one per full segment of each stage
    k = jc.ssm.shared_attn_every
    fires = sum(tm._fires_shared(i) for n in tm.stage_sizes
                for i in range(n))
    assert fires == sum(n // k for n in jm.stage_sizes)
    assert want[0] == max(1, fires)


def test_ssm_stages_match_jax(models):
    """Each pipeline stage of the SSM families (zamba2: its shared block
    after every full segment) against JAX's ``stage_apply``, chained
    through the stages, and the stages' chain is the model's forward."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, tm.cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    zero = torch.zeros(())
    for js, ts in zip(jp["stages"], tp["stages"]):
        jx, _ = jm.stage_apply(js, (jx, jnp.zeros((), jnp.float32)))
        tx, aux = tm.stage_apply(ts, (tx, zero))
        assert float(aux) == 0.0
        _close(tx, jx, MODEL_TOL)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 5))
    h, _ = tm.hidden(tp, {"tokens": torch.from_numpy(toks)})
    want, _ = jm.hidden(jp, {"tokens": jnp.asarray(toks)})
    _close(h, want, MODEL_TOL)


def test_ssm_training_grads_match_jax(rwkv):
    """The loss of an SSM model is differentiable (the scans through
    their backward) and its gradient is ``jax.grad`` of JAX's loss,
    within 1e-4 of each leaf's largest magnitude (rwkv6's decay chain,
    ``tests/test_torch_ssm_train.py``)."""
    jm, jp, tm, tp = rwkv
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 7))
    tgts = rng.integers(0, tm.cfg.vocab_size, (2, 7))
    want = jax.grad(jm.loss)(jp, {"tokens": jnp.asarray(toks),
                                  "targets": jnp.asarray(tgts)})
    params = tl.tree_map(lambda _, a: a.clone().requires_grad_(), tp)
    loss = tm.loss(params, {"tokens": torch.from_numpy(toks),
                            "targets": torch.from_numpy(tgts)})
    got = torch.autograd.grad(loss, tl.tree_leaves(params))
    wl = jax.tree.leaves(want)
    assert len(got) == len(wl)
    for g, w in zip(got, wl):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=MODEL_TOL,
                                   atol=MODEL_TOL * np.abs(w).max())


# ---------------------------------------------------------------------------
# (h) the engines emit the same tokens


PLAN_KW = dict(n_slots=4, max_prefill=2, prompt_budget=8, page_seq=32,
               n_layers=4)


@pytest.mark.parametrize("arch,n_layers,seed,trace_kw", [
    # mirrors tests/test_serve.py::test_rwkv6_scan_matches_simple
    ("rwkv6-7b", 4, 1, dict(n=6, rate=0.8, seed=5, prompt_lens=(1, 6),
                            gen_lens=(1, 4))),
    ("zamba2-1.2b", 4, 0, dict(n=8, rate=1.5, seed=0, prompt_lens=(2, 8))),
    ("zamba2-1.2b", 5, 0, dict(n=8, rate=1.5, seed=0, prompt_lens=(1, 8))),
], ids=ARCH_IDS)
def test_simple_engine_tokens_match_jax(arch, n_layers, seed, trace_kw):
    jm, jp, tm, tp = _models(arch, n_layers, seed)
    kw = dict(trace_kw)
    n = kw.pop("n")
    want = JSimpleEngine(jm, jp, jserve_plan(None, n_stages=2, **PLAN_KW)
                         ).run(jpoisson_trace(n, vocab=jm.cfg.vocab_size,
                                              **kw))
    ops.reset_launch_counts()
    eng = SimpleEngine(tm, tp, serve_plan(None, n_stages=2, **PLAN_KW))
    trace = poisson_trace(n, vocab=tm.cfg.vocab_size, **kw)
    got = eng.run(trace)
    assert got == want
    assert any(got.values())
    live = [q for q in trace if got[q.rid]]
    assert eng.n_prefill == 1 + len(live)
    assert eng.n_decode == 1 + sum(q.gen_len - 1 for q in live)
    assert set(ops.launch_counts().values()) == {0}


def test_engine_loads_the_models_kernels(rwkv, zamba):
    """The engine's warm-up builds the kernels the model names."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6
    assert rwkv[2].kernel_modules() == [r6]
    assert zamba[2].kernel_modules() == [fa, m2]
    dense = Model(port_cfg(tiny_cfg("granite-8b")), device="cpu")
    assert dense.kernel_modules() == [fa]


# ---------------------------------------------------------------------------
# (i) parameters: carried over from JAX, and the leaves kept in fp32


def test_from_jax_params_trees(models):
    jm, jp, tm, tp = models
    assert len(tp["stages"]) == len(jp["stages"]) == jm.n_stages
    for sj, st in zip(jp["stages"], tp["stages"]):
        assert set(st) == set(sj)
        assert ("shared" in st) == tm.hybrid
    lj = jax.tree.leaves(jp)
    lt = tl.tree_leaves(tp)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        _close(b, a, 0)
    # the port's own init has the same tree
    own = tm.init(torch.Generator().manual_seed(0))
    assert [tuple(a.shape) for a in tl.tree_leaves(own)] == \
        [a.shape for a in lj]


FP32_NAMES = {"w0", "u", "gn_scale", "gn_bias", "A_log", "D", "dt_bias",
              "norm_scale", "scale", "bias"}


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_fp32_leaves_survive_the_bf16_cast(arch):
    """The leaves the JAX blocks read in fp32 stay fp32 when the port
    casts for a bf16 compute dtype (both through ``cast_for_compute``
    and through ``Model.init(dtype=...)``); every other leaf is bf16."""
    tc = tconfigs.smoke_config(tconfigs.get_config(arch))
    tm = Model(tc, device="cpu")
    for params in (
            tmodel.cast_for_compute(tm.init(torch.Generator().manual_seed(0)),
                                    torch.bfloat16),
            tm.init(torch.Generator().manual_seed(0), dtype="bfloat16")):
        seen = set()

        def check(path, a):
            seen.add(path[-1])
            want = (torch.float32 if path[-1] in FP32_NAMES
                    else torch.bfloat16)
            assert a.dtype == want, path
        tl.tree_map(check, params)
        ssm_names = ({"w0", "u", "gn_scale", "gn_bias"} if "rwkv" in arch
                     else {"A_log", "D", "dt_bias", "norm_scale"})
        assert ssm_names <= seen


# ---------------------------------------------------------------------------
# (j) the launcher, end to end on the CPU


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_launcher_serves_ssm_smoke_on_cpu(tmp_path, capsys, arch):
    out = tmp_path / "serve.jsonl"
    ops.reset_launch_counts()
    rc = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "4", "--rate", "1.5",
                       "--metrics-out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "served 4/4 requests" in text
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    run = [r for r in recs if r["event"] == "serve_run"][-1]
    assert run["arch"] == arch and run["n_served"] == 4
    assert recs[-1]["counters"]["serve/nonfinite_logits"] == 0
    assert set(ops.launch_counts().values()) == {0}
