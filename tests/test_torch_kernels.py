"""The port's flash forward and backward and its fused update against
the JAX package's.

On the CPU the port's wrappers compute their plain versions
(``repro_torch.kernels.ref``); these tests hold them against the Pallas
kernels run in interpret mode, against ``_attend`` (and autodiff of it)
and against ``blocked_attention``, on the same numpy inputs.  The CUDA
kernels are held against the plain versions on the card in
``test_torch_gpu.py``, which imports no JAX.

Tolerances: 2e-5 (abs and rel) in fp32, where both sides run the same
fp32 arithmetic and differ only in summation order; 2e-2 in bf16, the
repository's kernel tolerance (``tests/test_kernels.py``); 1e-6 for the
fused update in fp32 (elementwise, the same roundings).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import fused_update as jfu
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models.blocked_attention import blocked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn
from test_torch_threads import one_thread  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _qkv(seed, b, sq, sk, H, KV, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, H, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, KV, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, KV, d), dtype=np.float32)
    return q, k, v


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# (a) the plain version against the Pallas kernel in interpret mode
FLASH_CASES = [
    # b, H, KV, sq, sk, d, causal, dtype
    (2, 4, 4, 128, 128, 64, True, "float32"),
    (1, 8, 2, 128, 128, 128, True, "float32"),
    (2, 4, 1, 128, 256, 64, False, "float32"),
    (1, 2, 2, 256, 256, 32, True, "float32"),
    (1, 4, 4, 128, 128, 16, True, "float32"),
    (1, 4, 4, 128, 128, 64, True, "bfloat16"),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_fwd_ref_matches_pallas(case):
    b, H, KV, sq, sk, d, causal, dt = case
    q, k, v = _qkv(0, b, sq, sk, H, KV, d)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    o_j = jops.flash_attention(jq, jk, jv, causal, 128, 128, True)
    # lse from the Pallas kernel on the folded layout [b, KV, G*sq]
    _, lse_j = jfa.flash_fwd(jops._fold_gqa(jq, KV),
                             jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2),
                             causal=causal, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    o_t, lse_t = ref.flash_fwd_ref(tq, tk, tv, causal=causal)
    assert o_t.dtype == tdt and o_t.shape == (b, sq, H, d)
    assert lse_t.dtype == torch.float32 and lse_t.shape == (b, H, sq)
    tol = F32_TOL if dt == "float32" else BF16_TOL
    _close(o_t.float(), np.asarray(o_j, np.float32), tol)
    _close(lse_t, np.asarray(lse_j).reshape(b, H, sq), tol)
    # the model-side entry takes the same path on CPU tensors
    _close(ops.flash_attention(tq, tk, tv, causal).float(), o_t.float(), 0)


def test_attention_ref_matches_jax():
    from repro.kernels import ref as jref
    q, k, v = _qkv(1, 2, 16, 24, 4, 2, 16)
    tr = lambda a: np.swapaxes(a, 1, 2)
    for causal in (True, False):
        o_j = jref.attention_ref(*(jnp.asarray(tr(a)) for a in (q, k, v)),
                                 causal=causal)
        o_t = ref.attention_ref(*(torch.from_numpy(tr(a).copy())
                                  for a in (q, k, v)), causal=causal)
        _close(o_t, np.asarray(o_j), F32_TOL)


# (b) positions: q_offset / kv_len against _attend and blocked_attention
OFFSET_CASES = [
    # b, sq, sk, H, KV, d, q_offset, kv_len, causal
    (1, 1, 32, 4, 2, 16, 9, 10, False),       # a decode step at pos 9
    (2, 1, 64, 8, 2, 32, 63, 64, False),      # last position of a page
    (1, 1, 48, 4, 4, 64, 0, 1, False),        # first decode position
    (1, 7, 40, 4, 2, 16, 5, 40, True),        # a chunk after 5 positions
    (2, 12, 12, 8, 2, 128, 0, 12, True),      # whole-prompt prefill
]


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_offsets_match_attend(case):
    b, sq, sk, H, KV, d, off, kv_len, causal = case
    q, k, v = _qkv(2, b, sq, sk, H, KV, d)
    q_pos = np.arange(sq) + off
    o_j = jattn._attend(None, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v), causal=causal,
                        q_pos=jnp.asarray(q_pos), k_len=sk,
                        k_valid_len=kv_len)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o_t = ops.flash_attention(tq, tk, tv, causal, q_offset=off,
                              kv_len=kv_len)
    _close(o_t, np.asarray(o_j), F32_TOL)
    o_a = tattn._attend(None, tq, tk, tv, causal=causal,
                        q_pos=torch.from_numpy(q_pos), k_len=sk,
                        k_valid_len=kv_len)
    _close(o_a, np.asarray(o_j), F32_TOL)


@pytest.mark.parametrize("pos_offset", [0, 3, 17])
def test_offsets_match_blocked_attention(pos_offset):
    b, s, H, KV, d = 1, 40, 4, 2, 32
    q, k, v = _qkv(3, b, s, s, H, KV, d)
    # blocked_attention's pos_offset shifts queries only, so the keys of
    # a chunk at pos_offset sit at 0..s-1: causal keeps kpos <= i + off
    o_j = blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            True, 16, 16, pos_offset)
    o_t = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              True, q_offset=pos_offset)
    _close(o_t, np.asarray(o_j), F32_TOL)


# the wrapper's contract on the CPU


def test_wrapper_cpu_path_never_counts():
    ops.reset_launch_counts()
    q, k, v = _qkv(4, 1, 4, 4, 2, 2, 16)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, True)
    o.sum().backward()
    ops.fused_update([torch.zeros(3)], [torch.zeros(3)], [torch.ones(3)],
                     lr=0.1, gamma=0.9)
    assert ops.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0, "fused_update": 0,
                                   "rwkv6_scan": 0, "mamba2_scan": 0,
                                   "rwkv6_scan_bwd": 0,
                                   "mamba2_scan_bwd": 0}


@pytest.mark.parametrize("bad", [
    dict(d=24), dict(dtype=torch.float16), dict(kv=3), dict(kv_len=0),
    dict(kv_len=9), dict(q_offset=-1), dict(mixed=True), dict(vshape=True),
])
def test_wrapper_rejects(bad):
    # d: q's width against k's 16 (the CPU path takes any width pair, the
    # card only the instantiated ones: tests/test_torch_gpu.py)
    d = bad.get("d", 16)
    q = torch.zeros(1, 2, 4, d, dtype=bad.get("dtype", torch.float32))
    k = torch.zeros(1, 8, bad.get("kv", 2), 16, dtype=q.dtype)
    v = k[:, :4] if bad.get("vshape") else k.clone()
    if bad.get("mixed"):
        v = v.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        fa.flash_fwd(q, k, v, causal=False, q_offset=bad.get("q_offset", 0),
                     kv_len=bad.get("kv_len"))


def test_timing_hook_sees_each_call():
    seen = []
    ops.set_timing_hook(lambda name, us: seen.append((name, us)))
    try:
        q, k, v = _qkv(5, 1, 3, 3, 2, 1, 16)
        ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    finally:
        ops.set_timing_hook(None)
    assert [n for n, _ in seen] == ["flash_fwd"] and seen[0][1] >= 0


def test_build_is_lazy_and_keyed_by_source():
    from repro_torch.kernels import build
    assert {"flash_fwd", "flash_bwd", "fused_update"} <= set(
        build.sources())
    path = build.lib_path("flash_fwd")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith("flash_fwd-")


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"


# (c) the flash backward: the plain version against the Pallas backward
# in interpret mode (through ops' GQA folding) and against autodiff of
# _attend


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_bwd(q, k, v, do, **kw):
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ref.flash_fwd_ref(tq, tk, tv, **kw)
    return ref.flash_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do),
                             **kw)


BWD_CASES = [
    # b, H, KV, sq, sk, d, causal
    (1, 2, 2, 128, 128, 16, True),
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 2, 128, 128, 16, True),
    (1, 4, 4, 128, 256, 64, False),
    (2, 4, 2, 128, 128, 16, False),
    (1, 4, 1, 128, 256, 64, False),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_ref_matches_pallas(case):
    b, H, KV, sq, sk, d, causal = case
    q, k, v = _qkv(11, b, sq, sk, H, KV, d)
    do = np.random.default_rng(12).standard_normal(
        (b, sq, H, d), dtype=np.float32)
    want = _jax_grads(lambda q_, k_, v_: jops.flash_attention(
        q_, k_, v_, causal, 128, 128, True), q, k, v, do)
    got = _port_bwd(q, k, v, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w, F32_TOL)


BWD_OFFSET_CASES = OFFSET_CASES + [
    # b, sq, sk, H, KV, d, q_offset, kv_len, causal
    (2, 16, 16, 4, 1, 64, 0, 16, True),       # G = 4
    (1, 9, 20, 2, 2, 16, 0, 13, False),       # G = 1, masked key tail
]


@pytest.mark.parametrize("case", BWD_OFFSET_CASES)
def test_flash_bwd_ref_matches_attend_vjp(case):
    b, sq, sk, H, KV, d, off, kv_len, causal = case
    q, k, v = _qkv(13, b, sq, sk, H, KV, d)
    do = np.random.default_rng(14).standard_normal(
        (b, sq, H, d), dtype=np.float32)
    q_pos = jnp.arange(sq) + off
    want = _jax_grads(lambda q_, k_, v_: jattn._attend(
        None, q_, k_, v_, causal=causal, q_pos=q_pos, k_len=sk,
        k_valid_len=kv_len), q, k, v, do)
    got = _port_bwd(q, k, v, do, causal=causal, q_offset=off,
                    kv_len=kv_len)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("causal,off,kv_len", [(True, 0, None),
                                               (False, 0, 11),
                                               (True, 4, None)])
def test_flash_attention_autograd_is_the_bwd_formula(causal, off, kv_len):
    """The port's differentiable flash_attention runs flash_bwd_ref as
    its backward on the CPU (not autograd of the plain forward)."""
    sk = 12 + off
    q, k, v = _qkv(15, 2, 12, sk, 4, 2, 16)
    do = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (2, 12, 4, 16), dtype=np.float32))
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = ops.flash_attention(*ins, causal, q_offset=off, kv_len=kv_len)
    got = torch.autograd.grad(o, ins, do)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o_r, lse = ref.flash_fwd_ref(tq, tk, tv, **kw)
    want = ref.flash_bwd_ref(tq, tk, tv, o_r, lse, do, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(o.detach(), o_r)


def test_flash_bwd_wrapper_checks():
    q, k, v = (torch.from_numpy(a) for a in _qkv(17, 1, 4, 4, 2, 2, 16))
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd(q, k, v, o, lse[:, :, :2], o, causal=True)
    with pytest.raises(TypeError):
        fa.flash_bwd(q, k, v, o, lse, o.double(), causal=True)
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, o[:, :2], lse, o, causal=True)


# (d) the fused update: plain version and CPU wrapper against the Pallas
# kernel in interpret mode and against the JAX plain version

FU_KW = dict(lr=0.05, gamma=0.9, s=6.0)


def _fu_inputs(seed, shape, g_dtype="float32"):
    rng = np.random.default_rng(seed)
    w, v, g = (rng.standard_normal(shape, dtype=np.float32)
               for _ in range(3))
    return w, v, g.astype(jnp.dtype(g_dtype))


@pytest.mark.parametrize("shape", [(8192,), (3, 1000), (7,), (64, 129)])
def test_fused_update_ref_matches_pallas(shape):
    w, v, g = _fu_inputs(18, shape)
    want = jfu.fused_update(*(jnp.asarray(a) for a in (w, v, g)),
                            interpret=True, **FU_KW)
    want_ref = jref.fused_update_ref(*(jnp.asarray(a) for a in (w, v, g)),
                                     **FU_KW)
    got = ref.fused_update_ref(*(torch.from_numpy(a) for a in (w, v, g)),
                               **FU_KW)
    for x, y, z in zip(got, want, want_ref):
        _close(x, np.asarray(y), 1e-6)
        _close(x, np.asarray(z), 1e-6)


def test_fused_update_ref_bf16_matches_jax():
    """bf16 weights (w' and ŵ in bf16) and bf16 gradients."""
    w, v, g = _fu_inputs(19, (3, 517), "bfloat16")
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    want = jref.fused_update_ref(jw, jnp.asarray(v), jnp.asarray(g),
                                 **FU_KW)
    want_k = jfu.fused_update(jw, jnp.asarray(v), jnp.asarray(g),
                              interpret=True, **FU_KW)
    tg = torch.from_numpy(np.asarray(g, np.float32)).to(torch.bfloat16)
    got = ref.fused_update_ref(torch.from_numpy(w).to(torch.bfloat16),
                               torch.from_numpy(v), tg, **FU_KW)
    assert got[0].dtype == got[2].dtype == torch.bfloat16
    for x, y, z in zip(got, want, want_k):
        _close(x.float(), np.asarray(y, np.float32), BF16_TOL)
        _close(x.float(), np.asarray(z, np.float32), BF16_TOL)


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_fused_update_wrapper_in_place_matches_pallas(g_dtype):
    """ops.fused_update on a ragged group, in place, against the Pallas
    kernel leaf by leaf (fp32 weights, fp32 or bf16 gradients; ŵ in
    fp32 for some leaves, none for others)."""
    shapes = [(8192,), (5, 77), (3,)]
    ins = [_fu_inputs(20 + i, s, g_dtype) for i, s in enumerate(shapes)]
    ws = [torch.from_numpy(w.copy()) for w, _, _ in ins]
    vs = [torch.from_numpy(v.copy()) for _, v, _ in ins]
    gs = [torch.from_numpy(np.asarray(g, np.float32)).to(
        getattr(torch, g_dtype)) for _, _, g in ins]
    whats = [torch.empty(shapes[0]), None, torch.empty(shapes[2])]
    ops.fused_update(ws, vs, gs, whats=whats, **FU_KW)
    tol = 1e-6 if g_dtype == "float32" else BF16_TOL
    for i, (w, v, g) in enumerate(ins):
        jw, jv, jwh = jfu.fused_update(
            jnp.asarray(w), jnp.asarray(v), jnp.asarray(g),
            interpret=True, **FU_KW)
        _close(ws[i], np.asarray(jw), tol)
        _close(vs[i], np.asarray(jv), tol)
        if whats[i] is not None:
            _close(whats[i], np.asarray(jwh), tol)


def test_fused_update_wrapper_checks():
    w = torch.zeros(4)
    with pytest.raises(TypeError, match="fp32"):
        ops.fused_update([w.double()], [w], [w], lr=0.1, gamma=0.9)
    with pytest.raises(ValueError, match="differ in length"):
        ops.fused_update([w], [w, w], [w], lr=0.1, gamma=0.9)
    with pytest.raises(ValueError, match="!="):
        ops.fused_update([w], [torch.zeros(5)], [w], lr=0.1, gamma=0.9)
    with pytest.raises(TypeError, match="group"):
        ops.fused_update([w, w], [w, w], [w, w.bfloat16()], lr=0.1,
                         gamma=0.9)
