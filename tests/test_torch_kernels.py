"""The port's flash forward against the JAX package's.

On the CPU the port's wrapper computes its plain version
(``repro_torch.kernels.ref.flash_fwd_ref``); these tests hold it against
the Pallas kernel run in interpret mode, against ``_attend`` and
against ``blocked_attention``, on the same numpy inputs.  The CUDA
kernel is held against the plain version on the card in
``test_torch_gpu.py``, which imports no JAX.

Tolerances: 2e-5 (abs and rel) in fp32, where both sides run the same
fp32 softmax and differ only in summation order; 2e-2 in bf16, the
repository's kernel tolerance (``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models.blocked_attention import blocked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn

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
    fa.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert ops.launch_counts() == {"flash_fwd": 0}


@pytest.mark.parametrize("bad", [
    dict(d=24), dict(dtype=torch.float16), dict(kv=3), dict(kv_len=0),
    dict(kv_len=9), dict(q_offset=-1), dict(mixed=True), dict(vshape=True),
])
def test_wrapper_rejects(bad):
    d = bad.get("d", 16)
    q = torch.zeros(1, 2, 4, d, dtype=bad.get("dtype", torch.float32))
    k = torch.zeros(1, 8, bad.get("kv", 2), d, dtype=q.dtype)
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
    assert "flash_fwd" in build.sources()
    path = build.lib_path("flash_fwd")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path.name.startswith("flash_fwd-")


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
