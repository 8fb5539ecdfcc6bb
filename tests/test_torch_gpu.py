"""The port's CUDA kernel and model path on the card, held against the
port's plain versions (the CPU path).  Every test is marked ``gpu`` and
skips where there is no card.

This file imports neither JAX nor the JAX package, and nothing from
``conftest.py`` (which imports JAX), so that it runs on a machine with a
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_gpu.py

Tolerances: 2e-5 (abs and rel) in fp32 with TF32 off, 2e-2 in bf16 (the
repository's kernel tolerances); 1e-4 for fp32 model logits.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.planner import serve_plan  # noqa: E402
from repro_torch.serve import SimpleEngine, poisson_trace  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2
MODEL_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, b, sq, sk, H, KV, d, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    return mk(b, sq, H, d), mk(b, sk, KV, d), mk(b, sk, KV, d)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


GPU_CASES = [
    # b, sq, sk, H, KV, d, q_offset, kv_len, causal, dtype
    (1, 1, 64, 32, 8, 128, 36, 37, False, torch.bfloat16),
    (1, 1, 64, 32, 8, 128, 0, 1, False, torch.bfloat16),
    (1, 12, 12, 32, 8, 128, 0, 12, True, torch.bfloat16),
    (2, 256, 256, 4, 4, 64, 0, 256, True, torch.float32),
    (1, 256, 256, 8, 2, 128, 0, 256, True, torch.float32),
    (2, 128, 256, 4, 1, 64, 0, 256, False, torch.float32),
    (1, 100, 300, 4, 2, 32, 200, 300, True, torch.float32),
    (1, 70, 70, 2, 2, 16, 0, 70, True, torch.float32),
    (3, 65, 130, 4, 2, 64, 0, 97, False, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_kernel_matches_plain(card, case):
    b, sq, sk, H, KV, d, off, kv_len, causal, dt = case
    q, k, v = _qkv(6, b, sq, sk, H, KV, d, dt)
    before = fa.launches
    o, lse = fa.flash_fwd(q, k, v, causal=causal, q_offset=off,
                          kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert o.shape == q.shape and o.dtype == dt
    assert lse.shape == (b, H, sq) and lse.dtype == torch.float32
    o_r, lse_r = ref.flash_fwd_ref(q, k, v, causal=causal, q_offset=off,
                                   kv_len=kv_len)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    _close(o, o_r, tol)
    _close(lse, lse_r, tol)


@pytest.mark.gpu
def test_kernel_reads_cache_slice_in_place(card):
    cache = torch.randn(2, 3, 1, 64, 8, 128, device=card,
                        dtype=torch.bfloat16)
    q = torch.randn(1, 1, 32, 128, device=card, dtype=torch.bfloat16)
    k, v = cache[0, 1], cache[1, 1]
    o, _ = fa.flash_fwd(q, k, v, causal=False, q_offset=20, kv_len=21)
    o_r, _ = ref.flash_fwd_ref(q, k, v, causal=False, q_offset=20,
                               kv_len=21)
    _close(o, o_r, BF16_TOL)


@pytest.mark.gpu
def test_kernel_reads_strided_inputs(card):
    # q, k, v as slices of one fused projection output: rows are strided
    qkv = torch.randn(1, 9, 48, 32, device=card)
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    o_r, lse_r = ref.flash_fwd_ref(q, k, v, causal=True)
    _close(o, o_r, F32_TOL)
    _close(lse, lse_r, F32_TOL)


@pytest.mark.gpu
def test_wrapper_raises_on_card(card):
    q = torch.zeros(1, 2, 4, 16, device=card)
    k = torch.zeros(1, 4, 2, 16, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q[..., :8], k[..., :8], k[..., :8], causal=True)
    strided = k.transpose(2, 3).contiguous().transpose(2, 3)
    assert strided.stride(-1) != 1
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.flash_fwd(q, strided, k, causal=True)
    with pytest.raises(ValueError, match="devices"):
        fa.flash_fwd(q, k.cpu(), k, causal=True)


def _smoke_cfg():
    return smoke_config(get_config("granite-8b")).replace(
        n_layers=4, n_kv_heads=2, compute_dtype="float32")


def _on(params, device):
    if isinstance(params, dict):
        return {k: _on(v, device) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(_on(v, device) for v in params)
    return params.to(device)


@pytest.mark.gpu
def test_model_on_card_matches_cpu(card):
    cfg = _smoke_cfg()
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _on(p_cpu, card)
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launch_counts()
    with torch.inference_mode():
        l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 16)
        l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.to(card)}, 16)
        _close(l_g, l_c, MODEL_TOL)
        for pos in range(9, 12):
            tok = toks[:, pos - 9:pos - 8]
            d_c, c_c = cpu.decode_step(p_cpu, c_c, tok, pos)
            d_g, c_g = gpu.decode_step(p_gpu, c_g, tok.to(card), pos)
            _close(d_g, d_c, MODEL_TOL)
            _close(c_g["layers"]["k"], c_c["layers"]["k"], MODEL_TOL)
    # one launch per layer per call on the card, none on the CPU
    assert ops.launch_counts()["flash_fwd"] == cfg.n_layers * 4


@pytest.mark.gpu
def test_engine_tokens_on_card_match_cpu(card):
    cfg = _smoke_cfg()
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    splan = serve_plan(cfg, n_stages=1, n_slots=1, prompt_budget=8,
                       page_seq=32)
    trace = poisson_trace(8, rate=1.5, seed=0, prompt_lens=(2, 8),
                          vocab=cfg.vocab_size)
    want = SimpleEngine(cpu, p_cpu, splan).run(trace)
    eng = SimpleEngine(gpu, _on(p_cpu, card), splan)
    ops.reset_launch_counts()
    got = eng.run(trace)
    assert got == want
    assert ops.launch_counts()["flash_fwd"] == cfg.n_layers * (
        eng.n_prefill + eng.n_decode)
