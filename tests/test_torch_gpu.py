"""The port's CUDA kernels and model path on the card, held against the
port's plain versions (the CPU path).  Every test is marked ``gpu`` and
skips where there is no card.

This file imports neither JAX nor the JAX package, and nothing from
``conftest.py`` (which imports JAX), so that it runs on a machine with a
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_gpu.py

Tolerances: 2e-5 (abs and rel) in fp32 with TF32 off, 2e-2 in bf16 (the
repository's kernel tolerances); for the backward in fp32 atol 2e-5 and
rtol 1e-3 (``tests/test_kernels.py::test_flash_bwd``'s); 1e-6 for the
fused update in fp32 (the kernel rounds where its plain version does);
the fp32 attention backward on the card and on the CPU each against an
fp64 evaluation at atol 2e-5 / rtol 1e-3 (over 200 seeds both sides'
largest error was 5.6e-6, NVIDIA H100 80GB HBM3); the simulator on the
card against the CPU at the CPU parity tests' rtol 1e-5 / atol 1e-6;
resume bit for bit; IR rounds of every round schedule as the training
ticks;
for the two scans 2e-5 on fp32 outputs (every step is fp32 on both
sides, in another summation order) and 2e-2 on the bf16 rwkv6 y (one
bf16 rounding of an fp32 value); 1e-4 for fp32 model logits and
states; training ticks as the CPU parity tests.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_update as fu  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.planner import serve_plan  # noqa: E402
from repro_torch.serve import SimpleEngine, poisson_trace  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2
MODEL_TOL = 1e-4
BWD_F32_TOL = (2e-5, 1e-3)      # atol, rtol: tests/test_kernels.py's
ATTN_F64_TOL = (2e-5, 1e-3)     # atol, rtol: each side against fp64
# card against CPU over the 200-seed sweep: each side's largest error
# against fp64 there is 5.615e-6, so the two differ by at most ~1.1e-5;
# a larger difference is a fault of one side, not accumulation order
ATTN_SWEEP_CARD_CPU = 1.1e-5


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


def _randn(seed, *shape, dtype=torch.float32):
    """A seeded N(0, 1) tensor on the card (drawn with numpy, so a test's
    inputs do not depend on what earlier tests drew)."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)).to("cuda", dtype)


def _close(got, want, tol, rtol=None):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=tol, rtol=tol if rtol is None else rtol)


# bf16 packed-row edges of the tensor-core kernels: G in {1, 2, 4, 8}
# with sq G off the 16- and 64-row blocks, kv_len off the 64-key tile,
# q_offset > 0 causal and not, every head_dim, sq != sk
MMA_EDGES = [(*case, torch.bfloat16) for case in [
    # b, sq, sk, H, KV, d, q_offset, kv_len, causal
    (2, 37, 37, 8, 8, 64, 0, 37, True),        # G 1, 37 rows
    (1, 21, 50, 8, 4, 32, 29, 50, True),       # G 2, 42 rows, offset
    (2, 13, 100, 16, 4, 128, 0, 77, False),    # G 4, 52 rows, kv_len 77
    (1, 3, 70, 32, 4, 16, 60, 63, True),       # G 8, 24 rows, offset
    (1, 2, 64, 16, 2, 64, 10, 12, False),      # G 8, 16 rows: one warp
    (1, 1, 200, 8, 1, 128, 130, 131, False),   # G 8 decode, 3 key tiles
    (2, 100, 300, 4, 2, 32, 200, 300, True),   # G 2, 200 rows
    (1, 70, 70, 2, 2, 16, 0, 70, True),        # d 16
    (1, 65, 65, 4, 4, 64, 0, 65, True),        # row 64's own key: tile 2
    (2, 128, 128, 32, 8, 128, 0, 128, True),   # the training layout
]]

# the bf16 dk/dv kernel's own edges (64-key blocks over 64-row packed
# tiles), as chip_smoke.py's DKV_EDGES
DKV_EDGES = [(*case, torch.bfloat16) for case in [
    # b, sq, sk, H, KV, d, q_offset, kv_len, causal
    (1, 192, 192, 2, 2, 64, 0, 192, True),     # key block 1 at row tile 1
    (1, 40, 120, 8, 2, 128, 50, 120, True),    # G 4, first row mid-tile
    (2, 70, 160, 4, 2, 64, 0, 100, False),     # kv_len 100 of sk 160
    (2, 1, 90, 16, 2, 128, 70, 71, True),      # sq 1, G 8
]]

GPU_CASES = [
    # b, sq, sk, H, KV, d, q_offset, kv_len, causal, dtype
    (1, 1, 64, 32, 8, 128, 36, 37, False, torch.bfloat16),
    (1, 1, 64, 32, 8, 128, 0, 1, False, torch.bfloat16),
    (1, 12, 12, 32, 8, 128, 0, 12, True, torch.bfloat16),
    # zamba2-1.2b's shared attention block (32 heads, KV 32, head_dim 64)
    (1, 1, 64, 32, 32, 64, 36, 37, False, torch.bfloat16),
    (1, 12, 12, 32, 32, 64, 0, 12, True, torch.bfloat16),
    (2, 256, 256, 4, 4, 64, 0, 256, True, torch.float32),
    (1, 256, 256, 8, 2, 128, 0, 256, True, torch.float32),
    (2, 128, 256, 4, 1, 64, 0, 256, False, torch.float32),
    (1, 100, 300, 4, 2, 32, 200, 300, True, torch.float32),
    (1, 70, 70, 2, 2, 16, 0, 70, True, torch.float32),
    (3, 65, 130, 4, 2, 64, 0, 97, False, torch.bfloat16),
] + MMA_EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_kernel_matches_plain(card, case):
    b, sq, sk, H, KV, d, off, kv_len, causal, dt = case
    q, k, v = _qkv(6, b, sq, sk, H, KV, d, dt)
    before = (fa.launches, fa.launches_mma)
    o, lse = fa.flash_fwd(q, k, v, causal=causal, q_offset=off,
                          kv_len=kv_len)
    torch.cuda.synchronize()
    # bf16 on the tensor-core kernel, fp32 on the FMA kernel
    mma = int(dt == torch.bfloat16)
    assert (fa.launches, fa.launches_mma) == (before[0] + 1,
                                              before[1] + mma)
    assert o.shape == q.shape and o.dtype == dt
    assert lse.shape == (b, H, sq) and lse.dtype == torch.float32
    o_r, lse_r = ref.flash_fwd_ref(q, k, v, causal=causal, q_offset=off,
                                   kv_len=kv_len)
    tol = F32_TOL if dt == torch.float32 else BF16_TOL
    _close(o, o_r, tol)
    _close(lse, lse_r, tol)


@pytest.mark.gpu
def test_fp32_stays_on_fma_kernels(card):
    q, k, v = _qkv(15, 1, 40, 40, 8, 2, 64, torch.float32)
    ops.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    fa.flash_bwd(q, k, v, o, lse, _randn(16, *o.shape), causal=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_fwd"] == 1
    assert ops.launch_counts()["flash_bwd_dq"] == 1
    assert ops.launch_counts()["flash_bwd_dkv"] == 1
    assert ops.variant_counts() == {"flash_fwd_mma": 0,
                                    "flash_bwd_dq_mma": 0,
                                    "flash_bwd_dkv_mma": 0,
                                    "rwkv6_scan_decode": 0,
                                    "rwkv6_scan_chunk": 0,
                                    "mamba2_scan_decode": 0,
                                    "mamba2_scan_chunk": 0}


@pytest.mark.gpu
def test_mma_rejects_misaligned_bf16(card):
    base = _randn(17, 1, 5 * 68 + 8, dtype=torch.bfloat16)
    k = _randn(18, 1, 5, 2, 16, dtype=torch.bfloat16)
    # rows 68 elements (136 bytes) apart: not a multiple of 16 bytes
    q = base.as_strided((1, 5, 4, 16), (base.stride(0), 68, 16, 1))
    before = (fa.launches, fa.launches_mma)
    with pytest.raises(ValueError, match="q: sequence stride 68"):
        fa.flash_fwd(q, k, k, causal=True)
    # a data pointer 2 bytes past a 16-byte boundary
    shifted = base.as_strided((1, 5, 2, 16), (base.stride(0), 32, 16, 1),
                              storage_offset=1)
    with pytest.raises(ValueError, match="k: data pointer"):
        fa.flash_fwd(k.reshape(1, 5, 2, 16), shifted, k, causal=True)
    assert (fa.launches, fa.launches_mma) == before
    o = torch.zeros(1, 5, 4, 16, device=card, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 5, device=card)
    with pytest.raises(ValueError, match="do: sequence stride 68"):
        fa.flash_bwd(o, k, k, o, lse, q, causal=True)


@pytest.mark.gpu
def test_kernel_reads_cache_slice_in_place(card):
    cache = _randn(19, 2, 3, 1, 64, 8, 128, dtype=torch.bfloat16)
    q = _randn(20, 1, 1, 32, 128, dtype=torch.bfloat16)
    k, v = cache[0, 1], cache[1, 1]
    o, _ = fa.flash_fwd(q, k, v, causal=False, q_offset=20, kv_len=21)
    o_r, _ = ref.flash_fwd_ref(q, k, v, causal=False, q_offset=20,
                               kv_len=21)
    _close(o, o_r, BF16_TOL)


@pytest.mark.gpu
def test_kernel_reads_strided_inputs(card):
    # q, k, v as slices of one fused projection output: rows are strided
    qkv = _randn(21, 1, 9, 48, 32)
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


BWD_CASES = [
    # b, sq, sk, H, KV, d, q_offset, kv_len, causal, dtype
    (2, 128, 128, 4, 4, 64, 0, 128, True, torch.float32),
    (1, 256, 256, 8, 2, 128, 0, 256, True, torch.float32),
    (2, 128, 256, 4, 1, 64, 0, 256, False, torch.float32),
    (1, 100, 300, 4, 2, 32, 200, 300, True, torch.float32),
    (1, 70, 70, 2, 2, 16, 0, 70, True, torch.float32),
    (3, 65, 130, 8, 2, 64, 0, 97, False, torch.float32),
    (2, 128, 128, 32, 8, 128, 0, 128, True, torch.bfloat16),
    (3, 65, 130, 8, 2, 64, 0, 97, False, torch.bfloat16),
] + MMA_EDGES + DKV_EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_kernels_match_plain(card, case):
    """In bf16 dq and dk/dv run on the tensor-core kernels, in fp32 on the
    FMA kernels, both from the same forward's lse; dk and dv are exactly
    zero for keys past kv_len."""
    b, sq, sk, H, KV, d, off, kv_len, causal, dt = case
    q, k, v = _qkv(8, b, sq, sk, H, KV, d, dt)
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    do = _randn(22, *o.shape, dtype=dt)
    counters = lambda: (fa.launches_dq, fa.launches_dkv, fa.launches_dq_mma,
                        fa.launches_dkv_mma)
    before = counters()
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    mma = int(dt == torch.bfloat16)
    assert counters() == (before[0] + 1, before[1] + 1, before[2] + mma,
                          before[3] + mma)
    assert bool((dk[:, kv_len:] == 0).all())
    assert bool((dv[:, kv_len:] == 0).all())
    want = ref.flash_bwd_ref(q, k, v, o, lse, do, **kw)
    tol, rtol = BWD_F32_TOL if dt == torch.float32 else (BF16_TOL, None)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dt and got.shape == w.shape
        _close(got, w, tol, rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DKV_EDGES + MMA_EDGES[-1:])
def test_dkv_mma_writes_every_key_and_repeats_bitwise(card, case):
    """The bf16 dk/dv kernel into NaN-filled outputs, twice: every key is
    written (no NaN is left) and the second run repeats the first bit for
    bit (no atomics)."""
    b, sq, sk, H, KV, d, off, kv_len, causal, dt = case
    q, k, v = _qkv(10, b, sq, sk, H, KV, d, dt)
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    do = _randn(23, *o.shape, dtype=dt)
    _, launch_dkv, (_, dk, dv) = fa._bwd_launchers(q, k, v, o, lse, do,
                                                   **kw)
    runs = []
    for _ in range(2):
        dk.fill_(float("nan"))
        dv.fill_(float("nan"))
        launch_dkv()
        torch.cuda.synchronize()
        runs.append((dk.clone(), dv.clone()))
    for t in runs[0]:
        assert bool(torch.isfinite(t).all())
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def _attention_grads_f64(q, k, v, do):
    """dq, dk, dv of causal GQA attention (q [b, s, H, d], k and v
    [b, s, KV, d]) by autograd in fp64 on the CPU: the function
    ``flash_bwd_ref`` evaluates in fp32, with no rounding to speak of."""
    q, k, v, do = (t.detach().cpu().double() for t in (q, k, v, do))
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    G = q.shape[2] // k.shape[2]
    kk, vv = (t.repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / q.shape[-1] ** 0.5
    sq = q.shape[1]
    mask = torch.ones(sq, sq, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    return torch.autograd.grad(o, (q, k, v), do)


def _attention_grads_vs_f64(seed):
    """The fp32 flash backward's dq, dk, dv on the card and on the CPU,
    each against the fp64 evaluation: (card, CPU) max over the three of
    |error| / (atol + rtol |fp64|) at ``ATTN_F64_TOL``, (card, CPU) max
    |error|, and the two sides' gradients."""
    q, k, v = _qkv(seed, 2, 33, 33, 8, 2, 32, torch.float32)
    do = _randn(seed + 1, 2, 33, 8, 32)
    want = _attention_grads_f64(q, k, v, do)
    atol, rtol = ATTN_F64_TOL
    score, worst, grads = [], [], []
    for dev in ("cuda", "cpu"):
        ins = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention(*ins, True)
        got = [g.cpu() for g in torch.autograd.grad(o, ins, do.to(dev))]
        err = [(g.double() - w).abs() for g, w in zip(got, want)]
        score.append(max(float((e / (atol + rtol * w.abs())).max())
                         for e, w in zip(err, want)))
        worst.append(max(float(e.max()) for e in err))
        grads.append(got)
    return score, worst, grads


@pytest.mark.gpu
def test_attention_grads_on_card_match_cpu(card):
    """The fp32 attention backward on the card (FMA flash kernels) and on
    the CPU (``flash_bwd_ref``): each held to the fp64 evaluation of the
    same gradients within ``ATTN_F64_TOL``, and the card to the CPU
    within ``BWD_F32_TOL``."""
    score, _, (card_g, cpu_g) = _attention_grads_vs_f64(9)
    assert max(score) <= 1.0, score
    for got, want in zip(card_g, cpu_g):
        _close(got, want, *BWD_F32_TOL)


@pytest.mark.gpu
def test_attention_grads_f64_sweep(card):
    """200 seeds of the case above: both sides within ``ATTN_F64_TOL``
    of fp64 on every seed, the card's largest error not above twice the
    CPU's, and the card within ``ATTN_SWEEP_CARD_CPU`` of the CPU on
    every seed (the seeds beyond it are named).  Prints the maxima."""
    runs = [_attention_grads_vs_f64(seed) for seed in range(200)]
    card_s, cpu_s = (max(r[0][i] for r in runs) for i in (0, 1))
    card_e, cpu_e = (max(r[1][i] for r in runs) for i in (0, 1))
    apart = [max(float((a - b).abs().max()) for a, b in zip(*r[2]))
             for r in runs]
    print(f"\nattention grads vs fp64 over 200 seeds: card max |err| "
          f"{card_e:.3e} (score {card_s:.3f}), CPU max |err| {cpu_e:.3e} "
          f"(score {cpu_s:.3f}) at atol/rtol {ATTN_F64_TOL}; card vs CPU "
          f"max |d| {max(apart):.3e}")
    assert card_s <= 1.0 and cpu_s <= 1.0
    assert card_e <= 2 * cpu_e
    beyond = {seed: d for seed, d in enumerate(apart)
              if d > ATTN_SWEEP_CARD_CPU}
    assert not beyond, f"card vs CPU beyond {ATTN_SWEEP_CARD_CPU}: {beyond}"


# ragged leaves: one count that is not a multiple of the kernel's block
FU_SHAPES = [(64, 48), (4099,), (7,), (3, 1000, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("g_dt,what_dt", [
    (torch.float32, None), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_fused_update_matches_plain(card, g_dt, what_dt):
    rng = np.random.default_rng(10)
    mk = lambda s, dt=torch.float32: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32)).to(card, dt)
    ws = [mk(s) for s in FU_SHAPES]
    vs = [mk(s) for s in FU_SHAPES]
    gs = [mk(s, g_dt) for s in FU_SHAPES]
    whats = (None if what_dt is None else
             [torch.empty(s, device=card, dtype=what_dt)
              for s in FU_SHAPES])
    want = [ref.fused_update_ref(w, v, g, lr=0.05, gamma=0.9, s=6.0,
                                 what_dtype=what_dt)
            for w, v, g in zip(ws, vs, gs)]
    before = fu.launches
    ops.fused_update(ws, vs, gs, lr=0.05, gamma=0.9, s=6.0, whats=whats)
    torch.cuda.synchronize()
    assert fu.launches == before + 1
    tol = BF16_TOL if what_dt == torch.bfloat16 else 1e-6
    for i, (w2, v2, wh2) in enumerate(want):
        _close(ws[i], w2, 1e-6)
        _close(vs[i], v2, 1e-6)
        if whats is not None:
            _close(whats[i], wh2, tol)


@pytest.mark.gpu
def test_fused_update_group_larger_than_table_raises(card):
    """One launch per group: a group of more tensors than the kernel's
    table holds raises and leaves the tensors as they were."""
    ws = [torch.ones(3, device=card) for _ in range(65)]
    vs = [torch.zeros(3, device=card) for _ in range(65)]
    gs = [torch.ones(3, device=card) for _ in range(65)]
    before = fu.launches
    with pytest.raises(ValueError, match="at most 64"):
        ops.fused_update(ws, vs, gs, lr=0.05, gamma=0.9)
    assert fu.launches == before
    assert all(bool((w == 1).all()) for w in ws)


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


@pytest.mark.gpu
@pytest.mark.parametrize("mode,fused_predict,bwd_dtype", [
    ("spectrain", False, None), ("pipedream", False, None),
    ("spectrain", True, "bfloat16")])
def test_training_ticks_on_card_match_cpu(card, mode, fused_predict,
                                          bwd_dtype):
    """2(S-1)+3 streaming ticks on 4 stages at the smoke size in fp32:
    the card (flash forward/backward and fused update kernels) against
    the CPU (their plain versions).  Losses to rtol 1e-5, every state
    leaf to rtol 1e-4 / atol 1e-5 (the CPU parity tests' tolerances);
    with a bf16 backward, 2e-2."""
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models.layers import tree_leaves
    cfg = _smoke_cfg().replace(mesh_plan=get_config("granite-8b").mesh_plan)
    S = 4
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2 * (S - 1) + 3):
        t = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    out = {}
    ops.reset_launch_counts()
    for model, params in ((cpu, p_cpu), (gpu, _on(p_cpu, card))):
        state = ps.make_state(model, params, batches[0], mode=mode,
                              fused_predict=fused_predict)
        step = ps.make_train_step(model, mode=mode, lr=0.05,
                                  bwd_dtype=bwd_dtype)
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        out[model.device.type] = (state, losses)
    n = len(batches)
    assert ops.launch_counts() == {
        "flash_fwd": 2 * cfg.n_layers * n, "flash_bwd_dq": cfg.n_layers * n,
        "flash_bwd_dkv": cfg.n_layers * n, "fused_update": (S + 1) * n,
        "rwkv6_scan": 0, "mamba2_scan": 0}
    (s_c, l_c), (s_g, l_g) = out["cpu"], out["cuda"]
    tol = 2e-2 if bwd_dtype else None
    np.testing.assert_allclose(l_g, l_c, rtol=tol or 1e-5)
    keys = ["params", "momentum"] + (["pred"] if mode == "spectrain"
                                     else ["w_stash"])
    for key in keys:
        for g, c in zip(tree_leaves(s_g[key]), tree_leaves(s_c[key])):
            np.testing.assert_allclose(
                g.float().cpu().numpy(), c.float().numpy(),
                rtol=tol or 1e-4, atol=tol or 1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# the recurrences: rwkv6_scan and mamba2_scan against their plain versions


def _decays_like_the_models(rng, shape, kind, zeros=0.0):
    """The models' decays; with ``zeros``, that share of them exactly 0
    (a reset, which the chunked kernels' products must carry exactly)."""
    if kind == "rwkv6":       # w = exp(-exp(logw)), logw up to ~4.2
        d = np.exp(-np.exp(rng.uniform(-3.0, 4.2, shape)))
    else:
        d = np.exp(-rng.uniform(0.0, 11.5, shape))    # down to ~1e-5
    if zeros:
        d = np.where(rng.random(shape) < zeros, 0.0, d)
    return d


def _variant_step(kind, s, before):
    """Assert the call of length s launched exactly its variant: s = 1
    the decode kernel, s >= 64 the chunked one, else the stepwise one."""
    after = ops.variant_counts()
    want = {"decode": int(s == 1), "chunk": int(s >= 64)}
    got = {v: after[f"{kind}_scan_{v}"] - before[f"{kind}_scan_{v}"]
           for v in want}
    assert got == want


RWKV_GPU_CASES = [
    # b, s, h, hd, dtype[, share of exact-zero decays]: decode, prefill,
    # ragged, long, each head size
    (1, 1, 64, 64, torch.bfloat16),
    (1, 12, 64, 64, torch.bfloat16),
    (2, 37, 3, 16, torch.float32),
    (1, 37, 4, 32, torch.bfloat16),
    (1, 300, 2, 64, torch.float32),
    # the chunked kernel: one chunk, one chunk and a step, a partial last
    # chunk, b 2, every head size, exact zeros; and decode at b 2
    (1, 64, 4, 64, torch.float32),
    (1, 65, 4, 64, torch.bfloat16),
    (2, 200, 3, 16, torch.float32, 0.05),
    (2, 130, 2, 32, torch.bfloat16, 0.05),
    (1, 2048, 64, 64, torch.bfloat16),
    (2, 1, 5, 32, torch.float32),
    # the pipelined engine's decode wave: 8 rows at full width
    (8, 1, 64, 64, torch.float32),
    (8, 1, 64, 64, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RWKV_GPU_CASES)
def test_rwkv6_kernel_matches_plain(card, case):
    b, s, h, hd, dt = case[:5]
    rng = np.random.default_rng(11)
    mk = lambda sh, sc=1.0, d=torch.float32: torch.from_numpy(
        rng.standard_normal(sh, dtype=np.float32) * sc).to(card, d)
    r, k, v = mk((b, s, h, hd), d=dt), mk((b, s, h, hd), 0.3, dt), \
        mk((b, s, h, hd), d=dt)
    w = torch.from_numpy(_decays_like_the_models(
        rng, (b, s, h, hd), "rwkv6", *case[5:]).astype(np.float32)).to(card)
    u, S0 = mk((h, hd), 0.3), mk((b, h, hd, hd), 0.1)
    before = ops.launch_counts()["rwkv6_scan"]
    before_v = ops.variant_counts()
    y, sT = ops.rwkv6_scan(r, k, v, w, u, S0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rwkv6_scan"] == before + 1
    _variant_step("rwkv6", s, before_v)
    assert y.shape == r.shape and y.dtype == dt
    tr = lambda t: t.transpose(1, 2)
    y_r, sT_r = ref.rwkv6_ref(tr(r), tr(k), tr(v), tr(w), u, S0)
    _close(y, tr(y_r).to(dt), F32_TOL if dt == torch.float32 else BF16_TOL)
    _close(sT, sT_r, F32_TOL)
    # the models' call: S_T written over S0 in place, bit for bit
    S_in = S0.clone()
    y_in, sT_in = ops.rwkv6_scan(r, k, v, w, u, S_in, out=S_in)
    assert sT_in is S_in
    _close(y_in, y, 0)
    _close(S_in, sT, 0)


MAMBA_GPU_CASES = [
    # b, s, h, p, n, g, dtype[, share of exact-zero decays]
    (1, 1, 64, 64, 64, 1, torch.bfloat16),
    (1, 12, 64, 64, 64, 1, torch.bfloat16),
    (2, 37, 4, 16, 32, 2, torch.float32),
    (1, 37, 8, 32, 16, 4, torch.bfloat16),
    (1, 300, 2, 64, 64, 1, torch.float32),
    # the chunked kernel: one chunk, one chunk and a step, a partial last
    # chunk, b 2, g 4, every p and n, exact zeros; and decode at b 2
    (1, 64, 4, 64, 64, 1, torch.float32),
    (1, 65, 4, 64, 64, 1, torch.bfloat16),
    (2, 200, 8, 32, 16, 4, torch.float32, 0.05),
    (2, 130, 4, 16, 32, 2, torch.bfloat16, 0.05),
    (1, 2048, 64, 64, 64, 1, torch.bfloat16),
    (2, 1, 8, 32, 16, 4, torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MAMBA_GPU_CASES)
def test_mamba2_kernel_matches_plain(card, case):
    b, s, h, p, n, g, dt = case[:7]
    rng = np.random.default_rng(12)
    mk = lambda sh, sc=1.0, d=torch.float32: torch.from_numpy(
        rng.standard_normal(sh, dtype=np.float32) * sc).to(card, d)
    x = mk((b, s, h, p), d=dt)
    delta = torch.nn.functional.softplus(mk((b, s, h)))
    decay = torch.from_numpy(_decays_like_the_models(
        rng, (b, s, h), "mamba2", *case[7:]).astype(np.float32)).to(card)
    # B and C as the model has them: strided views of one projection
    bc = mk((b, s, 2 * g * n), 0.5, dt)
    B, C = (t.reshape(b, s, g, n) for t in bc.chunk(2, dim=-1))
    S0 = mk((b, h, p, n), 0.1)
    before = ops.launch_counts()["mamba2_scan"]
    before_v = ops.variant_counts()
    y, sT = ops.mamba2_scan(x, delta, decay, B, C, S0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mamba2_scan"] == before + 1
    _variant_step("mamba2", s, before_v)
    assert y.shape == x.shape and y.dtype == torch.float32
    tr = lambda t: t.transpose(1, 2)
    per_head = lambda t: tr(t.repeat_interleave(h // g, dim=2))
    y_r, sT_r = ref.mamba2_ref(tr(x), tr(delta), tr(decay), per_head(B),
                               per_head(C), S0)
    _close(y, tr(y_r), F32_TOL)
    _close(sT, sT_r, F32_TOL)
    # the models' call: S_T written over S0 in place, bit for bit
    S_in = S0.clone()
    y_in, sT_in = ops.mamba2_scan(x, delta, decay, B, C, S_in, out=S_in)
    assert sT_in is S_in
    _close(y_in, y, 0)
    _close(S_in, sT, 0)


def _scan_inputs(kind, b, s, h, d, dt, rng):
    """A scan's inputs at width d (rwkv6 hd = d; mamba2 p = n = d, g 1),
    with the models' decays and 5% exact zeros."""
    mk = lambda sh, sc=1.0, t=torch.float32: torch.from_numpy(
        rng.standard_normal(sh, dtype=np.float32) * sc).to("cuda", t)
    dec = lambda sh: torch.from_numpy(_decays_like_the_models(
        rng, sh, kind, 0.05).astype(np.float32)).to("cuda")
    if kind == "rwkv6":
        return (mk((b, s, h, d), t=dt), mk((b, s, h, d), 0.3, dt),
                mk((b, s, h, d), t=dt), dec((b, s, h, d)), mk((h, d), 0.3),
                mk((b, h, d, d), 0.1))
    bc = mk((b, s, 2 * d), 0.5, dt)
    B, C = (t.reshape(b, s, 1, d) for t in bc.chunk(2, dim=-1))
    return (mk((b, s, h, d), t=dt), torch.nn.functional.softplus(
        mk((b, s, h))), dec((b, s, h)), B, C, mk((b, h, d, d), 0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,s", [(k, s) for k in ("rwkv6", "mamba2")
                                    for s in (1, 12, 130)])
def test_scan_kernels_repeat_bitwise_and_write_only_their_outputs(
        card, kind, s, dt):
    """Each variant (s = 1 decode, 12 stepwise, 130 chunked), 20 calls on
    the same inputs, S_T written into the middle of a NaN-filled buffer
    and the allocator's free memory NaN-filled before each call: y and
    S_T repeat the first call bit for bit (a race, or a read of memory
    the kernels did not write, would vary), and the buffer around S_T
    stays NaN (no state write out of bounds)."""
    b, h, d = 2, 4, 64
    args = _scan_inputs(kind, b, s, h, d, dt, np.random.default_rng(13))
    fn = ops.rwkv6_scan if kind == "rwkv6" else ops.mamba2_scan
    n = b * h * d * d
    before = ops.variant_counts()
    first = None
    for _ in range(20):
        junk = torch.full((8 * n + 4 * b * s * h * d,), float("nan"),
                          device=card)
        del junk
        buf = torch.full((3 * n,), float("nan"), device=card)
        out = buf[n:2 * n].view(b, h, d, d)
        y, sT = fn(*args, out=out)
        torch.cuda.synchronize()
        assert sT is out
        assert bool(torch.isnan(buf[:n]).all())
        assert bool(torch.isnan(buf[2 * n:]).all())
        assert bool(torch.isfinite(y).all() and torch.isfinite(sT).all())
        if first is None:
            first = (y.clone(), sT.clone())
        assert torch.equal(y, first[0]) and torch.equal(sT, first[1])
    got = {v: ops.variant_counts()[f"{kind}_scan_{v}"]
           - before[f"{kind}_scan_{v}"] for v in ("decode", "chunk")}
    assert got == {"decode": 20 * (s == 1), "chunk": 20 * (s >= 64)}


@pytest.mark.gpu
def test_scan_wrappers_raise_on_card(card):
    r = torch.zeros(1, 2, 2, 16, device=card)
    u, S0 = torch.zeros(2, 16, device=card), torch.zeros(1, 2, 16, 16,
                                                         device=card)
    with pytest.raises(ValueError, match="head size"):
        ops.rwkv6_scan(*(r[..., :8],) * 4, u[:, :8], S0[..., :8, :8])
    strided = r.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous last dim"):
        ops.rwkv6_scan(r, strided, r, r, u, S0)
    with pytest.raises(ValueError, match="devices"):
        ops.rwkv6_scan(r, r, r, r, u.cpu(), S0)
    x = torch.zeros(1, 2, 4, 16, device=card)
    d = torch.zeros(1, 2, 4, device=card)
    Bc = torch.zeros(1, 2, 3, 16, device=card)
    with pytest.raises(ValueError, match="group"):
        ops.mamba2_scan(x, d, d, Bc, Bc, torch.zeros(1, 4, 16, 16,
                                                     device=card))


def _ssm_smoke_cfg(arch):
    cfg = smoke_config(get_config(arch)).replace(compute_dtype="float32")
    if arch == "zamba2-1.2b":    # stages (3, 2): both branches of the rule
        return cfg.replace(n_layers=5, mesh_plan=dataclasses.replace(
            cfg.mesh_plan, pipe=2))
    return cfg.replace(n_layers=4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_ssm_model_on_card_matches_cpu(card, arch, tmp_path):
    """Prefill and three decode steps at the smoke size in fp32: logits
    and every state and KV leaf, the card (scan and flash kernels)
    against the CPU (their plain versions).  Both prefills' logits are
    saved under ``tmp_path``."""
    cfg = _ssm_smoke_cfg(arch)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _on(p_cpu, card)
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launch_counts()
    with torch.inference_mode():
        l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 16)
        l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.to(card)}, 16)
        # kept for a run over many processes (pytest --basetemp): which
        # side's bits move between runs
        np.save(tmp_path / "card_prefill_logits.npy", l_g.cpu().numpy())
        np.save(tmp_path / "cpu_prefill_logits.npy", l_c.numpy())
        _close(l_g, l_c, MODEL_TOL)
        for pos in range(9, 12):
            tok = toks[:, pos - 9:pos - 8]
            d_c, c_c = cpu.decode_step(p_cpu, c_c, tok, pos)
            d_g, c_g = gpu.decode_step(p_gpu, c_g, tok.to(card), pos)
            _close(d_g, d_c, MODEL_TOL)
            for group in c_c:
                for key in c_c[group]:
                    _close(c_g[group][key], c_c[group][key], MODEL_TOL)
    counts = ops.launch_counts()
    scan = "rwkv6_scan" if arch == "rwkv6-7b" else "mamba2_scan"
    assert counts[scan] == cfg.n_layers * 4
    assert counts["flash_fwd"] == (2 * 4 if gpu.hybrid else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_ssm_long_prompt_on_card_matches_cpu(card, arch):
    """A prompt of 130 tokens (two chunks and a tail) and two decode
    steps at the smoke size in fp32: logits and every state and KV leaf,
    the card (chunked scan kernels for the prefill, decode kernels for
    the steps) against the CPU, within ``ssm_model_check``'s 1e-4."""
    cfg = _ssm_smoke_cfg(arch)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _on(p_cpu, card)
    toks = torch.randint(0, cfg.vocab_size, (1, 132),
                         generator=torch.Generator().manual_seed(2))
    ops.reset_launch_counts()
    with torch.inference_mode():
        l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks[:, :130]}, 160)
        l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks[:, :130].to(card)},
                               160)
        _close(l_g, l_c, MODEL_TOL)
        for group in c_c:
            for key in c_c[group]:
                _close(c_g[group][key], c_c[group][key], MODEL_TOL)
        scan = "rwkv6_scan" if arch == "rwkv6-7b" else "mamba2_scan"
        assert ops.variant_counts()[f"{scan}_chunk"] == cfg.n_layers
        for pos in (130, 131):
            tok = toks[:, pos:pos + 1]
            d_c, c_c = cpu.decode_step(p_cpu, c_c, tok, pos)
            d_g, c_g = gpu.decode_step(p_gpu, c_g, tok.to(card), pos)
            _close(d_g, d_c, MODEL_TOL)
            for group in c_c:
                for key in c_c[group]:
                    _close(c_g[group][key], c_c[group][key], MODEL_TOL)
    v = ops.variant_counts()
    assert (v[f"{scan}_chunk"], v[f"{scan}_decode"]) == (cfg.n_layers,
                                                         2 * cfg.n_layers)
    assert ops.launch_counts()[scan] == 3 * cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_ssm_engine_tokens_on_card_match_cpu(card, arch):
    cfg = _ssm_smoke_cfg(arch)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    splan = serve_plan(cfg, n_stages=1, n_slots=1, prompt_budget=8,
                       page_seq=32)
    trace = poisson_trace(8, rate=1.5, seed=0, prompt_lens=(1, 8),
                          vocab=cfg.vocab_size)
    want = SimpleEngine(cpu, p_cpu, splan).run(trace)
    got = SimpleEngine(gpu, _on(p_cpu, card), splan).run(trace)
    assert got == want


# ---------------------------------------------------------------------------
# the paper's evaluation: the simulator and checkpoint/resume on the card


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["sync", "vanilla", "pipedream",
                                    "spectrain"])
def test_simulator_on_card_matches_cpu(card, scheme):
    """10 steps of ``make_mlp_staged`` (4 stages, RMSEs at s = 1, 2, 3)
    and of ``staged_from_model`` (a 4-layer smoke granite on 2 stages,
    fp32 flash kernels) on the card against the CPU: every metric and
    the final parameters within rtol 1e-5 / atol 1e-6, N + 1 fused
    updates a step."""
    from repro_torch.core.simulator import (Simulator, make_mlp_staged,
                                            staged_from_model)
    from repro_torch.models.layers import tree_leaves
    rng = np.random.default_rng(3)
    w_true = rng.standard_normal((16, 8)).astype(np.float32)
    mlp_b = []
    for _ in range(10):
        x = rng.standard_normal((32, 16)).astype(np.float32)
        mlp_b.append({"x": x, "y": (x @ w_true).argmax(-1)})
    cfg = _smoke_cfg().replace(mesh_plan=dataclasses.replace(
        get_config("granite-8b").mesh_plan, pipe=2))
    lm_b = []
    for _ in range(10):
        t = rng.integers(0, cfg.vocab_size, size=(2, 9))
        lm_b.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    p_lm = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))

    def run(dev, kind):
        if kind == "mlp":
            fns, params = make_mlp_staged(
                torch.Generator().manual_seed(0), in_dim=16, width=32,
                depth=4, n_classes=8, n_stages=4, device=dev)
            n, bs, rs = 4, mlp_b, (1, 2, 3)
        else:
            fns, repack = staged_from_model(Model(cfg, device=dev))
            params, n, bs, rs = repack(_on(p_lm, dev)), 2, lm_b, (1,)
        sim = Simulator(fns, params, n_stages=n, scheme=scheme, lr=0.05,
                        rmse_s=rs)
        before = fu.launches
        ms = [sim.step(b) for b in bs]
        return ms, sim.params, fu.launches - before, n

    for kind in ("mlp", "model"):
        m_c, p_c, _, _ = run("cpu", kind)
        m_g, p_g, n_upd, n = run(card, kind)
        assert n_upd == (n + 1) * 10
        for g, c in zip(m_g, m_c):
            assert g.keys() == c.keys()
            for k in c:
                np.testing.assert_allclose(g[k], c[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{kind} {k}")
        for g, c in zip(tree_leaves(p_g), tree_leaves(p_c)):
            np.testing.assert_allclose(g.cpu().numpy(), c.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=kind)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["spectrain", "pipedream"])
def test_resume_on_card_is_bit_exact(card, mode, tmp_path):
    """``train.main`` on the card: 6 steps in one run, and 3 steps then
    ``--resume auto`` to 6, write bit-equal step-5 checkpoints."""
    from repro_torch.launch import train
    from repro_torch.runtime import checkpoint as ckpt
    argv = ["--smoke", "--layers", "4", "--pipe", "2", "--batch", "4",
            "--seq", "16", "--mode", mode, "--save-every", "3",
            "--log-every", "100"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert train.main(argv + ["--steps", "6", "--ckpt-dir", one]) == 0
    assert train.main(argv + ["--steps", "3", "--ckpt-dir", two]) == 0
    assert train.main(argv + ["--steps", "6", "--ckpt-dir", two,
                              "--resume", "auto"]) == 0
    assert ckpt.all_steps(one) == ckpt.all_steps(two) == [2, 5]
    last = os.path.join("step_00000005", "shard_0.npz")
    with np.load(os.path.join(one, last)) as a, \
            np.load(os.path.join(two, last)) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the pipelined engine: the paged decode wave and the engine on the card


def _paged_inputs(seed, R, H, KV, d, dtype, n_pages=8, page_seq=64):
    """R rows at mixed lengths 1, 17 and 64 on distinct pages, the last
    rows (when R > 2) both on the trash page n_pages."""
    q = _randn(seed, R, 1, H, d, dtype=dtype)
    kp = _randn(seed + 1, n_pages + 1, page_seq, KV, d, dtype=dtype)
    vp = _randn(seed + 2, n_pages + 1, page_seq, KV, d, dtype=dtype)
    pages = list(range(1, R + 1))
    if R > 2:
        pages[-2:] = [n_pages, n_pages]
    lens = [(1, 17, 64)[r % 3] for r in range(R)]
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
    return q, kp, vp, i32(pages), i32(lens)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("H,KV,d", [(32, 8, 128), (8, 8, 64)])
def test_paged_kernel_matches_plain(card, dtype, R, H, KV, d):
    q, kp, vp, pages, lens = _paged_inputs(R, R, H, KV, d, dtype)
    before = ops.launch_counts()["flash_fwd"], \
        ops.variant_counts()["flash_fwd_mma"]
    o, lse = fa.flash_fwd_paged(q, kp, vp, pages, lens)
    torch.cuda.synchronize()
    mma = int(dtype == torch.bfloat16)
    assert (ops.launch_counts()["flash_fwd"],
            ops.variant_counts()["flash_fwd_mma"]) == \
        (before[0] + 1, before[1] + mma)
    o_r, lse_r = ref.flash_fwd_paged_ref(q, kp, vp, pages, lens)
    tol = BF16_TOL if mma else F32_TOL
    _close(o, o_r, tol)
    _close(lse, lse_r, F32_TOL if not mma else BF16_TOL)
    # row by row, each against the unpaged kernel on its own page
    for r in range(R):
        p, n = int(pages[r]), int(lens[r])
        o1, _ = fa.flash_fwd(q[r:r + 1], kp[p:p + 1], vp[p:p + 1],
                             causal=False, kv_len=n)
        _close(o[r:r + 1], o1, tol)


@pytest.mark.gpu
def test_paged_kernel_raises_on_card(card):
    q, kp, vp, pages, lens = _paged_inputs(0, 3, 8, 2, 64, torch.bfloat16)
    before = fa.launches
    for bad_pages, bad_lens in ((pages + 8, lens), (pages, lens * 0),
                                (pages, lens + 64)):
        with pytest.raises(ValueError, match="outside"):
            fa.flash_fwd_paged(q, kp, vp, bad_pages, bad_lens)
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_fwd_paged(q, kp, vp, pages.cpu(), lens)
    assert fa.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-8b", "rwkv6-7b"])
def test_pipelined_engine_tokens_on_card_match_cpu(card, arch):
    from repro_torch.planner import verify as pv
    from repro_torch.serve import ServeEngine
    cfg = (_smoke_cfg() if arch == "granite-8b"
           else _ssm_smoke_cfg(arch))
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    splan = serve_plan(cfg, n_stages=2, n_slots=4, max_prefill=2,
                       prompt_budget=8, page_seq=32)
    trace = poisson_trace(10, rate=1.5, seed=0, prompt_lens=(1, 8),
                          vocab=cfg.vocab_size)
    want = ServeEngine(cpu, p_cpu, splan).run(trace)
    assert want == SimpleEngine(cpu, p_cpu, splan).run(trace)
    eng = ServeEngine(gpu, _on(p_cpu, card), splan)
    ops.reset_launch_counts()
    got = eng.run(trace)
    assert got == want
    name = "flash_fwd" if arch == "granite-8b" else "rwkv6_scan"
    assert ops.launch_counts()[name] == cfg.n_layers * (
        eng.n_waves + eng.n_lanes)
    assert pv.verify_request_trace(eng.last_events, n_slots=4, n_pages=4,
                                   n_stages=2).ok


# ---------------------------------------------------------------------------
# the round schedules through the IR interpreter


@pytest.mark.gpu
@pytest.mark.parametrize("schedule,mode,v,backend", [
    ("gpipe", "spectrain", 1, "scan"), ("1f1b", "vanilla", 1, "scan"),
    ("2bw", "spectrain", 1, "scan"), ("2bw", "pipedream", 1, "unrolled"),
    ("interleaved", "spectrain", 2, "scan")])
def test_ir_rounds_on_card_match_cpu(card, schedule, mode, v, backend):
    """Three IR rounds on 2 stages of a 5-layer smoke granite in fp32 (a
    ragged dp split; 4 chunks of the interleaved plan): the card (flash
    forward/backward and fused update kernels) against the CPU (their
    plain versions), at the streaming tick's tolerances: losses to rtol
    1e-5, every state leaf (the 2bw stash too) to rtol 1e-4 / atol 1e-5.
    A round launches 2·L·M flash forwards (each backward recomputes its
    chunk), L·M of each backward kernel and C + 1 fused updates."""
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models.layers import tree_leaves
    from repro_torch.planner import plan
    cfg = _smoke_cfg().replace(n_layers=5, mesh_plan=dataclasses.replace(
        get_config("granite-8b").mesh_plan, pipe=2))
    pplan = plan(cfg, n_stages=2, schedule=schedule, virtual_stages=v,
                 n_microbatches=2, batch=4, seq=16)
    C, M, L = pplan.n_chunks, pplan.round_microbatches, cfg.n_layers
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    out = {}
    ops.reset_launch_counts()
    for model, params in ((cpu, p_cpu), (gpu, _on(p_cpu, card))):
        state = ps.make_ir_state(model, params, plan=pplan, mode=mode)
        step = ps.make_ir_train_step(model, plan=pplan, mode=mode, lr=0.05,
                                     backend=backend)
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        out[model.device.type] = (state, losses)
    n = len(batches)
    assert ops.launch_counts() == {
        "flash_fwd": 2 * L * M * n, "flash_bwd_dq": L * M * n,
        "flash_bwd_dkv": L * M * n, "fused_update": (C + 1) * n,
        "rwkv6_scan": 0, "mamba2_scan": 0}
    (s_c, l_c), (s_g, l_g) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(l_g, l_c, rtol=1e-5)
    keys = ["params", "momentum"] + (["stash"] if "stash" in s_c else [])
    for key in keys:
        for g, c in zip(tree_leaves(s_g[key]), tree_leaves(s_c[key])):
            np.testing.assert_allclose(
                g.float().cpu().numpy(), c.float().numpy(),
                rtol=1e-4, atol=1e-5, err_msg=key)
