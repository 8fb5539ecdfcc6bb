"""The algorithm of the bf16 tensor-core flash kernels, emulated on the
CPU and held against the JAX package and the port's plain versions.

``csrc/flash_fwd.cu::flash_fwd_mma_kernel`` and ``csrc/flash_bwd.cu::
flash_bwd_dq_mma_kernel`` and ``flash_bwd_dkv_mma_kernel`` run only on
the card.  This file keeps a PyTorch emulation of what they do, block by
block, so that their arithmetic is tested here:

* rows packed by GQA group, query-major: packed row ``r`` of KV head
  ``kvh`` is query ``r // G`` of head ``kvh * G + r % G``; blocks of 64
  packed rows (16 when all ``sq * G`` rows fit in 16: the one-warp
  block);
* 64-key tiles, zero-filled past ``kv_len``; a causal block stops at key
  ``q_offset + last_row // G``;
* an fp32 online softmax in log2 units, ``exp2`` with ``scale * log2(e)``
  folded in, the -1e30 mask and the ``max(l, 1e-30)`` guard;
* P (forward) and dS (dq) rounded to bf16 before the second product, as
  the kernels reuse the fp32 accumulator fragments as bf16 A operands;
* dk/dv transposed: blocks of 64 keys, 16 per warp, walking the group's
  packed rows in 64-row tiles from the causal start tile (the one that
  holds packed row ``max(0, k0 - q_offset) * G``), each warp in 32-row
  chunks that it skips when their last row cannot see its first key;
  P^T and dS^T rounded to bf16 before dV += P^T dO and dK += dS^T Q, and
  masks applied only on the kernel's edge chunks (the emulation asserts
  that the mask is all true elsewhere).

The emulation's products are fp32 matmuls on the CPU, where the card
sums bf16 products in fp32 in another order.

Tolerances and why:

* 2e-5 (abs and rel) where the emulation runs without the bf16 rounding
  of P or dS on fp32 inputs: the same fp32 arithmetic as the plain
  versions, ``_attend`` and the Pallas kernels in another order (exp2 of
  log2-scaled scores against exp of scaled scores), the port's fp32
  tolerance;
* 2e-2 where P or dS is rounded to bf16 (a relative 2^-9 on each
  probability or dS entry, so up to ~2^-9 max|v| on o; on dk and dv a
  relative 2^-9 on each term of a sum over the group's rows) or where the
  inputs are bf16 (the outputs are bf16 too): the repository's bf16
  kernel tolerance, the one ``chip_smoke.py`` holds the kernels to;
* lse is never rounded: 2e-5 against the fp32 plain version.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as r6
from test_torch_threads import one_thread  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 2e-2
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
BK = 64                 # keys per tile
NEG = -1e30


def _block_rows(n_rows: int) -> int:
    """Packed rows per block: one warp of 16 when they all fit."""
    return 16 if n_rows <= 16 else 64


def _blocks(b, sq, H, KV, q_offset, kv_len, causal):
    """Yield (batch row, KV head, packed rows, their queries, their heads,
    the block's key end) for every block of the kernels' grid."""
    G = H // KV
    n_rows = sq * G
    bm = _block_rows(n_rows)
    for bi in range(b):
        for kvh in range(KV):
            for r0 in range(0, n_rows, bm):
                rows = torch.arange(r0, min(r0 + bm, n_rows))
                k_end = kv_len
                if causal:
                    k_end = min(kv_len, q_offset + int(rows[-1]) // G + 1)
                yield bi, kvh, rows, rows // G, kvh * G + rows % G, k_end


def _tile(x, bi, kvh, k0, kv_len):
    """Keys [k0, k0 + 64) of one KV head, zero past kv_len, fp32."""
    t = torch.zeros(BK, x.shape[-1])
    n = max(0, min(BK, kv_len - k0))
    t[:n] = x[bi, k0:k0 + n, kvh].float()
    return t


def _mask(k0, qpos, kv_len, causal):
    kpos = torch.arange(k0, k0 + BK)
    ok = (kpos < kv_len)[None, :].expand(len(qpos), BK)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    return ok


def emulate_fwd(q, k, v, *, causal, q_offset=0, kv_len=None, round_p=True):
    """flash_fwd_mma_kernel's algorithm: returns (o in q's dtype, lse
    fp32, writes [b, sq, H]: how often each (query, head) was written)."""
    b, sq, H, d = q.shape
    KV, dv = k.shape[2], v.shape[-1]
    kv_len = k.shape[1] if kv_len is None else kv_len
    sl2 = LOG2E / math.sqrt(d)
    o = torch.zeros(b, sq, H, dv)
    lse = torch.zeros(b, H, sq)
    writes = torch.zeros(b, sq, H, dtype=torch.int64)
    for bi, kvh, rows, qi, heads, k_end in _blocks(
            b, sq, H, KV, q_offset, kv_len, causal):
        qp = q[bi, qi, heads].float()
        qpos = q_offset + qi
        m = torch.full((len(rows),), NEG)
        l = torch.zeros(len(rows))
        acc = torch.zeros(len(rows), dv)
        for k0 in range(0, k_end, BK):
            kt, vt = _tile(k, bi, kvh, k0, kv_len), _tile(v, bi, kvh, k0,
                                                          kv_len)
            s = torch.where(_mask(k0, qpos, kv_len, causal),
                            (qp @ kt.T) * sl2, torch.tensor(NEG))
            mx = torch.maximum(m, s.amax(1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[:, None])
            l = l * corr + p.sum(1)
            if round_p:
                p = p.to(torch.bfloat16).float()
            acc = acc * corr[:, None] + p @ vt
            m = mx
        lsum = l.clamp_min(1e-30)
        o[bi, qi, heads] = acc / lsum[:, None]
        lse[bi, heads, qi] = m * LN2 + torch.log(lsum)
        writes[bi, qi, heads] += 1
    return o.to(q.dtype), lse, writes


def emulate_dq(q, k, v, o, lse, do, *, causal, q_offset=0, kv_len=None,
               round_ds=True):
    """flash_bwd_dq_mma_kernel's algorithm: returns (dq in q's dtype,
    writes [b, sq, H])."""
    b, sq, H, d = q.shape
    KV = k.shape[2]
    kv_len = k.shape[1] if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(d)
    dl = ref.flash_dl(o, do)
    dq = torch.zeros(b, sq, H, d)
    writes = torch.zeros(b, sq, H, dtype=torch.int64)
    for bi, kvh, rows, qi, heads, k_end in _blocks(
            b, sq, H, KV, q_offset, kv_len, causal):
        qp, dop = q[bi, qi, heads].float(), do[bi, qi, heads].float()
        lse2 = lse[bi, heads, qi] * LOG2E
        dlr = dl[bi, heads, qi]
        acc = torch.zeros(len(rows), d)
        for k0 in range(0, k_end, BK):
            kt, vt = _tile(k, bi, kvh, k0, kv_len), _tile(v, bi, kvh, k0,
                                                          kv_len)
            p = torch.where(_mask(k0, q_offset + qi, kv_len, causal),
                            torch.exp2((qp @ kt.T) * (scale * LOG2E)
                                       - lse2[:, None]),
                            torch.tensor(0.0))
            ds = p * ((dop @ vt.T) - dlr[:, None]) * scale
            if round_ds:
                ds = ds.to(torch.bfloat16).float()
            acc = acc + ds @ kt
        dq[bi, qi, heads] = acc
        writes[bi, qi, heads] += 1
    return dq.to(q.dtype), writes


# the dk/dv kernel's blocking: keys per block (4 warps of 16), packed
# rows per ring tile, packed rows per S^T / dP^T pass of a warp
DKV_KB = 64
DKV_BM = 64
DKV_RC = 32


def _dkv_start_tile(k0, q_offset, G, causal):
    """The ring tile a dk/dv block starts at: the one holding packed row
    max(0, k0 - q_offset) G, the first to see key k0 when causal."""
    return max(0, k0 - q_offset) * G // DKV_BM if causal else 0


def emulate_dkv(q, k, v, o, lse, do, *, causal, q_offset=0, kv_len=None,
                round_pds=True):
    """flash_bwd_dkv_mma_kernel's algorithm: returns (dk, dv in k's dtype,
    writes [b, sk, KV]: how often each (key, KV head) was written).  The
    outputs start as NaN, so a key that is never written shows."""
    b, sq, H, d = q.shape
    sk, KV, d_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KV
    n_rows = sq * G
    kv_len = sk if kv_len is None else kv_len
    scale = 1.0 / math.sqrt(d)
    dl = ref.flash_dl(o, do)
    dk = torch.full((b, sk, KV, d), float("nan"))
    dv = torch.full((b, sk, KV, d_v), float("nan"))
    writes = torch.zeros(b, sk, KV, dtype=torch.int64)
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_pds else (
        lambda x: x)
    n_row_tiles = -(-n_rows // DKV_BM)
    for bi in range(b):
        for kvh in range(KV):
            rows = torch.arange(n_rows)
            qi, heads = rows // G, kvh * G + rows % G
            qp, dop = q[bi, qi, heads].float(), do[bi, qi, heads].float()
            lse2 = lse[bi, heads, qi] * LOG2E
            dlr = dl[bi, heads, qi]
            for k0 in range(0, sk, DKV_KB):
                t_begin = _dkv_start_tile(k0, q_offset, G, causal)
                n_tiles = max(0, n_row_tiles - t_begin) if k0 < kv_len else 0
                for kw0 in range(k0, k0 + DKV_KB, 16):
                    acc_k, acc_v = torch.zeros(16, d), torch.zeros(16, d_v)
                    kt = torch.zeros(16, d)
                    vt = torch.zeros(16, d_v)
                    n = max(0, min(16, kv_len - kw0))
                    kt[:n] = k[bi, kw0:kw0 + n, kvh].float()
                    vt[:n] = v[bi, kw0:kw0 + n, kvh].float()
                    kpos = torch.arange(kw0, kw0 + 16)
                    for tile in range(t_begin, t_begin + n_tiles):
                        for h0 in range(tile * DKV_BM, (tile + 1) * DKV_BM,
                                        DKV_RC):
                            if h0 >= n_rows:       # no row: skipped
                                continue
                            r = torch.arange(h0, min(h0 + DKV_RC, n_rows))
                            qpos = q_offset + r // G
                            ok = (kpos < kv_len)[:, None].expand(16, len(r))
                            if causal:
                                ok = ok & (kpos[:, None] <= qpos[None, :])
                            if kw0 >= kv_len or (causal and
                                                 int(qpos[-1]) < kw0):
                                # the kernel skips the chunk: nothing in it
                                # is visible
                                assert not bool(ok.any())
                                continue
                            edge = (h0 + DKV_RC > n_rows or
                                    kw0 + 16 > kv_len or
                                    (causal and kw0 + 15 > q_offset + h0 // G))
                            if not edge:
                                assert bool(ok.all())
                            p = torch.where(
                                ok, torch.exp2((kt @ qp[r].T) * (scale * LOG2E)
                                               - lse2[r][None, :]),
                                torch.tensor(0.0))
                            ds = p * ((vt @ dop[r].T) - dlr[r][None, :]) * scale
                            acc_v = acc_v + rnd(p) @ dop[r]
                            acc_k = acc_k + rnd(ds) @ qp[r]
                    keys = slice(kw0, min(kw0 + 16, sk))
                    n_w = keys.stop - keys.start
                    if n_w > 0:
                        dk[bi, keys, kvh] = acc_k[:n_w]
                        dv[bi, keys, kvh] = acc_v[:n_w]
                        writes[bi, keys, kvh] += 1
    return dk.to(k.dtype), dv.to(k.dtype), writes


def emulate_fwd_paged(q, k_pages, v_pages, pages, kv_lens, round_p=True):
    """flash_fwd_mma_kernel on paged rows (the decode wave): the blocks of
    batch row bi read page pages[bi] at length kv_lens[bi] and write row
    bi of o and lse; blocks share nothing, so each row is the unpaged
    algorithm on its own page."""
    outs = [emulate_fwd(q[bi:bi + 1], k_pages[p:p + 1], v_pages[p:p + 1],
                        causal=False, kv_len=n, round_p=round_p)
            for bi, (p, n) in enumerate(zip(pages.tolist(),
                                            kv_lens.tolist()))]
    return tuple(torch.cat(t) for t in zip(*outs))


def _qkv(seed, b, sq, sk, H, KV, d, dv=None):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return mk(b, sq, H, d), mk(b, sk, KV, d), mk(b, sk, KV, dv or d)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# b, sq, sk, H, KV, d, q_offset, kv_len, causal: G in {1, 2, 4, 12, 48},
# sq G below, at and past 16 and 64, kv_len < sk, q_offset > 0; at G 12
# and 48 (starcoder2-15b, granite-20b) a 16- or 64-row block boundary
# falls inside one query's heads
EMU_CASES = [
    (1, 1, 40, 4, 1, 16, 20, 21, False),      # G 4 decode: 4 rows
    (2, 4, 4, 4, 1, 64, 0, 4, True),          # G 4: exactly 16 rows
    (1, 17, 17, 2, 1, 16, 0, 17, True),       # G 2: 34 rows
    (2, 9, 30, 4, 4, 64, 21, 30, True),       # G 1: 9 rows, offset
    (1, 33, 33, 4, 2, 128, 0, 33, True),      # G 2: 66 rows
    (2, 20, 90, 8, 2, 16, 0, 70, False),      # G 4: 80 rows, 2 key tiles
    (1, 16, 100, 4, 1, 64, 80, 96, True),     # G 4: 64 rows, offset 80
    (1, 70, 70, 2, 2, 128, 0, 70, True),      # G 1: 70 rows, 2 key tiles
    (1, 65, 65, 2, 2, 16, 0, 65, True),       # row 64's own key opens a tile
    (1, 1, 64, 48, 1, 16, 63, 64, False),     # G 48 decode: 48 of 64 rows
    (1, 1, 70, 48, 4, 16, 40, 41, False),     # G 12 decode: 12 of 16 rows
    (1, 12, 12, 48, 4, 16, 0, 12, True),      # G 12 prefill: 144 rows
    (2, 3, 75, 48, 1, 16, 70, 73, True),      # G 48: 144 rows, offset 70
    (1, 6, 6, 12, 1, 32, 0, 6, True),         # G 12: 72 rows
]


# the dk/dv kernel's edges (as chip_smoke.py's DKV_EDGES): key block 1
# opens at row tile 1's first row (G 1); G 4 with the first row to see a
# block mid-tile; kv_len mid-block with sk > kv_len (the last block all
# past kv_len); sq 1 with G 8
DKV_EDGE_CASES = [
    (1, 192, 192, 2, 2, 16, 0, 192, True),
    (1, 40, 120, 8, 2, 64, 50, 120, True),
    (2, 70, 160, 4, 2, 16, 0, 100, False),
    (2, 1, 90, 16, 2, 32, 70, 71, True),
]


def _kw(case):
    *_, off, kv_len, causal = case
    return dict(causal=causal, q_offset=off, kv_len=kv_len)


@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_fwd_matches_plain_version(case):
    b, sq, sk, H, KV, d = case[:6]
    q, k, v = _t(*_qkv(0, b, sq, sk, H, KV, d))
    o_r, lse_r = ref.flash_fwd_ref(q, k, v, **_kw(case))
    # the algorithm without P's rounding: the plain version's fp32 sums
    o, lse, writes = emulate_fwd(q, k, v, round_p=False, **_kw(case))
    assert bool((writes == 1).all()), "a (query, head) written != once"
    _close(o, o_r, F32_TOL)
    _close(lse, lse_r, F32_TOL)
    # the kernel's algorithm: P rounded to bf16 before P V
    o, lse, _ = emulate_fwd(q, k, v, **_kw(case))
    _close(o, o_r, BF16_TOL)
    _close(lse, lse_r, F32_TOL)
    # bf16 inputs, as the main paths call it: the port's CPU path on the
    # same bf16 values
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    o, lse, _ = emulate_fwd(qb, kb, vb, **_kw(case))
    o_w, lse_w = fa.flash_fwd(qb, kb, vb, **_kw(case))
    assert o.dtype == torch.bfloat16
    _close(o.float(), o_w.float(), BF16_TOL)
    _close(lse, lse_w, F32_TOL)


@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_fwd_matches_attend(case):
    """Against JAX ``_attend``, which casts the normalised probabilities
    to the compute dtype before the value product: in fp32 that is no
    rounding (2e-5 against the unrounded emulation); in bf16 both round
    the probabilities (2e-2)."""
    b, sq, sk, H, KV, d, off, kv_len, causal = case
    q, k, v = _qkv(1, b, sq, sk, H, KV, d)
    q_pos = jnp.arange(sq) + off
    attend = lambda *a: jattn._attend(None, *a, causal=causal, q_pos=q_pos,
                                      k_len=sk, k_valid_len=kv_len)
    want = np.asarray(attend(*(jnp.asarray(a) for a in (q, k, v))))
    o, _, _ = emulate_fwd(*_t(q, k, v), round_p=False, **_kw(case))
    _close(o, want, F32_TOL)
    want_b = attend(*(jnp.asarray(a).astype(jnp.bfloat16)
                      for a in (q, k, v)))
    o, _, _ = emulate_fwd(*_t(q, k, v, dtype=torch.bfloat16), **_kw(case))
    _close(o.float(), np.asarray(want_b, np.float32), BF16_TOL)


# causal, sq == sk: where the Pallas kernel's head-major folding (row % sq)
# applies.  b, s, H, KV, d, block_q, block_k
PALLAS_CASES = [
    (1, 32, 4, 1, 64, 64, 32),                # G 4: 128 folded rows
    (2, 16, 2, 1, 16, 16, 16),                # G 2: 32 folded rows
    (1, 64, 2, 2, 128, 64, 64),               # G 1
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_emulated_kernels_match_pallas_interpret(case):
    b, s, H, KV, d, bq, bk = case
    q, k, v = _qkv(2, b, s, s, H, KV, d)
    do = np.random.default_rng(3).standard_normal((b, s, H, d),
                                                  dtype=np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    fn = lambda q_, k_, v_: jops.flash_attention(q_, k_, v_, True, bq, bk,
                                                 True)
    o_j, vjp = jax.vjp(fn, jq, jk, jv)
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    _, lse_j = jfa.flash_fwd(jops._fold_gqa(jq, KV), jnp.swapaxes(jk, 1, 2),
                             jnp.swapaxes(jv, 1, 2), causal=True,
                             block_q=bq, block_k=bk, interpret=True)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse, _ = emulate_fwd(tq, tk, tv, causal=True, round_p=False)
    _close(o, np.asarray(o_j), F32_TOL)
    # the Pallas lse is on the folded rows [b, KV, G s]: head-major
    _close(lse, np.asarray(lse_j).reshape(b, H, s), F32_TOL)
    dq, _ = emulate_dq(tq, tk, tv, o, lse, tdo, causal=True,
                       round_ds=False)
    _close(dq, np.asarray(dq_j), F32_TOL)
    dq, _ = emulate_dq(tq, tk, tv, o, lse, tdo, causal=True)
    _close(dq, np.asarray(dq_j), BF16_TOL)
    dk, dv, _ = emulate_dkv(tq, tk, tv, o, lse, tdo, causal=True,
                            round_pds=False)
    _close(dk, np.asarray(dk_j), F32_TOL)
    _close(dv, np.asarray(dv_j), F32_TOL)
    dk, dv, _ = emulate_dkv(tq, tk, tv, o, lse, tdo, causal=True)
    _close(dk, np.asarray(dk_j), BF16_TOL)
    _close(dv, np.asarray(dv_j), BF16_TOL)


@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_dq_matches_plain_version_and_attend_vjp(case):
    b, sq, sk, H, KV, d, off, kv_len, causal = case
    q, k, v = _qkv(4, b, sq, sk, H, KV, d)
    do = np.random.default_rng(5).standard_normal((b, sq, H, d),
                                                  dtype=np.float32)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = ref.flash_fwd_ref(tq, tk, tv, **_kw(case))
    dq_r = ref.flash_bwd_ref(tq, tk, tv, o, lse, tdo, **_kw(case))[0]
    dq, writes = emulate_dq(tq, tk, tv, o, lse, tdo, round_ds=False,
                            **_kw(case))
    assert bool((writes == 1).all()), "a (query, head) written != once"
    _close(dq, dq_r, F32_TOL)
    # against autodiff of JAX _attend (fp32: no probability rounding)
    q_pos = jnp.arange(sq) + off
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn._attend(
        None, q_, k_, v_, causal=causal, q_pos=q_pos, k_len=sk,
        k_valid_len=kv_len), *(jnp.asarray(a) for a in (q, k, v)))
    _close(dq, np.asarray(vjp(jnp.asarray(do))[0]), F32_TOL)
    # the kernel's algorithm: dS rounded to bf16 before dS K
    dq, _ = emulate_dq(tq, tk, tv, o, lse, tdo, **_kw(case))
    _close(dq, dq_r, BF16_TOL)
    # bf16 inputs: against the port's CPU path on the same bf16 values
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (tq, tk, tv, tdo))
    ob, lseb = fa.flash_fwd(qb, kb, vb, **_kw(case))
    dq, _ = emulate_dq(qb, kb, vb, ob, lseb, dob, **_kw(case))
    dq_w = fa.flash_bwd(qb, kb, vb, ob, lseb, dob, **_kw(case))[0]
    assert dq.dtype == torch.bfloat16
    _close(dq.float(), dq_w.float(), BF16_TOL)


@pytest.mark.parametrize("case", EMU_CASES + DKV_EDGE_CASES)
def test_emulated_dkv_matches_plain_version_and_attend_vjp(case):
    b, sq, sk, H, KV, d, off, kv_len, causal = case
    q, k, v = _qkv(7, b, sq, sk, H, KV, d)
    do = np.random.default_rng(8).standard_normal((b, sq, H, d),
                                                  dtype=np.float32)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = ref.flash_fwd_ref(tq, tk, tv, **_kw(case))
    _, dk_r, dv_r = ref.flash_bwd_ref(tq, tk, tv, o, lse, tdo, **_kw(case))
    dk, dv, writes = emulate_dkv(tq, tk, tv, o, lse, tdo, round_pds=False,
                                 **_kw(case))
    assert bool((writes == 1).all()), "a (key, KV head) written != once"
    _close(dk, dk_r, F32_TOL)
    _close(dv, dv_r, F32_TOL)
    # against autodiff of JAX _attend (fp32: no probability rounding)
    q_pos = jnp.arange(sq) + off
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn._attend(
        None, q_, k_, v_, causal=causal, q_pos=q_pos, k_len=sk,
        k_valid_len=kv_len), *(jnp.asarray(a) for a in (q, k, v)))
    _, dk_j, dv_j = vjp(jnp.asarray(do))
    _close(dk, np.asarray(dk_j), F32_TOL)
    _close(dv, np.asarray(dv_j), F32_TOL)
    # the kernel's algorithm: P^T and dS^T rounded to bf16
    dk, dv, _ = emulate_dkv(tq, tk, tv, o, lse, tdo, **_kw(case))
    _close(dk, dk_r, BF16_TOL)
    _close(dv, dv_r, BF16_TOL)
    # bf16 inputs: against the port's CPU path on the same bf16 values
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (tq, tk, tv, tdo))
    ob, lseb = fa.flash_fwd(qb, kb, vb, **_kw(case))
    dk, dv, _ = emulate_dkv(qb, kb, vb, ob, lseb, dob, **_kw(case))
    _, dk_w, dv_w = fa.flash_bwd(qb, kb, vb, ob, lseb, dob, **_kw(case))
    assert dk.dtype == dv.dtype == torch.bfloat16
    _close(dk.float(), dk_w.float(), BF16_TOL)
    _close(dv.float(), dv_w.float(), BF16_TOL)


@pytest.mark.parametrize("case", EMU_CASES + DKV_EDGE_CASES)
def test_emulated_dkv_writes_each_key_once_and_zeros_past_kv_len(case):
    b, sq, sk, H, KV, d, off, kv_len, causal = case
    q, k, v = _t(*_qkv(9, b, sq, sk, H, KV, d))
    do = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (b, sq, H, d), dtype=np.float32))
    o, lse = ref.flash_fwd_ref(q, k, v, **_kw(case))
    dk, dv, writes = emulate_dkv(q, k, v, o, lse, do, **_kw(case))
    assert writes.shape == (b, sk, KV) and bool((writes == 1).all())
    assert bool(torch.isfinite(dk).all()) and bool(torch.isfinite(dv).all())
    assert bool((dk[:, kv_len:] == 0).all())
    assert bool((dv[:, kv_len:] == 0).all())


# multi-head latent attention's split widths (q.k 96, v 64) at G = 1
# (KV = H): b, sq, sk, H, dk, dv, q_offset, kv_len, causal: prefill and
# training (causal), a decode row and a ragged kv_len (not causal), 16-
# and 64-row blocks, two key tiles
SPLIT_CASES = [
    (1, 12, 12, 2, 96, 64, 0, 12, True),      # prefill: 12 of 16 rows
    (2, 70, 70, 2, 96, 64, 0, 70, True),      # 70 rows, 2 key tiles
    (1, 1, 90, 3, 96, 64, 80, 81, False),     # decode: 1 of 16 rows
    (1, 40, 100, 2, 96, 64, 0, 77, False),    # kv_len 77 of 100
]


def _split(case, seed):
    b, sq, sk, H, dk, dv, off, kv_len, causal = case
    q, k, v = _qkv(seed, b, sq, sk, H, H, dk, dv)
    do = np.random.default_rng(seed + 1).standard_normal(
        (b, sq, H, dv), dtype=np.float32)
    return _t(q, k, v, do), dict(causal=causal, q_offset=off,
                                 kv_len=kv_len)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_emulated_kernels_at_split_widths_match_plain_versions(case):
    """Forward, dq and dk/dv at (96, 64): the algorithm without rounding
    at 2e-5, with P, dS, P^T and dS^T rounded to bf16 at 2e-2, each
    output written exactly once, dk and dv at their own widths."""
    (q, k, v, do), kw = _split(case, 11)
    o_r, lse_r = ref.flash_fwd_ref(q, k, v, **kw)
    dq_r, dk_r, dv_r = ref.flash_bwd_ref(q, k, v, o_r, lse_r, do, **kw)
    assert (o_r.shape[-1], dq_r.shape[-1], dk_r.shape[-1],
            dv_r.shape[-1]) == (64, 96, 96, 64)
    o, lse, writes = emulate_fwd(q, k, v, round_p=False, **kw)
    assert bool((writes == 1).all())
    _close(o, o_r, F32_TOL)
    _close(lse, lse_r, F32_TOL)
    o, lse, _ = emulate_fwd(q, k, v, **kw)
    _close(o, o_r, BF16_TOL)
    _close(lse, lse_r, F32_TOL)
    for round_ds, tol in ((False, F32_TOL), (True, BF16_TOL)):
        dq, writes = emulate_dq(q, k, v, o_r, lse_r, do, round_ds=round_ds,
                                **kw)
        assert bool((writes == 1).all())
        _close(dq, dq_r, tol)
        dk, dv, writes = emulate_dkv(q, k, v, o_r, lse_r, do,
                                     round_pds=round_ds, **kw)
        assert bool((writes == 1).all())
        _close(dk, dk_r, tol)
        _close(dv, dv_r, tol)
        assert bool((dk[:, kw["kv_len"]:] == 0).all())
        assert bool((dv[:, kw["kv_len"]:] == 0).all())


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_emulated_split_widths_in_bf16_match_the_cpu_path(case):
    """bf16 inputs at (96, 64), as the training and serving paths call
    the kernels: the emulation against the port's CPU path on the same
    bf16 values."""
    (q, k, v, do), kw = _split(case, 12)
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
    o, lse, _ = emulate_fwd(qb, kb, vb, **kw)
    o_w, lse_w = fa.flash_fwd(qb, kb, vb, **kw)
    assert o.dtype == torch.bfloat16 and o.shape == o_w.shape
    _close(o.float(), o_w.float(), BF16_TOL)
    _close(lse, lse_w, F32_TOL)
    dq_w, dk_w, dv_w = fa.flash_bwd(qb, kb, vb, o_w, lse_w, dob, **kw)
    dq, _ = emulate_dq(qb, kb, vb, o_w, lse_w, dob, **kw)
    dk, dv, _ = emulate_dkv(qb, kb, vb, o_w, lse_w, dob, **kw)
    for got, want in ((dq, dq_w), (dk, dk_w), (dv, dv_w)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _close(got.float(), want.float(), BF16_TOL)


def test_emulated_paged_wave_at_split_widths():
    """The MLA decode wave's call: R = 4 rows at their own lengths on
    identity pages (each row's gathered, expanded keys) at (96, 64)."""
    rng = np.random.default_rng(13)
    lens = [1, 17, 40, 64]
    q = torch.from_numpy(rng.standard_normal((4, 1, 2, 96),
                                             dtype=np.float32))
    kp = torch.from_numpy(rng.standard_normal((4, 64, 2, 96),
                                              dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal((4, 64, 2, 64),
                                              dtype=np.float32))
    pages = torch.arange(4, dtype=torch.int32)
    kv_lens = torch.tensor(lens, dtype=torch.int32)
    o_r, lse_r = ref.flash_fwd_paged_ref(q, kp, vp, pages, kv_lens)
    o, lse, _ = emulate_fwd_paged(q, kp, vp, pages, kv_lens, round_p=False)
    assert o.shape == (4, 1, 2, 64)
    _close(o, o_r, F32_TOL)
    _close(lse, lse_r, F32_TOL)
    o, _, _ = emulate_fwd_paged(q, kp, vp, pages, kv_lens)
    _close(o, o_r, BF16_TOL)


@pytest.mark.parametrize("G", [1, 2, 4, 8, 12, 48])
@pytest.mark.parametrize("q_offset", [0, 5, 37, 130])
def test_dkv_causal_start_tile_covers_every_row_that_sees_the_block(
        G, q_offset):
    """Every packed row that sees a key block's first key lies at or past
    the block's start tile, the start tile holds the first such row, and
    the rows before it see no key of the block."""
    sq = 150
    n_rows = sq * G
    sk = q_offset + sq
    rows = np.arange(n_rows)
    pos = q_offset + rows // G
    for k0 in range(0, sk, DKV_KB):
        r0 = _dkv_start_tile(k0, q_offset, G, True) * DKV_BM
        sees = rows[pos >= k0]
        if len(sees) == 0:
            assert r0 >= n_rows
            continue
        assert sees.min() >= r0
        assert r0 <= sees.min() < r0 + DKV_BM
        assert (pos[:r0] < k0).all()
        assert _dkv_start_tile(k0, q_offset, G, False) == 0


# R, H, KV, d, kv_lens, pages (page 5 is the trash page that idle rows
# share): the decode wave's shapes, lengths across and at the 64-key tile
PAGED_CASES = [
    (1, 4, 1, 16, [1], [0]),
    (3, 48, 1, 16, [64, 1, 30], [0, 5, 2]),   # G 48 (granite-20b)
    (2, 48, 4, 32, [17, 64], [4, 5]),         # G 12 (starcoder2-15b)
    (3, 8, 2, 64, [17, 1, 64], [2, 5, 5]),
    (8, 32, 8, 128, [1, 17, 64, 40, 3, 64, 1, 1], [0, 1, 2, 3, 4, 5, 5, 5]),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_emulated_paged_fwd_matches_plain_version(case):
    R, H, KV, d, lens, pages = case
    rng = np.random.default_rng(R)
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s, dtype=np.float32))
    q, kp, vp = mk(R, 1, H, d), mk(6, 64, KV, d), mk(6, 64, KV, d)
    pages = torch.tensor(pages, dtype=torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32)
    o_r, lse_r = ref.flash_fwd_paged_ref(q, kp, vp, pages, lens)
    o, lse, writes = emulate_fwd_paged(q, kp, vp, pages, lens,
                                       round_p=False)
    assert bool((writes == 1).all())
    _close(o, o_r, F32_TOL)
    _close(lse, lse_r, F32_TOL)
    o, lse, _ = emulate_fwd_paged(q, kp, vp, pages, lens)
    _close(o, o_r, BF16_TOL)
    _close(lse, lse_r, F32_TOL)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, kp, vp))
    o, lse, _ = emulate_fwd_paged(qb, kb, vb, pages, lens)
    o_w, lse_w = fa.flash_fwd_paged(qb, kb, vb, pages, lens)
    _close(o.float(), o_w.float(), BF16_TOL)
    _close(lse, lse_w, F32_TOL)


@pytest.mark.parametrize("sq,H,KV,want", [
    (1, 32, 8, 16),       # granite decode: 4 rows, one warp
    (1, 32, 32, 16),      # zamba2 decode: 1 row
    (4, 32, 8, 16),       # granite prefill n = 4: 16 rows
    (5, 32, 8, 64),       # n = 5: 20 rows, four warps
    (12, 32, 32, 16),     # zamba2 prefill n = 12: 12 rows
    (512, 32, 8, 64),     # training: 2048 rows
    (1, 48, 1, 64),       # granite-20b decode: 48 rows, four warps
    (1, 48, 4, 16),       # starcoder2-15b decode: 12 rows, one warp
    (12, 48, 1, 64),      # granite-20b prefill n = 12: 576 rows
])
def test_block_rows_follow_the_packed_row_count(sq, H, KV, want):
    assert _block_rows(sq * (H // KV)) == want


@pytest.mark.parametrize("case,causal", [((2, 40, 40, 8, 2, 16), True),
                                         ((1, 1, 64, 32, 8, 128), False)])
def test_causal_block_ends_cover_every_visible_key(case, causal):
    """Every key a packed row may see lies below its block's key end, and
    a causal block's end is the position of its last row plus one."""
    b, sq, sk, H, KV, d = case
    G = H // KV
    for _, _, rows, qi, _, k_end in _blocks(b, sq, H, KV, 0, sk, causal):
        assert k_end >= int(qi.max()) + 1 if causal else k_end == sk
        if causal:
            assert k_end == int(rows[-1]) // G + 1


# the wrapper's pieces around the new kernels


def test_alignment_check_on_strides_and_pointers():
    base = torch.zeros(1, 5 * 68 + 8, dtype=torch.bfloat16)
    ok = torch.zeros(2, 5, 4, 16, dtype=torch.bfloat16)
    fa.check_cp_async_alignment(q=ok, k=ok[:, :, :2], v=ok[:, 1:3])
    # rows 68 elements (136 bytes) apart
    bad_seq = base.as_strided((1, 5, 4, 16), (base.stride(0), 68, 16, 1))
    with pytest.raises(ValueError, match="q: sequence stride 68 .136 bytes"):
        fa.check_cp_async_alignment(q=bad_seq)
    bad_head = base.as_strided((1, 2, 3, 16), (base.stride(0), 64, 20, 1))
    with pytest.raises(ValueError, match="k: head stride 20"):
        fa.check_cp_async_alignment(q=ok, k=bad_head)
    bad_batch = base.as_strided((2, 1, 1, 16), (100, 16, 16, 1))
    with pytest.raises(ValueError, match="do: batch stride 100"):
        fa.check_cp_async_alignment(do=bad_batch)
    shifted = base.as_strided((1, 2, 2, 16), (base.stride(0), 32, 16, 1),
                              storage_offset=1)
    with pytest.raises(ValueError, match="v: data pointer"):
        fa.check_cp_async_alignment(v=shifted)
    # a dimension of one entry is never stepped over: its stride is free
    one = base.as_strided((1, 1, 1, 16), (7, 9, 11, 1))
    fa.check_cp_async_alignment(q=one)
    # fp32: 4 elements are 16 bytes
    fa.check_cp_async_alignment(
        q=torch.zeros(2, 3, 4, 4).as_strided((2, 3, 4, 4), (48, 16, 4, 1)))


def test_variant_counters_stay_zero_on_cpu():
    ops.reset_launch_counts()
    q, k, v = _t(*_qkv(6, 1, 5, 5, 4, 2, 16), dtype=torch.bfloat16)
    ins = [t.requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*ins, True)
    o.float().sum().backward()
    assert ops.variant_counts() == {"flash_fwd_mma": 0,
                                    "flash_bwd_dq_mma": 0,
                                    "flash_bwd_dkv_mma": 0,
                                    "rwkv6_scan_decode": 0,
                                    "rwkv6_scan_chunk": 0,
                                    "mamba2_scan_decode": 0,
                                    "mamba2_scan_chunk": 0,
                                    "rwkv6_scan_bwd_chunk": 0,
                                    "mamba2_scan_bwd_chunk": 0}
    assert set(ops.launch_counts()) == {
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_update",
        "rwkv6_scan", "mamba2_scan", "rwkv6_scan_bwd", "mamba2_scan_bwd"}
    assert not any(ops.launch_counts().values())


def test_reset_clears_the_variant_counters():
    fa.launches_mma, fa.launches_dq_mma, fa.launches_dkv_mma = 3, 2, 4
    r6.launches_decode, r6.launches_chunk = 5, 6
    m2.launches_decode, m2.launches_chunk = 7, 8
    r6.launches_bwd_chunk, m2.launches_bwd_chunk = 9, 10
    ops.reset_launch_counts()
    assert ops.variant_counts() == {"flash_fwd_mma": 0,
                                    "flash_bwd_dq_mma": 0,
                                    "flash_bwd_dkv_mma": 0,
                                    "rwkv6_scan_decode": 0,
                                    "rwkv6_scan_chunk": 0,
                                    "mamba2_scan_decode": 0,
                                    "mamba2_scan_chunk": 0,
                                    "rwkv6_scan_bwd_chunk": 0,
                                    "mamba2_scan_bwd_chunk": 0}


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
