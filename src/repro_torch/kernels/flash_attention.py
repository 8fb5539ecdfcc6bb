"""Flash attention forward and backward: the wrappers around the Hopper
CUDA kernels.

Twin of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernels
``flash_fwd`` and ``flash_bwd``).  The kernels themselves are
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (dq, and dk/dv); their
source notes say what they compute, what bounds them on an H100 and what
their design leaves for later.  Unlike the Pallas kernels they take the
model-side layout and index the KV head as ``h // G``, and they take a
query position offset and a key count, so one kernel serves causal
prefill and each decode step; and :func:`flash_fwd_paged` gives each
batch row its own key count and its own page of a paged KV buffer, read
from device memory, so one launch serves the pipelined engine's whole
decode wave.

q and k share one width DK (the q.k products) and v has its own, DV (o
and do take v's): the kernels are instantiated for the pairs in
:data:`WIDTH_PAIRS`, the equal widths of the GQA models and multi-head
latent attention's (96, 64).  On the card any other pair raises
``ValueError`` naming it; on the CPU the plain versions take any widths.

Each kernel is chosen by dtype, not as a fallback:

* bf16 (every main path) goes to the tensor-core kernels
  (``flash_fwd_mma_kernel``, ``flash_bwd_dq_mma_kernel``,
  ``flash_bwd_dkv_mma_kernel``: mma.sync on bf16 tiles, rows packed by
  GQA group, a 2-stage cp.async ring), which copy 16-byte pieces, so
  :func:`check_cp_async_alignment` raises on a tensor they cannot copy
  that way;
* fp32 goes to the FMA kernels (``flash_fwd_kernel``,
  ``flash_bwd_dq_kernel``, ``flash_bwd_dkv_kernel``), which keep the fp32
  card-vs-CPU checks at 2e-5; TF32 tensor cores keep about three decimal
  digits.

A bf16 call never reaches an FMA kernel; a failed build, check or launch
raises.

On CUDA tensors :func:`flash_fwd`, :func:`flash_fwd_paged` and
:func:`flash_bwd` launch their kernels or raise; on CPU tensors they
compute :func:`repro_torch.kernels.ref.flash_fwd_ref`,
:func:`repro_torch.kernels.ref.flash_fwd_paged_ref` and
:func:`repro_torch.kernels.ref.flash_bwd_ref`.  On ``meta`` tensors
(shapes only: the dry-run and the cost counter) they run the CUDA
route's checks and allocations and stop short of the launch: nothing
is launched or counted in :data:`launches`.  On ``cuda`` and ``meta``
each call records :func:`cost` with an active
``runtime.op_cost.CostCounter``; any other device raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (flash_bwd_ref, flash_dl, flash_fwd_ref,
                                     flash_fwd_paged_ref)
from repro_torch.runtime.op_cost import active, record_kernel

# the (q.k width, v width) pairs the kernels are instantiated for: equal
# widths, and multi-head latent attention's 64 + 32 rope dims over 64
WIDTH_PAIRS = ((16, 16), (32, 32), (64, 64), (128, 128), (96, 64))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_YZ_MAX = 65535

# kernel launches since the last reset (the CPU path never counts)
launches = 0            # flash_fwd and flash_fwd_paged, either kernel
launches_dq = 0         # flash_bwd_dq, either kernel
launches_dkv = 0        # flash_bwd_dkv, either kernel
launches_mma = 0        # the same on the bf16 tensor-core kernel
launches_dq_mma = 0     # flash_bwd_dq on the bf16 tensor-core kernel
launches_dkv_mma = 0    # flash_bwd_dkv on the bf16 tensor-core kernel

# cp.async copies 16 bytes at a time, from and to 16-byte aligned addresses
CP_ASYNC_BYTES = 16

_c = ctypes.c_int
_ll = ctypes.c_longlong
_p = ctypes.c_void_p
_ARGTYPES = ([_p] * 5 + [_c] * 7 + [_ll] * 9
             + [_c, _c, _c, ctypes.c_float, _p, _p, _p])


_BWD_ARGTYPES = ([_p] * 7 + [_c] * 8 + [_ll] * 12
                 + [_c, _c, _c, ctypes.c_float, _p])


def _lib():
    """(fp32 forward, bf16 forward) of the flash_fwd library."""
    lib = build.library("flash_fwd")
    fns = (lib.repro_flash_fwd, lib.repro_flash_fwd_mma)
    for fn in fns:
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return fns


def _bwd_lib():
    """((fp32 dq, bf16 dq), (fp32 dk/dv, bf16 dk/dv)) of the flash_bwd
    library."""
    lib = build.library("flash_bwd")
    dq = (lib.repro_flash_bwd_dq, lib.repro_flash_bwd_dq_mma)
    dkv = (lib.repro_flash_bwd_dkv, lib.repro_flash_bwd_dkv_mma)
    for fns, argtypes in ((dq, _BWD_ARGTYPES),
                          (dkv, [_p] * 8 + _BWD_ARGTYPES[7:])):
        for fn in fns:
            if fn.argtypes is None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return dq, dkv


def load() -> None:
    """Build (at first use) and load the kernels' libraries."""
    _lib()
    _bwd_lib()


# the kernels' names in the shared-memory queries of the two libraries:
# (library, its kernel argument)
_SMEM_KERNELS = {"fwd": ("flash_fwd", 0), "fwd_mma": ("flash_fwd", 1),
                 "fwd_mma_1warp": ("flash_fwd", 2), "dq": ("flash_bwd", 0),
                 "dkv": ("flash_bwd", 1), "dq_mma": ("flash_bwd", 2),
                 "dkv_mma": ("flash_bwd", 3)}


def smem_bytes(kernel: str, dk: int, dv: int) -> int:
    """Dynamic shared memory of one block of ``kernel`` (a key of
    ``_SMEM_KERNELS``: the fp32 forward, the bf16 forward with 4 warps or
    1, and the fp32 and bf16 dq and dk/dv) at the widths (dk, dv), or -1
    for a pair the kernels are not instantiated for.  Builds the library
    at first use."""
    name, which = _SMEM_KERNELS[kernel]
    fn = getattr(build.library(name), f"repro_{name}_smem_bytes")
    fn.argtypes = [_c, _c, _c]
    fn.restype = ctypes.c_longlong
    return int(fn(which, dk, dv))


def check_widths(dk: int, dv: int) -> None:
    """Raise ``ValueError`` naming the pair unless the kernels are
    instantiated for q.k width ``dk`` and v width ``dv``."""
    if (dk, dv) not in WIDTH_PAIRS:
        raise ValueError(f"head_dim pair (q.k {dk}, v {dv}) has no kernel: "
                         f"the kernels take {WIDTH_PAIRS}")


def pairs(sq: int, kv_len: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs the masks leave, i.e. the work a call needs:
    row i sees keys [0, min(kv_len, q_offset + i + 1)) when causal, all
    ``kv_len`` keys otherwise."""
    if not causal:
        return sq * kv_len
    # the first c rows see q_offset + i + 1 <= kv_len keys, the rest
    # kv_len
    c = min(max(kv_len - q_offset, 0), sq)
    return c * q_offset + c * (c + 1) // 2 + (sq - c) * kv_len


def cost(which: str, b: int, sq: int, H: int, KV: int, d: int, dv: int, *,
         kv_len: int, causal: bool, q_offset: int = 0, el: int = 2
         ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one kernel call, the work the function needs:
    ``which`` is ``"fwd"``, ``"dq"`` or ``"dkv"``; q [b, sq, H, d], k
    and v [b, kv_len (read), KV, d | dv], ``el`` bytes an element (2 for
    bf16, 4 for fp32).  Bytes: every input read once and every output
    written once (fwd: q, k, v in, o and the fp32 lse out; dq and dk/dv:
    q, k, v, do, lse and dl in, dq or dk and dv out).  FLOPs a unmasked
    (query, key) pair and head (:func:`pairs`): fwd 2 (d + dv) (QK^T and
    PV); dq 2 (2d + dv) (S, dP, dS K); dk/dv 4 (d + dv) (S, dP, P^T dO,
    dS^T Q)."""
    w = d + dv
    n = pairs(sq, kv_len, causal, q_offset)
    rows, keys = b * sq * H, b * kv_len * KV
    if which == "fwd":
        nbytes = el * (rows * w + keys * w) + 4 * b * H * sq
        return 2 * b * H * w * n, nbytes
    nbytes = el * (rows + keys) * w + 8 * b * H * sq
    if which == "dq":
        return 2 * (2 * d + dv) * b * H * n, nbytes + el * rows * d
    if which == "dkv":
        return 4 * w * b * H * n, nbytes + el * keys * w
    raise ValueError(f"unknown flash kernel {which!r}")


def paged_cost(H: int, KV: int, d: int, dv: int, lens, pages, *,
               el: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) of one paged call (:func:`flash_fwd_paged`): q,
    each page's keys and values up to the longest length a row reads
    there (a page that rows share read once), o and lse; QK^T and PV
    over the rows' lengths."""
    keys: dict = {}
    for p, n in zip(pages, lens):
        keys[p] = max(keys.get(p, 0), n)
    w = d + dv
    R = len(lens)
    nbytes = el * (R * H * w + sum(keys.values()) * KV * w) + 4 * R * H
    return 2 * H * w * sum(lens), nbytes


def _check(q, k, v, q_offset: int, kv_len: int, *,
           paged: bool = False) -> None:
    """Shapes, dtypes and devices of a flash call; with ``paged`` k and v
    are a page buffer, whose page count need not equal q's batch.  The
    width pair is checked on the card only (:func:`check_widths`)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be 4-D [b, s, heads, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)} "
                         f"but for the width")
    b, sq, H, d = q.shape
    bk, sk, KV, dk = k.shape
    if (bk != b and not paged) or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head_dim")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if q.device.type == "cuda":
        check_widths(d, v.shape[-1])
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{tuple(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if b < 1 or sq < 1:
        raise ValueError(f"empty query {tuple(q.shape)}")
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len={kv_len} outside [1, {sk}]")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset} < 0")


def check_cp_async_alignment(**tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless each named [b, s, heads, d] tensor can
    be copied by the kernels' 16-byte cp.async: its data pointer and
    its batch, sequence and head strides (where that dimension has more
    than one entry) must be multiples of 16 bytes.  A pure check of
    pointers and strides: it runs on tensors on any device."""
    for name, t in tensors.items():
        if t.data_ptr() % CP_ASYNC_BYTES:
            raise ValueError(
                f"{name}: data pointer {t.data_ptr():#x} is not a multiple "
                f"of {CP_ASYNC_BYTES} bytes, which the kernels' 16-byte "
                f"cp.async copies need")
        for dim, what in enumerate(("batch", "sequence", "head")):
            nbytes = t.stride(dim) * t.element_size()
            if t.shape[dim] > 1 and nbytes % CP_ASYNC_BYTES:
                raise ValueError(
                    f"{name}: {what} stride {t.stride(dim)} ({nbytes} "
                    f"bytes) is not a multiple of {CP_ASYNC_BYTES} bytes, "
                    f"which the kernels' 16-byte cp.async copies need")


def _check_device(name: str, t: torch.Tensor) -> None:
    """The kernels run on ``cuda``; ``meta`` (shapes only) takes the
    same route up to the launch; every other device but the CPU (whose
    plain versions the callers run) raises."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on cuda, meta or cpu, not "
                         f"{t.device}")


def flash_fwd(q, k, v, *, causal: bool, q_offset: int = 0,
              kv_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [b, sq, H, dk]; k: [b, sk, KV, dk]; v: [b, sk, KV, dv] -> (o
    [b, sq, H, dv] in q's dtype, lse [b, H, sq] fp32), scale 1/sqrt(dk).
    See ``flash_fwd_ref`` for the masks."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    _check(q, k, v, q_offset, kv_len)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len)
    _check_device("flash_fwd", q)
    o, lse = _launch_fwd(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)
    b, sq, H, d = q.shape
    record_kernel("flash_fwd", cost, "fwd", b, sq, H, k.shape[2], d,
                  v.shape[-1], kv_len=kv_len, causal=causal,
                  q_offset=q_offset, el=q.element_size())
    return o, lse


def flash_fwd_paged(q, k_pages, v_pages, pages, kv_lens, *,
                    ranges_checked: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode wave's attention: q [R, 1, H, dk]; k_pages, v_pages
    [n_pages + 1, page_seq, KV, dk | dv], one layer's paged KV buffer;
    pages and kv_lens int32 [R] on q's device.  Row r attends, without a
    causal mask, to the first ``kv_lens[r]`` keys of page ``pages[r]``.
    Rows may share a page.  Returns (o [R, 1, H, dv] in q's dtype, lse
    [R, H, 1] fp32).  One kernel launch for all R rows, counted under
    ``flash_fwd``; forward only.  Raises unless every page lies in
    ``[0, n_pages]`` and every length in ``[1, page_seq]``: a check that
    reads both tensors to the host, and so waits for the card.  A caller
    that has checked the ranges on the host before the upload (the serve
    engine, once a round) passes ``ranges_checked=True`` to skip it."""
    _check(q, k_pages, v_pages, 0, k_pages.shape[1], paged=True)
    R, n_buf = q.shape[0], k_pages.shape[0]
    for name, t in (("pages", pages), ("kv_lens", kv_lens)):
        if t.dtype != torch.int32 or t.shape != (R,):
            raise ValueError(f"{name} must be int32 [{R}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.shape[1] != 1:
        raise ValueError(f"a paged call takes one query a row, got "
                         f"{tuple(q.shape)}")
    bad = None if ranges_checked else (
        (pages < 0) | (pages >= n_buf) | (kv_lens < 1)
        | (kv_lens > k_pages.shape[1]))
    if bad is not None and bool(bad.any()):
        raise ValueError(f"pages outside [0, {n_buf - 1}] or kv_lens "
                         f"outside [1, {k_pages.shape[1]}]: pages "
                         f"{pages.tolist()}, kv_lens {kv_lens.tolist()}")
    if q.device.type == "cpu":
        return flash_fwd_paged_ref(q, k_pages, v_pages, pages, kv_lens)
    _check_device("flash_fwd_paged", q)
    pages, kv_lens = pages.contiguous(), kv_lens.contiguous()
    out = _launch_fwd(q, k_pages, v_pages, causal=False, q_offset=0,
                      kv_len=k_pages.shape[1], kv_lens=kv_lens,
                      pages=pages)
    if active() is not None:
        # the work depends on the rows' lengths: read them (a sync) on
        # the card; on meta, where they have no values, count every row
        # at the full page on a page of its own
        lens, pgs = ((kv_lens.tolist(), pages.tolist())
                     if q.device.type == "cuda" else
                     ([k_pages.shape[1]] * R, list(range(R))))
        record_kernel("flash_fwd", paged_cost, q.shape[2],
                      k_pages.shape[2], q.shape[-1], v_pages.shape[-1],
                      lens, pgs, el=q.element_size())
    return out


def _launch_fwd(q, k, v, *, causal: bool, q_offset: int, kv_len: int,
                kv_lens=None, pages=None):
    """Launches the forward kernel of q's dtype once and counts it (on
    meta: allocates its outputs and launches nothing); the arguments are
    checked by the callers."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"non-negative strides, got {t.stride()}")
    b, sq, H, d = q.shape
    KV, dv = k.shape[2], v.shape[-1]
    if b > _GRID_YZ_MAX or H > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} or heads {H} exceed the launch grid")
    mma = q.dtype == torch.bfloat16
    if mma:
        check_cp_async_alignment(q=q, k=k, v=v)
    o = torch.empty((b, sq, H, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, H, sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return o, lse
    fn = _lib()[mma]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _DTYPES[q.dtype], d, dv, b, sq, H, KV,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(bool(causal)), q_offset, kv_len,
                 1.0 / math.sqrt(d),
                 None if kv_lens is None else kv_lens.data_ptr(),
                 None if pages is None else pages.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    global launches, launches_mma
    launches += 1
    launches_mma += mma
    return o, lse


def flash_bwd(q, k, v, o, lse, do, *, causal: bool, q_offset: int = 0,
              kv_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_fwd`: q [b, sq, H, dk], o and do [b, sq,
    H, dv]; k [b, sk, KV, dk], v [b, sk, KV, dv]; lse [b, H, sq] fp32 from
    the forward -> (dq in q's dtype, dk and dv in k's dtype).  Two
    kernels: dq, then dk/dv.  See
    ``flash_bwd_ref`` for the formulas; dk and dv are exact zeros for keys
    at positions >= ``kv_len``."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    _check(q, k, v, q_offset, kv_len)
    b, sq, H, d = q.shape
    o_shape = (b, sq, H, v.shape[-1])
    if o.shape != o_shape or do.shape != o_shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must be {o_shape}: q's rows at v's width")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"o and do must be {q.dtype}, got {o.dtype}, "
                        f"{do.dtype}")
    if lse.shape != (b, H, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(b, H, sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not (q.device == o.device == do.device == lse.device):
        raise ValueError("q, o, do and lse on different devices")
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, lse, do, causal=causal,
                             q_offset=q_offset, kv_len=kv_len)
    _check_device("flash_bwd", q)
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.stride(-1) != 1 or min(t.stride()) < 0:
            raise ValueError(f"{name} needs a contiguous last dim and "
                             f"non-negative strides, got {t.stride()}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    if b > _GRID_YZ_MAX or H > _GRID_YZ_MAX:
        raise ValueError(f"batch {b} or heads {H} exceed the launch grid")
    mma = q.dtype == torch.bfloat16
    if mma:
        check_cp_async_alignment(q=q, k=k, v=v, do=do)
    launch_dq, launch_dkv, (dq, dk, dv) = _bwd_launchers(
        q, k, v, o, lse, do, causal=causal, q_offset=q_offset,
        kv_len=kv_len)
    if q.device.type == "cuda":
        global launches_dq, launches_dkv, launches_dq_mma, launches_dkv_mma
        launch_dq()
        launches_dq += 1
        launches_dq_mma += mma
        launch_dkv()
        launches_dkv += 1
        launches_dkv_mma += mma
    for which in ("dq", "dkv"):
        record_kernel(f"flash_bwd_{which}", cost, which, b, sq, H,
                      k.shape[2], d, v.shape[-1], kv_len=kv_len,
                      causal=causal, q_offset=q_offset,
                      el=q.element_size())
    return dq, dk, dv


def _bwd_launchers(q, k, v, o, lse, do, *, causal: bool, q_offset: int,
                   kv_len: int):
    """Computes dl and allocates dq, dk, dv; returns (launch_dq,
    launch_dkv, (dq, dk, dv)), each launcher starting its kernel once on
    the current stream (or raising on a CUDA error) without counting;
    each is the tensor-core kernel for bf16 and the FMA kernel for fp32.
    :func:`flash_bwd` checks and counts; ``chip_smoke.py`` times each
    alone."""
    b, sq, H, d = q.shape
    sk, KV, d_v = k.shape[1], k.shape[2], v.shape[-1]
    dl = flash_dl(o, do)
    dq = torch.empty((b, sq, H, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, KV, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, KV, d_v), dtype=k.dtype, device=q.device)
    mma = q.dtype == torch.bfloat16
    tail = (_DTYPES[q.dtype], d, d_v, b, sq, sk, H, KV, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            int(bool(causal)), q_offset, kv_len, 1.0 / math.sqrt(d))
    ins = (q, k, v, do, lse, dl)     # the closures keep them alive

    def run(name, which, outs):
        fn = _bwd_lib()[which][mma]
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(*(t.data_ptr() for t in ins + outs), *tail, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")

    return (lambda: run("flash_bwd_dq", 0, (dq,)),
            lambda: run("flash_bwd_dkv", 1, (dk, dv)),
            (dq, dk, dv))
