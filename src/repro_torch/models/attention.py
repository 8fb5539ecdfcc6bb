"""Grouped-query attention, its cross-attention form, and multi-head
latent attention (MLA; twin of ``repro/models/attention.py``).

Every attention call goes through ``kernels.ops.flash_attention``: the
whole-sequence causal call (training and prefill), the single-token
decode step against the KV cache, and cross-attention (an enc-dec
decoder's queries against keys and values projected from the encoder's
output, or read from the decode cache's cross K/V: no rope, no causal
mask, sq and sk apart); the pipelined engine's decode wave
goes through ``kernels.ops.flash_attention_paged``, one call for all
its requests.  The whole-sequence call is the
training path: it writes nothing in place, so autograd runs through it
into the flash backward kernels.  The JAX package picks
between ``_attend`` and its blocked XLA twin by size; here both are the
flash kernel on the card and its plain version on the CPU.  ``_attend``
stays as the plain reference the tests hold the kernel path against.

On a tensor axis (``models.tensor_axis``) both kinds run a rank's
heads: GQA's query heads (and KV heads where ``kv`` shards), MLA's
heads of ``w_uq`` / ``w_ukv`` with the latents, their norms and the
shared rope key computed on every rank; ``wo`` is row-parallel.

MLA (MiniCPM3, DeepSeek-V2) keeps a low-rank latent per position,
``c_kv`` (kv_lora_rank wide) and one shared rope key ``k_rope``, and
expands them into per-head keys and values at attention time.  Its
attention is one flash call on the concatenated query ``[q_nope |
q_rope]`` against ``[k_nope | k_rope]`` (the rope key broadcast over the
heads, KV = H, so G = 1), q.k width nope + rope (96 for MiniCPM3) and v
width ``v_head_dim`` (64): the kernels take the two widths apart.  The
JAX twin's einsum form (``mla_attend_ref``) stays as the plain
reference.  A decode step expands only the latents of positions
``[0, pos]`` where the JAX twin expands the whole cache and masks the
tail: the same result.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import tensor_axis as tp
from repro_torch.models.layers import (ParamSpec, apply_rope, norm_apply,
                                       norm_specs, rope_freqs)

Cache = Dict[str, Any]

NEG_INF = -1e30


def gqa_specs(cfg):
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": ParamSpec((d, H * hd), ("embed", "heads")),
        "wk": ParamSpec((d, KV * hd), ("embed", "kv")),
        "wv": ParamSpec((d, KV * hd), ("embed", "kv")),
        "wo": ParamSpec((H * hd, d), ("heads", "embed")),
    }


def _attend(cfg, q, k, v, *, causal: bool, q_pos, k_len: int,
            k_valid_len=None):
    """q: [b,sq,H,hd] k/v: [b,sk,KV,hd].  q_pos: [sq] absolute positions.
    k_valid_len: optional scalar; keys >= it are masked (decode cache).
    The plain reference: materialises the [sq, sk] scores."""
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    b, sq = q.shape[0], q.shape[1]
    sk = k.shape[1]
    qg = q.reshape(b, sq, KV, G, q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = q_pos[:, None] >= kpos[None, :]
    if k_valid_len is not None:
        mask = mask & (kpos[None, :] < k_valid_len)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, H, q.shape[-1])


def gqa_apply(cfg, p, x, *, pos_offset: int = 0, causal: bool = True,
              cache: Optional[Cache] = None, pos=None, pages=None,
              kv_input=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: [b,s,d].  If ``cache`` holds ``k``/``v`` and s == 1, this is a
    decode step at position ``pos`` (a Python int).  An empty ``cache``
    dict asks for the new keys and values back (prefill).  With
    ``pages`` it is the pipelined engine's decode wave
    (:func:`gqa_decode_wave`).  With ``kv_input`` [b, sk, d] it is
    cross-attention (:func:`cross_attend`).

    The decode step writes the new key and value into ``cache`` in
    place, where the JAX twin returns an updated copy: the cache is one
    layer's slice of the model's KV buffer, and copying it every token
    would move the whole buffer."""
    if pages is not None:
        return gqa_decode_wave(cfg, p, x, cache, pos, pages)
    if kv_input is not None:
        return cross_attend(cfg, p, x, cross_kv(cfg, p, kv_input)), None
    dt = x.dtype
    b, s, _ = x.shape
    hd = cfg.hd
    # the heads this rank holds: all of them, or on a tensor axis its
    # block of query heads (models.tensor_axis) and of KV heads where
    # the rules shard 'kv' too, else every KV head, of which its queries
    # read those of their groups
    H, KV = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    blk = tp.rank_block(cfg.n_heads, H)
    wk, wv = p["wk"], p["wv"]
    if blk is not None:
        x = tp.copy_in(x)
        if KV == cfg.n_kv_heads:
            # replicated K/V projections serve this rank's queries only:
            # their gradient is the sum of the ranks' parts
            wk, wv = tp.copy_in(wk), tp.copy_in(wv)
    q = (x @ p["wq"].to(dt)).view(b, s, H, hd)
    k = (x @ wk.to(dt)).view(b, s, KV, hd)
    v = (x @ wv.to(dt)).view(b, s, KV, hd)
    if blk is not None and KV == cfg.n_kv_heads:
        k, v = _rank_kv(cfg, blk, H, k, v)
        KV = k.shape[2]

    decode = cache is not None and s == 1 and cache.get("k") is not None
    if decode and pos is None:
        raise ValueError("a decode step needs its position")
    q_offset = pos if decode else pos_offset
    if cfg.pos_embed == "rope":
        q_pos = torch.arange(q_offset, q_offset + s, device=x.device)
        inv = rope_freqs(cfg, device=x.device)
        q = apply_rope(q, q_pos[None, :], inv)
        k = apply_rope(k, q_pos[None, :], inv)

    if decode:
        ck, cv = cache["k"], cache["v"]
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        out = ops.flash_attention(q, ck.to(dt), cv.to(dt), False,
                                  q_offset=pos, kv_len=pos + 1)
        return out.reshape(b, s, H * hd) @ p["wo"].to(dt), cache

    new_cache = {"k": k, "v": v} if cache is not None else None
    out = ops.flash_attention(q, k, v, causal, q_offset=q_offset)
    y = out.reshape(b, s, H * hd) @ p["wo"].to(dt)
    return (y if blk is None else tp.reduce_out(y)), new_cache


def _rank_kv(cfg, blk: int, H: int, k, v):
    """The KV heads that tensor rank ``blk``'s ``H`` query heads read,
    of every KV head (a replicated ``kv``): query head h reads KV head
    ``h // G``, G = n_heads / n_kv_heads."""
    G = cfg.n_heads // cfg.n_kv_heads
    if G % H == 0:          # the rank's heads sit in one group
        j = blk * H // G
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    if H % G == 0:          # the rank's heads are whole groups
        j = blk * H // G
        return k[:, :, j:j + H // G], v[:, :, j:j + H // G]
    raise NotImplementedError(
        f"unsupported combination: {cfg.name} on a tensor axis of "
        f"{cfg.n_heads // H} — its {H} query heads a rank split KV groups "
        f"of {G}; supported alternative: a tensor size whose query-head "
        f"block is whole KV groups or lies in one")


def cross_kv(cfg, p, src) -> Cache:
    """Cross-attention's keys and values from the encoder's output src
    [b, sk, d]: ``{"k", "v": [b, sk, KV, hd]}``, no rope (the JAX twin
    ropes neither side when ``kv_input`` is given); what
    ``Model.encdec_prefill_cache`` stores per decoder layer."""
    dt = src.dtype
    b, sk, _ = src.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    return {"k": (src @ p["wk"].to(dt)).view(b, sk, KV, hd),
            "v": (src @ p["wv"].to(dt)).view(b, sk, KV, hd)}


def cross_attend(cfg, p, x, kv: Cache) -> torch.Tensor:
    """Cross-attention of x [b, sq, d] against ``kv`` (:func:`cross_kv`,
    or a layer's cross K/V from the decode cache): no rope and no mask,
    every query sees every key (sq and sk apart), one flash call.  The
    JAX twin's decode step attends over every cached cross key the
    same way (``model.py::_decode_encdec``, no length mask)."""
    dt = x.dtype
    b, s, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"].to(dt)).view(b, s, H, hd)
    out = ops.flash_attention(q, kv["k"].to(dt), kv["v"].to(dt), False)
    return out.reshape(b, s, H * hd) @ p["wo"].to(dt)


def gqa_decode_wave(cfg, p, x, cache: Cache, pos, pages
                    ) -> Tuple[torch.Tensor, Cache]:
    """One layer of the decode wave over R requests: x [R, 1, d]; pos
    and pages int32 [R] on x's device; ``cache`` one layer's paged
    buffer, ``{"k", "v": [n_pages + 1, page_seq, KV, hd]}``.  Row r is
    roped at ``pos[r]``, writes its key and value in place at
    ``(pages[r], pos[r])`` and attends to the first ``pos[r] + 1`` keys
    of its page, all rows in one paged kernel call: what the JAX twin
    computes by vmapping the scalar-position decode step over the
    requests (``repro/serve/engine.py::_decode_chunk``).  The caller
    keeps pages in ``[0, n_pages]`` and pos in ``[0, page_seq)``,
    checked on the host before the upload (``ServeEngine._round`` does,
    once a round), so the kernel call skips its device-side check."""
    dt = x.dtype
    R = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].to(dt)).view(R, 1, H, hd)
    k = (x @ p["wk"].to(dt)).view(R, 1, KV, hd)
    v = (x @ p["wv"].to(dt)).view(R, 1, KV, hd)
    if cfg.pos_embed == "rope":
        inv = rope_freqs(cfg, device=x.device)
        q = apply_rope(q, pos[:, None], inv)
        k = apply_rope(k, pos[:, None], inv)
    ck, cv = cache["k"], cache["v"]
    ck[pages, pos] = k[:, 0].to(ck.dtype)
    cv[pages, pos] = v[:, 0].to(cv.dtype)
    out = ops.flash_attention_paged(q, ck.to(dt), cv.to(dt), pages,
                                    pos + 1, ranges_checked=True)
    return out.reshape(R, 1, H * hd) @ p["wo"].to(dt), cache


def gqa_init_cache(cfg, batch: int, max_seq: int, dtype, device):
    KV, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, max_seq, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_seq, KV, hd), dtype=dtype,
                             device=device)}


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention


def mla_specs(cfg):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ParamSpec((d, m.q_lora_rank), ("embed", None)),
        "q_norm": norm_specs(cfg, "rmsnorm", m.q_lora_rank),
        "w_uq": ParamSpec((m.q_lora_rank, H * qk_hd), (None, "heads")),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", None)),
        "kv_norm": norm_specs(cfg, "rmsnorm", m.kv_lora_rank),
        "w_ukv": ParamSpec((m.kv_lora_rank,
                            H * (m.qk_nope_head_dim + m.v_head_dim)),
                           (None, "heads")),
        "wo": ParamSpec((H * m.v_head_dim, d), ("heads", "embed")),
    }


def _mla_latents(cfg, p, x):
    """The new positions' raw latents: (c_kv [b, s, kv_lora_rank], k_rope
    [b, s, rope]), unnormed and unroped, as the cache stores them."""
    m = cfg.mla
    dkv = x @ p["w_dkv"].to(x.dtype)
    return dkv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)


def _mla_heads(cfg, p):
    """(the heads this rank holds, its tensor block or None): all of
    them, or on a tensor axis its block of ``w_uq``'s heads."""
    m = cfg.mla
    H = p["w_uq"].shape[-1] // (m.qk_nope_head_dim + m.qk_rope_head_dim)
    return H, tp.rank_block(cfg.n_heads, H)


def _mla_q(cfg, p, x, q_pos):
    """q [b, s, H, nope + rope]: the nope dims, then the rope dims roped at
    ``q_pos`` (positions [b or 1, s]); H the rank's heads, the normed
    latent entering them through ``copy_in``."""
    m = cfg.mla
    H, blk = _mla_heads(cfg, p)
    dt = x.dtype
    b, s = x.shape[0], x.shape[1]
    q = norm_apply(cfg, p["q_norm"], x @ p["w_dq"].to(dt), "rmsnorm")
    if blk is not None:
        q = tp.copy_in(q)
    q = (q @ p["w_uq"].to(dt)).view(
        b, s, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    inv = rope_freqs(cfg, m.qk_rope_head_dim, device=x.device)
    return torch.cat([q_nope, apply_rope(q_rope, q_pos, inv)], dim=-1)


def _mla_kv(cfg, p, c_kv, k_rope, k_pos):
    """Expand latents into per-head keys and values: c_kv [b, sk, rank]
    normed and multiplied by ``w_ukv``, the shared k_rope [b, sk, rope]
    roped at ``k_pos`` and broadcast over the heads.  Returns (k [b, sk,
    H, nope + rope] contiguous, v [b, sk, H, v_head_dim], a view); H the
    rank's heads, the normed latent and the rope key entering them
    through ``copy_in``."""
    m = cfg.mla
    H, blk = _mla_heads(cfg, p)
    b, sk = c_kv.shape[0], c_kv.shape[1]
    kv = norm_apply(cfg, p["kv_norm"], c_kv, "rmsnorm")
    if blk is not None:
        kv, k_rope = tp.copy_in(kv), tp.copy_in(k_rope)
    kv = (kv @ p["w_ukv"].to(c_kv.dtype)).view(
        b, sk, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    inv = rope_freqs(cfg, m.qk_rope_head_dim, device=c_kv.device)
    k_rope = apply_rope(k_rope[:, :, None, :], k_pos, inv)
    k = torch.cat([k_nope, k_rope.expand(b, sk, H, m.qk_rope_head_dim)],
                  dim=-1)
    return k, v


def mla_attend_ref(cfg, q, k, v, *, causal: bool, k_valid_len=None):
    """The JAX twin's einsum form (``repro/models/attention.py::
    mla_apply``): scores of the nope and rope dims summed, scaled by
    1/sqrt(nope + rope), fp32 softmax with the -1e30 mask (causal: key
    index <= query index; ``k_valid_len``: keys below it), probabilities
    cast to q's dtype before the value product.  q, k [b, s, H, nope +
    rope]; v [b, sk, H, v_head_dim].  The plain reference the tests hold
    the flash path against."""
    m = cfg.mla
    nope = m.qk_nope_head_dim
    scores = (torch.einsum("bqhd,bshd->bhqs", q[..., :nope], k[..., :nope])
              + torch.einsum("bqhd,bshd->bhqs", q[..., nope:],
                             k[..., nope:]))
    scores = scores.float() / math.sqrt(nope + m.qk_rope_head_dim)
    sq, sk = q.shape[1], k.shape[1]
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    if k_valid_len is not None:
        mask = mask & (kpos[None, :] < k_valid_len)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def mla_apply(cfg, p, x, *, pos_offset: int = 0, causal: bool = True,
              cache: Optional[Cache] = None, pos=None, pages=None,
              wave_len: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: [b, s, d].  Without a cache holding ``c_kv``, the whole sequence
    at positions ``pos_offset + i`` attends to itself (causal: each query
    to the keys up to its own position); an empty ``cache`` dict asks
    for the raw latents back, ``{"c_kv", "k_rope"}`` (prefill).  With a
    cache holding ``c_kv`` and s == 1, a decode step at position ``pos``
    (a Python int): the new latents are written into the cache in place
    and the latents of positions ``[0, pos]`` expanded and attended to.
    With ``pages`` it is the pipelined engine's decode wave
    (:func:`mla_decode_wave`)."""
    if pages is not None:
        return mla_decode_wave(cfg, p, x, cache, pos, pages, wave_len)
    dt = x.dtype
    b, s, _ = x.shape
    H, vhd = cfg.n_heads, cfg.mla.v_head_dim
    c_kv, k_rope = _mla_latents(cfg, p, x)
    if cache is not None and s == 1 and cache.get("c_kv") is not None:
        if pos is None:
            raise ValueError("a decode step needs its position")
        c_all, kr_all = cache["c_kv"], cache["k_rope"]
        c_all[:, pos] = c_kv[:, 0].to(c_all.dtype)
        kr_all[:, pos] = k_rope[:, 0].to(kr_all.dtype)
        n = pos + 1
        q = _mla_q(cfg, p, x, torch.full((1, 1), pos, device=x.device))
        k, v = _mla_kv(cfg, p, c_all[:, :n].to(dt), kr_all[:, :n].to(dt),
                       torch.arange(n, device=x.device)[None])
        out = ops.flash_attention(q, k, v, False, q_offset=pos, kv_len=n)
        return out.reshape(b, s, H * vhd) @ p["wo"].to(dt), cache
    positions = torch.arange(pos_offset, pos_offset + s,
                             device=x.device)[None]
    q = _mla_q(cfg, p, x, positions)
    k, v = _mla_kv(cfg, p, c_kv, k_rope, positions)
    # keys sit at the queries' positions: the causal mask is key index <=
    # query index whatever pos_offset is (the JAX twin's tril)
    out = ops.flash_attention(q, k, v, causal)
    new_cache = ({"c_kv": c_kv, "k_rope": k_rope}
                 if cache is not None else None)
    H, blk = _mla_heads(cfg, p)
    y = out.reshape(b, s, H * vhd) @ p["wo"].to(dt)
    return (y if blk is None else tp.reduce_out(y)), new_cache


def mla_decode_wave(cfg, p, x, cache: Cache, pos, pages,
                    wave_len: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Cache]:
    """One layer of the decode wave over R requests: x [R, 1, d]; pos and
    pages int32 [R] on x's device; ``cache`` one layer's paged latents,
    ``{"c_kv": [n_pages + 1, page_seq, rank], "k_rope": [..., rope]}``.
    Row r writes its latents in place at ``(pages[r], pos[r])``; then the
    rows' pages are gathered up to ``wave_len`` positions (the wave's
    longest row, ``max(pos) + 1``, which the caller knows on the host;
    None: the whole page), expanded, and every row attends to its first
    ``pos[r] + 1`` keys in one paged kernel call on the gathered rows
    (row r on page r).  The caller keeps pages in ``[0, n_pages]`` and
    pos in ``[0, min(wave_len, page_seq))``, checked on the host
    (``ServeEngine._round``)."""
    dt = x.dtype
    R = x.shape[0]
    H, vhd = cfg.n_heads, cfg.mla.v_head_dim
    c_kv, k_rope = _mla_latents(cfg, p, x)
    c_all, kr_all = cache["c_kv"], cache["k_rope"]
    c_all[pages, pos] = c_kv[:, 0].to(c_all.dtype)
    kr_all[pages, pos] = k_rope[:, 0].to(kr_all.dtype)
    n = c_all.shape[1] if wave_len is None else int(wave_len)
    idx = pages.long()
    q = _mla_q(cfg, p, x, pos[:, None])
    k, v = _mla_kv(cfg, p, c_all[idx, :n].to(dt), kr_all[idx, :n].to(dt),
                   torch.arange(n, device=x.device)[None])
    rows = torch.arange(R, dtype=torch.int32, device=x.device)
    out = ops.flash_attention_paged(q, k, v, rows, pos + 1,
                                    ranges_checked=True)
    return out.reshape(R, 1, H * vhd) @ p["wo"].to(dt), cache


def mla_init_cache(cfg, batch: int, max_seq: int, dtype, device):
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# dispatch


def attn_specs(cfg):
    return mla_specs(cfg) if cfg.mla is not None else gqa_specs(cfg)


def attn_apply(cfg, p, x, *, wave_len: Optional[int] = None, **kw):
    """MLA or GQA by the config; ``wave_len`` is read by the MLA decode
    wave only (a GQA wave reads each row's keys in place)."""
    if cfg.mla is not None:
        return mla_apply(cfg, p, x, wave_len=wave_len, **kw)
    return gqa_apply(cfg, p, x, **kw)


def attn_init_cache(cfg, batch: int, max_seq: int, dtype, device):
    if cfg.mla is not None:
        return mla_init_cache(cfg, batch, max_seq, dtype, device)
    return gqa_init_cache(cfg, batch, max_seq, dtype, device)
