"""Grouped-query attention (twin of the GQA path of
``repro/models/attention.py``).

Every attention call goes through ``kernels.ops.flash_attention``: the
whole-sequence causal call (training and prefill) and the single-token
decode step against the KV cache; the pipelined engine's decode wave
goes through ``kernels.ops.flash_attention_paged``, one call for all
its requests.  The whole-sequence call is the
training path: it writes nothing in place, so autograd runs through it
into the flash backward kernels.  The JAX package picks
between ``_attend`` and its blocked XLA twin by size; here both are the
flash kernel on the card and its plain version on the CPU.  ``_attend``
stays as the plain reference the tests hold the kernel path against.

MLA comes in a later slice of the port.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, apply_rope, rope_freqs

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
              cache: Optional[Cache] = None, pos=None, pages=None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: [b,s,d].  If ``cache`` holds ``k``/``v`` and s == 1, this is a
    decode step at position ``pos`` (a Python int).  An empty ``cache``
    dict asks for the new keys and values back (prefill).  With
    ``pages`` it is the pipelined engine's decode wave
    (:func:`gqa_decode_wave`).

    The decode step writes the new key and value into ``cache`` in
    place, where the JAX twin returns an updated copy: the cache is one
    layer's slice of the model's KV buffer, and copying it every token
    would move the whole buffer."""
    if pages is not None:
        return gqa_decode_wave(cfg, p, x, cache, pos, pages)
    dt = x.dtype
    b, s, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"].to(dt)).view(b, s, H, hd)
    k = (x @ p["wk"].to(dt)).view(b, s, KV, hd)
    v = (x @ p["wv"].to(dt)).view(b, s, KV, hd)

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
    return out.reshape(b, s, H * hd) @ p["wo"].to(dt), new_cache


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
