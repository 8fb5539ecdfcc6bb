"""Layer primitives + ParamSpec machinery (twin of ``repro/models/layers.py``).

Params are nested dicts (and, for pipeline stages, tuples) of tensors.
Every module declares its parameters as ``ParamSpec``s so that
``init_params`` can draw them from a ``torch.Generator`` with the same
distributions as the JAX package.  The two frameworks draw different
numbers from one seed; tests that compare them carry the JAX weights
over (``models.model.from_jax_params``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import tensor_axis as tp

# ---------------------------------------------------------------------------
# ParamSpec


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"            # normal | zeros | ones | uniform
    scale: float = 1.0              # stddev multiplier (normal) / bound
    dtype: Optional[str] = None     # None -> cfg.param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_map(fn: Callable, tree, *, path: Tuple[str, ...] = ()):
    """Map ``fn(path, leaf)`` over nested dicts / tuples / lists, visiting
    dict keys in sorted order (the order ``jax.tree`` flattens them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], path=path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, path=path + (str(i),))
                          for i, t in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """Leaves in :func:`tree_map`'s order (jax.tree.leaves' order)."""
    out: list = []
    tree_map(lambda _, a: out.append(a), tree)
    return out


def tree_zip_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves_of_rest)`` over trees of one structure."""
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise ValueError("trees differ in keys")
        return {k: tree_zip_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("trees differ in length")
        return type(tree)(tree_zip_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _fan_in(shape: Tuple[int, ...]) -> int:
    return shape[-2] if len(shape) >= 2 else max(1, shape[-1])


# a stacked leaf whose fp32 draw is larger than this is drawn one layer
# at a time, each layer stored before the next is drawn, so that a
# full-size model never holds a whole stack in fp32 (granite-20b's
# stacked w1 is 31.4 GB in fp32)
ROW_DRAW_BYTES = 1 << 30


def _draw(spec: ParamSpec, shape, generator, device) -> torch.Tensor:
    """One draw of ``spec``'s distribution at ``shape``, in fp32."""
    if spec.init == "uniform":
        u = torch.rand(shape, generator=generator, device=device)
        return u.mul_(2 * spec.scale).sub_(spec.scale)
    std = spec.scale / math.sqrt(_fan_in(spec.shape))
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def init_one(spec: ParamSpec, generator: torch.Generator,
             default_dtype: str, device,
             store: Optional[torch.dtype] = None) -> torch.Tensor:
    """One leaf in the param dtype, then in ``store`` if given (the
    serving cast).  A layer-stacked leaf larger than
    :data:`ROW_DRAW_BYTES` in fp32 is drawn layer by layer from the
    same generator, in order."""
    dtype = dtype_of(spec.dtype or default_dtype)
    out_dt = store or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device).to(out_dt)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device).to(out_dt)
    n = math.prod(spec.shape)
    if spec.axes[0] != "layer" or 4 * n <= ROW_DRAW_BYTES:
        return _draw(spec, spec.shape, generator, device).to(dtype).to(out_dt)
    out = torch.empty(spec.shape, dtype=out_dt, device=device)
    for i in range(spec.shape[0]):
        out[i] = _draw(spec, spec.shape[1:], generator, device).to(dtype)
    return out


def init_params(specs, generator: torch.Generator,
                default_dtype: str = "float32", device="cpu",
                leaf_fn: Optional[Callable] = None,
                store: Optional[Callable] = None):
    """Materialise a spec tree, one leaf at a time in flattening order.
    ``store(path)``, if given, names the dtype each leaf is kept in (None:
    the param dtype), cast as it is drawn (the serving cast, so that a
    full-size model never holds all its fp32 draws at once).
    ``leaf_fn(path, tensor)``, if given, is applied to each leaf as soon
    as it is stored."""
    def one(path, spec):
        x = init_one(spec, generator, default_dtype, device,
                     None if store is None else store(path))
        return leaf_fn(path, x) if leaf_fn is not None else x
    return tree_map(one, specs)


def stack_spec(spec: ParamSpec, n: int, axis_name: Optional[str]) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, (axis_name,) + spec.axes,
                     spec.init, spec.scale, spec.dtype)


def stack_specs(specs, n: int, axis_name: Optional[str]):
    return tree_map(lambda _, s: stack_spec(s, n, axis_name), specs)


# ---------------------------------------------------------------------------
# norms


def norm_specs(cfg, kind: Optional[str] = None, dim: Optional[int] = None):
    kind = kind or cfg.norm
    d = dim or cfg.d_model
    specs = {"scale": ParamSpec((d,), ("embed",), "ones")}
    if kind == "layernorm":
        specs["bias"] = ParamSpec((d,), ("embed",), "zeros")
    return specs


def norm_apply(cfg, p, x, kind: Optional[str] = None, eps: float = 1e-5):
    kind = kind or cfg.norm
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def groupnorm_heads(x, scale, bias, n_heads: int, eps: float = 1e-5):
    """GroupNorm over head_dim groups (the RWKV output norm), in fp32.
    x: [..., d]; scale, bias: [d]."""
    orig = x.shape
    xf = x.float().reshape(orig[:-1] + (n_heads, orig[-1] // n_heads))
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(orig)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP


def mlp_specs(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_gated:
        return {
            "wg": ParamSpec((d, ff), ("embed", "mlp")),
            "w1": ParamSpec((d, ff), ("embed", "mlp")),
            "w2": ParamSpec((ff, d), ("mlp", "embed")),
        }
    return {
        "w1": ParamSpec((d, ff), ("embed", "mlp")),
        "w2": ParamSpec((ff, d), ("mlp", "embed")),
    }


def mlp_apply(cfg, p, x):
    """The MLP; on a tensor axis (``models.tensor_axis``) with ``d_ff``
    sharded, ``wg`` / ``w1`` column-parallel and ``w2`` row-parallel."""
    dt = x.dtype
    split = tp.rank_block(cfg.d_ff, p["w1"].shape[-1]) is not None
    if split:
        x = tp.copy_in(x)
    if cfg.mlp_gated:
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["w1"].to(dt))
    else:
        # jax.nn.gelu defaults to the tanh form
        h = F.gelu(x @ p["w1"].to(dt), approximate="tanh")
    y = h @ p["w2"].to(dt)
    return tp.reduce_out(y) if split else y


# ---------------------------------------------------------------------------
# embeddings / unembedding


def embed_specs(cfg):
    V, d = cfg.vocab_padded, cfg.d_model
    specs = {"tok": ParamSpec((V, d), ("vocab", "embed"), "normal", 1.0)}
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, V), ("embed", "vocab"))
    return specs


def embed_apply(cfg, p, tokens):
    """Token embeddings, cast to the compute dtype first, then scaled (as
    the JAX twin does).  With the vocabulary sharded over a tensor axis
    the rank looks up the tokens its rows hold, zeros elsewhere, and the
    ranks' lookups are summed: exact, one term is not zero."""
    cdt = dtype_of(cfg.compute_dtype)
    V = p["tok"].shape[0]
    blk = tp.rank_block(cfg.vocab_padded, V)
    if blk is None:
        emb = p["tok"][tokens].to(cdt)
    else:
        local = tokens - blk * V
        mine = (local >= 0) & (local < V)
        emb = p["tok"][torch.where(mine, local, 0)].to(cdt)
        emb = tp.reduce_out(torch.where(mine[..., None], emb,
                                        torch.zeros((), dtype=cdt,
                                                    device=emb.device)))
    return emb * math.sqrt(cfg.d_model)


def unembed_apply(cfg, p, x):
    """Logits; with the vocabulary sharded over a tensor axis the rank's
    block of them (column-parallel: ``x`` enters through
    ``tensor_axis.copy_in``)."""
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    if tp.rank_block(cfg.vocab_padded, w.shape[-1]) is not None:
        x = tp.copy_in(x)
    logits = x @ w.to(x.dtype)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def sinusoid_at(pos, d: int) -> torch.Tensor:
    """The sinusoidal position encoding in fp32 at the positions ``pos``
    (an integer tensor of any shape) -> [*pos.shape, d]: even dims
    sin(pos / 10000^(i/d)), odd dims the cos of the same angle."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    angle = pos.float()[..., None] / torch.pow(10000.0, dim / d)
    pe = torch.zeros(tuple(pos.shape) + (d,), dtype=torch.float32,
                     device=pos.device)
    pe[..., 0::2] = torch.sin(angle)
    pe[..., 1::2] = torch.cos(angle)
    return pe


def sinusoidal_pos(seq: int, d: int, offset: int = 0,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """[seq, d]: :func:`sinusoid_at` positions ``offset .. offset + seq
    - 1``, cast to ``dtype`` (the JAX twin's table, which its callers add
    after ``embed_apply``'s sqrt(d) scale)."""
    pos = torch.arange(offset, offset + seq, device=device)
    return sinusoid_at(pos, d).to(dtype)


# ---------------------------------------------------------------------------
# losses


def softmax_xent(logits, targets, vocab_size: int, z_loss: float = 0.0,
                 vocab_padded: Optional[int] = None):
    """Mean token cross-entropy in fp32, the logsumexp taken over the
    *padded* vocabulary as the JAX twin takes it (targets are assumed
    < ``vocab_size``).  ``logits`` holding a tensor rank's block of the
    ``vocab_padded`` columns (vocab-parallel): the max and the sum of
    exponentials are reduced over the tensor group, and the gold logit
    comes from the rank whose block holds it."""
    lf = logits.float()
    V = lf.shape[-1]
    blk = None if vocab_padded is None else tp.rank_block(vocab_padded, V)
    if blk is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    else:
        m = tp.reduce_max(lf.amax(dim=-1))
        lse = m + torch.log(tp.reduce_out(
            torch.exp(lf - m[..., None]).sum(dim=-1)))
        local = targets.long() - blk * V
        mine = (local >= 0) & (local < V)
        got = torch.gather(lf, -1, torch.where(mine, local, 0)[..., None])
        gold = tp.reduce_out(torch.where(mine, got[..., 0],
                                         torch.zeros_like(got[..., 0])))
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss.mean()


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(cfg, hd: Optional[int] = None, device=None):
    hd = hd or cfg.hd
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x, positions, inv_freq):
    """x: [..., seq, heads, hd]; positions: [..., seq] (int).  Each head
    splits into halves (not interleaved pairs); the rotation is fp32."""
    ang = positions.float()[..., None] * inv_freq    # [..., s, hd/2]
    sin = torch.sin(ang)[..., None, :]               # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# Leaves the forward reads in fp32 whatever the compute dtype: norm scales
# and biases (``norm_apply``), and the SSM blocks' decay, bonus, norm and
# skip parameters, which ``repro/models/ssm.py`` casts to fp32 where it
# reads them: ``w0`` (:201), ``u`` (:214), ``gn_scale``/``gn_bias``
# (:227, through ``groupnorm_heads``), ``dt_bias`` (:340), ``A_log``
# (:354), ``D`` (:369) and ``norm_scale`` (:377).  Rounding ``w0`` or
# ``A_log`` to bf16 would move every decay of the model.
FP32_LEAVES = frozenset({"scale", "bias", "w0", "u", "gn_scale", "gn_bias",
                         "dt_bias", "A_log", "D", "norm_scale"})


def leaf_is_weight(path: Tuple[str, ...]) -> bool:
    """Whether a parameter leaf is one the forward casts to the compute
    dtype (every leaf but those of :data:`FP32_LEAVES`)."""
    return path[-1] not in FP32_LEAVES

