"""Mixture-of-Experts layer (twin of ``repro/models/moe.py``): top-k
routing, capacity-bounded scatter dispatch, shared experts (DeepSeekMoE)
and the Switch-style load-balance aux loss.

Training (:func:`moe_apply`) dispatches as the JAX twin does, grouped
GShard-style: the T = b·s tokens split into ``DISPATCH_GROUPS`` groups
when T divides by it and each group keeps at least one token per expert
(else one group), each group routing alone with capacity ``min(int(cf ·
Tg · k / E) + 1, Tg)``.  Slots go by a cumulative count over the group's
(token, choice) pairs, token-major then choice; a pair past its
expert's capacity goes to the overflow slot ``cap`` and is dropped.

Serving (:func:`moe_apply_tokens`) routes every token alone, as the JAX
engines do: both step ``decode_step`` one token per call, so the JAX
layer sees T = 1 and capacity 1 and drops nothing.  The port's serving
paths batch tokens (a prompt in one causal call, a decode wave of R
requests in one call), where a shared capacity would drop tokens the JAX
engines never drop; so they dispatch at capacity T, at which no expert
can overflow (a token picks an expert at most once) and each token gets
exactly its own top-k experts' sum.

The layer is four steps, each its own function so that a profile can
time them apart: :func:`route` (router product, softmax, top-k, the aux
loss and each pair's slot), :func:`dispatch` (an ``index_add`` of the
kept tokens into the ``[G, E, cap + 1, d]`` buffer), the expert
products (:func:`expert_ffn`, batched matmuls over the expert axis, the
overflow slot included: it holds zeros and gives zeros), and
:func:`combine` (a gather of each pair's output, weighted by its gate).
The JAX package computes all of it outside any Pallas kernel.

On a data axis (the replicas of a data-parallel run, each forwarding
its block of every microbatch: ``runtime.sharding.replica_rows``),
routing stays the whole microbatch's, as GSPMD keeps it for the JAX
twin: inside :func:`data_axis`, a replica routes its ``G / N`` of the
``G`` groups JAX forms over the whole microbatch (the group count and
the capacity from the whole microbatch's ``T``), and the aux loss's
expert fractions ``ce`` are averaged over the group (one ``[E]`` fp32
``mean_stat`` a layer a forward; they carry no gradient).  ``me``
stays the replica's, so the mean of the replicas' aux losses is JAX's
and the gradients' all-reduce supplies its ``1 / N``.  A split that
does not hold whole groups is refused (:func:`split_groups`).

On a tensor axis (``models.tensor_axis``, the JAX rules' ``expert``
over ``tensor``) a rank holds ``E / T`` routed experts, its columns of
the router and of the shared experts' ``mlp``: the routing is the whole
layer's on every rank, the rank dispatches and combines only its
experts' pairs (:func:`local_routing`) and one all-reduce sums the
routed and shared outputs (:func:`_apply`).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import tensor_axis as tp
from repro_torch.models.layers import ParamSpec

# groups used for local dispatch (the JAX twin aligns them with the data
# axis of its production mesh); 1 when T % groups != 0 or a group would
# hold fewer tokens than there are experts
DISPATCH_GROUPS = 16

# the data group the training routing spans (set by :func:`data_axis`)
_DATA: List = [None]


def moe_specs(cfg):
    mo, d, ff = cfg.moe, cfg.d_model, cfg.d_ff
    E = mo.num_experts
    mats = (("wg", "w1", "w2") if cfg.mlp_gated else ("w1", "w2"))
    specs: Dict = {
        "router": ParamSpec((d, E), ("embed", "expert"), "normal", 0.1),
    }
    for m in mats:
        shp = (E, ff, d) if m == "w2" else (E, d, ff)
        axes = ("expert", "mlp", "embed") if m == "w2" \
            else ("expert", "embed", "mlp")
        specs[m] = ParamSpec(shp, axes)
    if mo.num_shared:
        for m in mats:
            shp = (mo.num_shared, ff, d) if m == "w2" \
                else (mo.num_shared, d, ff)
            axes = (None, "mlp", "embed") if m == "w2" \
                else (None, "embed", "mlp")
            specs["shared_" + m] = ParamSpec(shp, axes)
    return specs


def expert_ffn(cfg, w, h):
    """h: [..., E, C, d] -> the same through each expert's FFN (gated
    SiLU, or tanh-GELU when ``cfg.mlp_gated`` is off)."""
    dt = h.dtype
    if cfg.mlp_gated:
        a = F.silu(torch.einsum("...ecd,edf->...ecf", h, w["wg"].to(dt)))
        z = a * torch.einsum("...ecd,edf->...ecf", h, w["w1"].to(dt))
    else:
        z = F.gelu(torch.einsum("...ecd,edf->...ecf", h, w["w1"].to(dt)),
                   approximate="tanh")
    return torch.einsum("...ecf,efd->...ecd", z, w["w2"].to(dt))


def dispatch_groups(cfg, T: int) -> int:
    """The JAX twin's group count for T tokens."""
    E = cfg.moe.num_experts
    return (DISPATCH_GROUPS if T % DISPATCH_GROUPS == 0
            and T // DISPATCH_GROUPS >= E else 1)


def split_groups(cfg, tokens: int, n: int) -> Optional[int]:
    """The dispatch groups each of ``n`` replicas routes when JAX routes
    a forward of ``tokens`` tokens (the whole microbatch) in
    :func:`dispatch_groups` groups: ``G / n``, or None when the replicas
    cannot hold whole groups (``n`` does not divide ``G``; with ``G`` 1
    one group spans the replicas)."""
    G = dispatch_groups(cfg, tokens)
    return G // n if G % n == 0 and G >= n else None


def min_split_rows(cfg, seq: int, n: int) -> Optional[int]:
    """The fewest microbatch rows of ``seq`` tokens that ``n`` replicas
    split into whole dispatch groups (None when ``n`` divides no group
    count: ``n`` must divide ``DISPATCH_GROUPS``)."""
    if DISPATCH_GROUPS % n:
        return None
    rows = n
    while split_groups(cfg, rows * seq, n) is None:
        rows += n
    return rows


def split_refusal(cfg, rows: int, seq: int, n: int) -> Optional[str]:
    """None when ``n`` replicas split microbatches of ``rows`` x ``seq``
    tokens into whole dispatch groups, else the three-part refusal (the
    combination, why, what runs instead)."""
    if cfg.moe is None or n == 1 or split_groups(cfg, rows * seq, n):
        return None
    G = dispatch_groups(cfg, rows * seq)
    fit = min_split_rows(cfg, seq, n)
    return (f"unsupported combination: --data {n} with {cfg.name}'s routing "
            f"of microbatches of {rows} x {seq} tokens — JAX routes a "
            f"microbatch in {G} dispatch group(s) ({DISPATCH_GROUPS} when "
            f"{DISPATCH_GROUPS} divides its tokens and each group holds at "
            f"least {cfg.moe.num_experts} (the experts), else 1), sharded "
            f"over data, so each replica must hold whole groups and {n} "
            f"must divide {G}; supported alternative: "
            + (f"microbatches of a multiple of {fit} rows at --seq {seq}"
               if fit else f"a --data that divides {DISPATCH_GROUPS}")
            + f", or --data 1")


@contextlib.contextmanager
def data_axis(group):
    """Route every :func:`moe_apply` inside as one replica of ``group``
    (a ``runtime.sharding.StageGroup`` of the data replicas, or None for
    none): its groups of the whole microbatch, the expert fractions
    averaged over the group (see the module docstring)."""
    prev = _DATA[0]
    _DATA[0] = group if group is not None and group.world > 1 else None
    try:
        yield
    finally:
        _DATA[0] = prev


def capacity(cfg, Tg: int) -> int:
    """Slots per expert in a group of Tg tokens."""
    mo = cfg.moe
    return min(int(mo.capacity_factor * Tg * mo.top_k / mo.num_experts) + 1,
               Tg)


class Routing(NamedTuple):
    """One call's routing: per (group, token-major pair) its flat slot in
    the ``[G, n_exp, cap + 1]`` buffer (the overflow slot when dropped),
    its gate times whether it was kept, whether it was kept, its expert,
    the aux loss, the capacity and the buffer's expert count."""
    slot: torch.Tensor          # [G, Tg k] int64
    weight: torch.Tensor        # [G, Tg k] in the compute dtype
    keep: torch.Tensor          # [G, Tg k] bool
    expert: torch.Tensor        # [G, Tg k] int64
    aux: torch.Tensor           # 0-d fp32
    cap: int
    n_exp: int


def route(cfg, p, xg, cap: int, data=None) -> Routing:
    """xg [G, Tg, d]: router logits in fp32, softmax, top-k (renormalised
    among the chosen when the config has shared experts), the aux loss
    over all groups, and each pair's slot at capacity ``cap``.  ``data``:
    the replicas' group, over which the expert fractions ``ce`` are
    averaged (``me`` stays this replica's)."""
    mo = cfg.moe
    E, k = mo.num_experts, mo.top_k
    G, Tg, _ = xg.shape
    logits = (xg @ p["router"].to(xg.dtype)).float()            # [G,Tg,E]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                    # [G,Tg,k]
    if mo.num_shared:  # deepseek: renormalise among the selected
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    me = probs.mean(dim=(0, 1))                                 # [E]
    ce = F.one_hot(idx, E).float().sum(2).mean(dim=(0, 1))
    if data is not None:
        data.mean_stat(ce)
    aux = mo.aux_loss_coef * E * torch.sum(me * ce)

    e_flat = idx.reshape(G, Tg * k)
    onehot = F.one_hot(e_flat, E)                               # [G,Tgk,E]
    pos_in_e = (onehot * (onehot.cumsum(1) - 1)).sum(-1)
    keep = pos_in_e < cap
    dest_c = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap))
    grp = torch.arange(G, device=xg.device)[:, None]
    slot = (grp * E + e_flat) * (cap + 1) + dest_c
    weight = gate.reshape(G, Tg * k).to(xg.dtype) * keep.to(xg.dtype)
    return Routing(slot, weight, keep, e_flat, aux, cap, E)


def local_routing(r: Routing, lo: int, n: int) -> Routing:
    """``r`` restricted to the ``n`` experts from ``lo`` (a tensor rank's):
    a pair of another rank's expert is dropped here (kept nowhere, its
    slot the overflow slot of the group's first local expert, its
    weight zero: it adds zero), a local pair keeps its slot in the
    ``[G, n, cap + 1]`` buffer."""
    mine = (r.expert >= lo) & (r.expert < lo + n)
    G = r.slot.shape[0]
    grp = torch.arange(G, device=r.slot.device)[:, None]
    dest = r.slot % (r.cap + 1)
    slot = torch.where(mine, (grp * n + r.expert - lo) * (r.cap + 1) + dest,
                       grp * n * (r.cap + 1) + r.cap)
    return Routing(slot, r.weight * mine.to(r.weight.dtype), r.keep & mine,
                   r.expert, r.aux, r.cap, n)


def dispatch(cfg, xg, r: Routing):
    """The kept pairs' tokens into their slots: [G, n_exp, cap + 1, d]
    (dropped pairs add zeros to their expert's overflow slot, which so
    stays zero, and the experts map zero to zero: the JAX twin's zero
    row appended after the experts)."""
    G, Tg, d = xg.shape
    k = cfg.moe.top_k
    src = xg.repeat_interleave(k, dim=1)                        # [G,Tgk,d]
    src = torch.where(r.keep[..., None], src, torch.zeros_like(src))
    buf = xg.new_zeros((G * r.n_exp * (r.cap + 1), d))
    buf = buf.index_add(0, r.slot.reshape(-1), src.reshape(-1, d))
    return buf.view(G, r.n_exp, r.cap + 1, d)


def combine(cfg, out_buf, r: Routing, Tg: int):
    """out_buf [G, n_exp, cap + 1, d] (the experts' outputs) -> [G, Tg, d]:
    each token's gate-weighted sum over its kept choices."""
    G, d = out_buf.shape[0], out_buf.shape[-1]
    k = cfg.moe.top_k
    got = out_buf.reshape(-1, d)[r.slot.reshape(-1)].view(G, Tg * k, d)
    return (got * r.weight[..., None]).view(G, Tg, k, d).sum(2)


def _apply(cfg, p, x, G: int, cap: int, data=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer on x [b, s, d] in ``G`` groups at capacity ``cap``.  On
    a tensor axis (``models.tensor_axis``) with the experts sharded, the
    routing is the whole layer's on every rank (the router's columns
    made whole: ``whole_cols``), the rank dispatches only the pairs of
    its ``E / T`` experts (:func:`local_routing`) and runs them and its
    columns of the shared experts; the gates and the tokens entering its
    experts take ``copy_in`` (the router's input does not: the aux loss
    and the routing are whole on every rank, so their cotangent is) and
    the routed and shared outputs are summed by one ``reduce_out``."""
    mo = cfg.moe
    b, s, d = x.shape
    T = b * s
    Tg = T // G
    xg = x.reshape(G, Tg, d)
    n_loc = p["w1"].shape[-3]
    blk = tp.rank_block(mo.num_experts, n_loc)
    router = tp.whole_cols(p["router"].to(x.dtype), mo.num_experts)
    r = route(cfg, {"router": router}, xg, cap, data)
    if blk is not None:
        xg = tp.copy_in(xg)
        r = local_routing(r._replace(weight=tp.copy_in(r.weight)),
                          blk * n_loc, n_loc)
    out = combine(cfg, expert_ffn(cfg, p, dispatch(cfg, xg, r)), r, Tg)
    out = out.reshape(T, d)
    if mo.num_shared:   # their mlp columns a rank wherever experts split
        sh = {m[len("shared_"):]: p[m] for m in p if m.startswith("shared_")}
        hs = xg.reshape(1, T, d).expand(mo.num_shared, T, d)
        out = out + expert_ffn(cfg, sh, hs).sum(0)
    if blk is not None:
        out = tp.reduce_out(out)
    return out.reshape(b, s, d), r.aux


def moe_apply(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b, s, d] -> (out [b, s, d], aux_loss 0-d fp32): the training
    dispatch, grouped and capacity-bounded as the JAX twin's; inside
    :func:`data_axis`, as one replica's block of the whole microbatch
    (raises the three-part ``NotImplementedError`` when the replicas
    cannot hold whole groups)."""
    data = _DATA[0]
    n = 1 if data is None else data.world
    b, s = x.shape[0], x.shape[1]
    T = b * s * n                     # the whole microbatch's tokens
    G = dispatch_groups(cfg, T)
    if split_groups(cfg, T, n) is None:
        raise NotImplementedError(split_refusal(cfg, b * n, s, n))
    return _apply(cfg, p, x, G // n, capacity(cfg, T // G), data)


def moe_apply_tokens(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b, s, d] -> (out, aux): every token routed as if it came
    alone, what the JAX engines' one-token ``decode_step`` gives it (see
    the module docstring): one group at capacity T, so nothing drops.
    The serving callers discard the aux."""
    T = x.shape[0] * x.shape[1]
    return _apply(cfg, p, x, 1, T)
