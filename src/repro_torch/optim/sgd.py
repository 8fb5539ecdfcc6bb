"""Momentum SGD exactly as the paper uses it (§3.2, Eq. 1), the port's
twin of ``repro/optim/sgd.py``:

  v_t     = γ·v_{t−1} + (1−γ)·g_t
  W_{t+1} = W_t − η·v_t

Momentum lives in fp32 whatever the parameters' dtype.  Unlike the JAX
twin, :func:`update` runs **in place** through the fused update kernel
(``kernels.ops.fused_update``): parameters and momentum are overwritten
and returned, so a training state never holds two copies of either.

ZeRO-1 (the JAX package's default momentum layout over the data axis,
``momentum_rules``): with a data group of N replicas each holds only its
piece of every momentum leaf (:func:`init_shard`: the leaf's flat
elements cut into N contiguous pieces, ``runtime.sharding.shard_range``;
a momentum leaf is then a 1-D fp32 tensor).  :func:`update_groups` is the
runtimes' one update: without ZeRO-1 it averages the whole gradient over
the replicas, clips and updates every leaf; with it each replica
reduce-scatters the gradient (``StageGroup.reduce_scatter_mean``), updates
its piece of w, v and ŵ through the same kernel (one launch a group, the
pieces as views at their offsets) and all-gathers w and ŵ
(``StageGroup.all_gather``), so every replica again holds whole weights,
bit-equal to the replicated update.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import tree_leaves, tree_map


class MomentumState(NamedTuple):
    v: Any                      # smoothed gradient, fp32


def init(params) -> MomentumState:
    return MomentumState(v=tree_map(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params))


def update(params, state: MomentumState, grads, *, lr: float,
           gamma: float = 0.9, s: float = 0.0, pred=None
           ) -> Tuple[Any, MomentumState]:
    """One momentum-SGD step over the whole tree, in place (parameters
    must be fp32).  ``pred`` (or None) receives the prediction
    ``W_{t+1} − s·η·v_t`` in its own dtype: a tree with some or all of
    ``params``' paths, the others getting no prediction.  All leaves
    share ``(lr, gamma, s)``, so this is one kernel launch on the card
    (a tree of more than 64 leaves raises)."""
    whats = None
    if pred is not None:
        whats = []
        tree_map(lambda path, _: whats.append(_at(pred, path)), params)
    ops.fused_update(tree_leaves(params), tree_leaves(state.v),
                     tree_leaves(grads), lr=lr, gamma=gamma, s=s,
                     whats=whats)
    return params, state


# ---------------------------------------------------------------------------
# ZeRO-1: momentum pieces over the data replicas


def init_shard(params, rank: int, world: int):
    """ZeRO-1 momentum: for every leaf of ``params`` a zero 1-D fp32
    tensor of replica ``rank`` of ``world``'s piece
    (``runtime.sharding.shard_range`` of its flat elements)."""
    from repro_torch.runtime.sharding import shard_range

    def one(_, p):
        lo, hi = shard_range(p.numel(), rank, world)
        return torch.zeros(hi - lo, dtype=torch.float32, device=p.device)
    return tree_map(one, params)


def is_shard(params, momentum) -> bool:
    """Whether ``momentum`` holds ZeRO-1 pieces of ``params`` (1-D leaves
    shorter than their parameters) rather than whole leaves."""
    for p, v in zip(tree_leaves(params), tree_leaves(momentum)):
        if tuple(v.shape) != tuple(p.shape):
            return True
    return False


def piece_views(leaves: Sequence[torch.Tensor], rank: int, world: int
                ) -> List[torch.Tensor]:
    """Each leaf's ZeRO-1 piece as a view of its flat elements (the leaf
    must be contiguous)."""
    from repro_torch.runtime.sharding import shard_range
    out = []
    for t in leaves:
        lo, hi = shard_range(t.numel(), rank, world)
        out.append(t.view(-1)[lo:hi])
    return out


def whole_momentum(params, momentum, group):
    """ZeRO-1 momentum pieces gathered whole (every replica gets the
    whole tree, shaped as ``params``; a collective of the data group).
    Returns ``momentum`` itself when it is not sharded."""
    if group is None or group.world == 1 or not is_shard(params, momentum):
        return momentum
    whole = tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    for w, v in zip(piece_views(tree_leaves(whole), group.rank, group.world),
                    tree_leaves(momentum)):
        w.copy_(v)
    group.all_gather(tree_leaves(whole))
    return whole


def own_piece(params, whole_mom, rank: int, world: int):
    """The ZeRO-1 pieces of a whole momentum tree (copies)."""
    it = iter(piece_views([t.contiguous() for t in tree_leaves(whole_mom)],
                          rank, world))
    return tree_map(lambda _, p: next(it).clone(), params)


def update_groups(groups: Sequence[Tuple[Any, Any, Any, float, Any]], *,
                  lr: float, gamma: float = 0.9, clip: Optional[float] = None,
                  data=None, tensor=None, tensor_dims=None
                  ) -> Optional[torch.Tensor]:
    """The runtimes' update: ``groups`` are ``(params, momentum, grads, s,
    pred)`` trees, each one fused update launch (``s`` its prediction
    distance, ``pred`` its ŵ tree or None).  With a data group of N > 1
    replicas the gradients are averaged over them first (widened to fp32,
    exactly): the whole of every leaf by ``all_reduce_mean`` when the
    momentum is whole, or by ZeRO-1 (module docstring) when it holds
    pieces.  ``clip``: global-norm clipping of the averaged gradient
    (under ZeRO-1 the norm sums the pieces' squares over the replicas:
    one scalar all-reduce, in another order than :func:`global_norm`).
    ``tensor`` (a tensor group of T > 1) with ``tensor_dims``
    (``runtime.sharding.tensor_leaf_dims``): the leaves are the rank's
    blocks; the norm sums the squares of the sharded leaves over the
    tensor group and counts each replicated leaf once.  Returns the norm
    when clipping, else None."""
    N = 1 if data is None else data.world
    grads = [g for _, _, g, _, _ in groups]
    if tensor is not None and tensor.world == 1:
        tensor = None
    if N > 1:
        grads = [tree_map(lambda _, g: g if g.dtype == torch.float32
                          else g.float(), t) for t in grads]
    if N > 1 and is_shard(groups[0][0], groups[0][1]):
        return _update_zero1(groups, grads, lr=lr, gamma=gamma, clip=clip,
                             data=data, tensor=tensor, dims=tensor_dims)
    if N > 1:
        data.all_reduce_mean(grads)
    norm = None
    if clip and tensor is None:
        clipped, norm = clip_by_global_norm(list(grads), clip)
        grads = clipped
    elif clip:
        norm = _tensor_norm(grads, tree_leaves(grads), tensor, tensor_dims,
                            None)
        scale = torch.clamp(clip / (norm + 1e-9), max=1.0)
        grads = tree_map(lambda _, g: (g.float() * scale).to(g.dtype),
                         grads)
    for (p, v, _, s, pred), g in zip(groups, grads):
        update(p, MomentumState(v), g, lr=lr, gamma=gamma, s=s, pred=pred)
    return norm


def _tensor_norm(tree, xs, tensor, dims, data) -> torch.Tensor:
    """The global norm of the leaves ``xs`` (``tree``'s leaves, or their
    ZeRO-1 pieces in its order): the squares of the leaves sharded over
    ``tensor`` (named in ``dims``) summed over the tensor group, the
    replicated ones counted once, then, for pieces, summed over the data
    group."""
    names: List[str] = []
    tree_map(lambda path, _: names.append(path[-1] if path else ""), tree)
    dev = xs[0].device
    shard = torch.zeros((), dtype=torch.float32, device=dev)
    rep = torch.zeros((), dtype=torch.float32, device=dev)
    for name, x in zip(names, xs):
        sq = torch.sum(torch.square(x.float()))
        if tensor is not None and name in (dims or {}):
            shard = shard + sq
        else:
            rep = rep + sq
    if tensor is not None:
        shard = tensor.all_reduce_scalar(shard)
    total = shard + rep
    if data is not None:
        total = data.all_reduce_scalar(total)
    return torch.sqrt(total)


def _update_zero1(groups, grads, *, lr, gamma, clip, data, tensor=None,
                  dims=None):
    r, N = data.rank, data.world
    sizes = [len(tree_leaves(g)) for g in grads]
    pieces = data.reduce_scatter_mean([x for g in grads
                                       for x in tree_leaves(g)])
    norm = None
    if clip:
        norm = _tensor_norm(grads, pieces, tensor, dims, data)
        scale = torch.clamp(clip / (norm + 1e-9), max=1.0)
        for x in pieces:
            x.mul_(scale)
    at = 0
    preds: dict = {}
    for (p, v, _, s, pred), n in zip(groups, sizes):
        ws = tree_leaves(p)
        whats = []
        if pred is not None:
            tree_map(lambda path, _: whats.append(_at(pred, path)), p)
        else:
            whats = [None] * len(ws)
        for wh in whats:
            if wh is not None:
                preds.setdefault(wh.dtype, []).append(wh)
        ops.fused_update(
            piece_views(ws, r, N), tree_leaves(v), pieces[at:at + n],
            lr=lr, gamma=gamma, s=s,
            whats=[None if wh is None else piece_views([wh], r, N)[0]
                   for wh in whats])
        at += n
    data.all_gather([w for p, *_ in groups for w in tree_leaves(p)])
    for leaves in preds.values():
        data.all_gather(leaves)
    return norm


def _at(tree, path):
    """The leaf of ``tree`` at ``path``, or None where it has none."""
    for key in path:
        if isinstance(tree, (tuple, list)):
            tree = tree[int(key)]
        elif isinstance(tree, dict) and key in tree:
            tree = tree[key]
        else:
            return None
    return tree


# ---------------------------------------------------------------------------
# clipping


def global_norm(tree) -> torch.Tensor:
    """Global L2 norm over every leaf, in fp32.  (The JAX twin fixes a
    canonical summation order for bitwise layout independence; here the
    order is the leaves', and the tests hold it to a tolerance.)"""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))`` in
    fp32 and cast back to its dtype.  Returns (clipped, norm)."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / (n + 1e-9), max=1.0)
    return tree_map(lambda _, g: (g.float() * scale).to(g.dtype),
                    grads), n

