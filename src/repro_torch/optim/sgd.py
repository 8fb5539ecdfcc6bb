"""Momentum SGD exactly as the paper uses it (§3.2, Eq. 1), the port's
twin of ``repro/optim/sgd.py``:

  v_t     = γ·v_{t−1} + (1−γ)·g_t
  W_{t+1} = W_t − η·v_t

Momentum lives in fp32 whatever the parameters' dtype.  Unlike the JAX
twin, :func:`update` runs **in place** through the fused update kernel
(``kernels.ops.fused_update``): parameters and momentum are overwritten
and returned, so a training state never holds two copies of either.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

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

