"""The tensor axis inside the decoders' layers: Megatron-style tensor
parallelism, the port's form of what GSPMD computes when the JAX
package's rules (``runtime/sharding.py::logical_rules``) put ``heads``,
``kv``, ``mlp``, ``vocab``, ``expert`` and ``ssm`` over ``tensor``.

A rank of a tensor group of T holds its block of every leaf the rules
shard (``runtime.sharding.tensor_dims``): query heads ``H / T`` (and key
and value heads ``KV / T`` where ``kv`` shards, else every KV head), the
MLP's ``d_ff / T`` columns of ``wg`` / ``w1`` and rows of ``w2``, and
``V / T`` rows of the embedding (columns of the unembedding).  The
layers read their local widths off the weights' shapes, so the same code
runs whole or sharded; inside :func:`tensor_axis` they insert the two
conjugate operators, as ``torch.autograd.Function``s, so the runtimes'
stage recomputes and ``autograd.grad`` run through them unchanged:

* :func:`copy_in` (Megatron's *f*): identity forward, the cotangent
  summed over the group backward; before a column-parallel product
  (and on a replicated ``wk`` / ``wv`` that serves only the rank's query
  heads, whose gradient is the sum of the ranks' parts);
* :func:`reduce_out` (*g*): the sum over the group forward
  (``StageGroup.all_reduce_sum``), identity backward; after a
  row-parallel product, the vocab-parallel embedding's lookup and the
  loss's sums.

The same two place the other families' splits (the rule: *f* sits
exactly where a replicated activation enters the rank's share of heads
or experts, never on a tensor that also feeds replicated compute, whose
cotangent is whole on every rank already): the MoE layer's experts
(``models.moe``: the routing replicated from the router made whole by
:func:`whole_cols`, *f* on the gates and on the tokens entering the
rank's experts and the shared experts' columns, one *g* of their sum),
rwkv6's and mamba2's heads (``models.ssm``: *f* on the mixes and the
decay entering the rank's heads; mamba2's gated norm's sum of squares
through *g* then *f*) and MLA's heads (``models.attention``: *f* on the
normed latents and the shared rope key).

Outside :func:`tensor_axis` (or with T = 1) both are the identity and
the layers are the one-process model.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F

# the tensor group the layers span (set by :func:`tensor_axis`)
_TENSOR: List = [None]


@contextlib.contextmanager
def tensor_axis(group):
    """Run the layers inside as one rank of ``group`` (a
    ``runtime.sharding.StageGroup`` of the tensor axis, or None)."""
    prev = _TENSOR[0]
    _TENSOR[0] = group if group is not None and group.world > 1 else None
    try:
        yield
    finally:
        _TENSOR[0] = prev


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum(g), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """*f*: ``x`` forward; its cotangent summed over the tensor group
    backward (the identity without a group)."""
    group = _TENSOR[0]
    return x if group is None else _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """*g*: ``x`` summed over the tensor group forward, the cotangent
    passed through backward (the identity without a group)."""
    group = _TENSOR[0]
    return x if group is None else _ReduceOut.apply(x, group)


def reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the tensor group, no gradient
    (the loss's logsumexp shift)."""
    group = _TENSOR[0]
    if group is None:
        return x.detach()
    return group.all_reduce_max(x.detach())


def whole_cols(w: torch.Tensor, whole: int) -> torch.Tensor:
    """A weight sharded on its last dim made whole on every rank: the
    rank's block at its offset in zeros, summed over the group (exact:
    one term of each sum is not zero); backward, the block's columns of
    the cotangent, which must be whole on every rank (the MoE router's,
    whose logits feed the replicated routing).  ``w`` itself where it
    is whole."""
    blk = rank_block(whole, w.shape[-1])
    if blk is None:
        return w
    n = w.shape[-1]
    return reduce_out(F.pad(w, (blk * n, whole - (blk + 1) * n)))


def rank_block(whole: int, local: int) -> Optional[int]:
    """This rank's block index along a dim of ``whole`` elements held as
    ``local``: None when the dim is whole here (no group, or the rules
    left it replicated), else the tensor rank."""
    group = _TENSOR[0]
    if group is None or local == whole:
        return None
    if local * group.world != whole:
        raise ValueError(f"a dim of {whole} held as {local} on a tensor "
                         f"group of {group.world}")
    return group.rank
