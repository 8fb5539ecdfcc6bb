"""Synchronous circular pipeline (GPipe semantics) — the staleness-free
baseline, twin of ``repro/core/pipeline_sync.py``.

Stage weights are the ragged per-stage trees; microbatches rotate
through the stages tick by tick in a Python loop (the JAX twin's
``lax.scan``), and autograd through that loop produces the reverse
pipeline.  The weight update is one synchronous momentum-SGD step per
global batch, in place through the fused update kernel — the semantics
of data parallelism, which is why it is the staleness-free reference.

Given a data group (``runtime.sharding.StageGroup`` of the data-parallel
replicas), the step is one replica's: it runs on the replica's rows
(``runtime.sharding.replica_rows`` of the global batch: its block of
every microbatch, or of the whole batch at one stage), averages the gradients over the replicas
(``all_reduce_mean``) and then updates, so every replica runs the same
update on the same bits; with ZeRO-1 momentum (the default of
:func:`init_state` with ``data=``) it reduce-scatters the gradient,
updates its pieces and all-gathers the weights
(``optim.sgd.update_groups``).  An MoE layer routes as one replica of the
whole microbatch (``models.moe.data_axis``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.pipeline_stream import (_grads, _leaves_like,
                                              device_batch)
from repro_torch.models import moe, tensor_axis
from repro_torch.optim import sgd


def pipeline_loss(model, params, batch, num_microbatches: int):
    """Forward loss through the circular pipeline."""
    loss, aux = _loss_and_aux(model, params, batch, num_microbatches)
    return loss


def _loss_and_aux(model, params, batch, num_microbatches: int):
    """(the loss, the aux loss it includes): the head loss plus the
    stages' aux losses, their mean over the microbatches."""
    S = model.n_stages
    if S == 1:
        return model.loss_and_aux(params, batch)
    M = num_microbatches
    outer, stages = params["outer"], params["stages"]
    if not isinstance(stages, (tuple, list)):
        raise NotImplementedError(
            "stacked stage params are not ported to PyTorch; pass the "
            "ragged per-stage tuple")

    x = model.embed(outer, batch)                    # [B, s, d]
    B = x.shape[0]
    if B % M:
        raise ValueError(f"global batch {B} not divisible by "
                         f"num_microbatches={M}")
    mb = B // M
    xs = x.reshape((M, mb) + tuple(x.shape[1:]))
    T = M + S - 1
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    prev = [torch.zeros_like(xs[0]) for _ in range(S)]
    aux_sum = zero
    ys = []
    for t in range(T):
        ins = [xs[min(t, M - 1)]] + prev[:-1]
        outs = [model.stage_apply(stages[k], (ins[k], zero))
                for k in range(S)]
        for k, (_, aux) in enumerate(outs):
            if 0 <= t - k < M:
                aux_sum = aux_sum + aux
        prev = [o for o, _ in outs]
        ys.append(prev[-1])
    # drained outputs: ticks S-1 .. T-1 hold microbatches 0..M-1
    outs = torch.stack(ys[S - 1:]).reshape((B,) + tuple(x.shape[1:]))
    loss = model.head_loss(outer, outs, batch["targets"])
    return loss + aux_sum / M, aux_sum / M


def make_train_step(model, *, lr: float, gamma: float = 0.9,
                    num_microbatches: Optional[int] = None,
                    clip: Optional[float] = None, group=None,
                    tensor=None) -> Callable:
    """Synchronous pipelined train step (params+momentum in state),
    updating the state in place.  ``group``: the data group of the
    replicas, whose mean gradient (after the backward, before clipping
    and the update) the step applies; the batch is then this replica's
    rows (see the module docstring), an MoE layer routes
    as one replica of the whole microbatch, and ``metrics["loss"]`` stays
    this replica's loss (and, for MoE models, ``metrics["aux"]`` the aux
    loss it includes).  ``tensor``: the rank's tensor group; the state's
    leaves are its blocks (``Model.init(..., tensor=)``) and the layers
    run as one rank of it (``models.tensor_axis``)."""
    from repro_torch.core.pipeline_stream import _tensor_dims
    M = num_microbatches or model.cfg.mesh_plan.num_microbatches
    dims = _tensor_dims(model, tensor)

    def train_step(state: Dict[str, Any], batch):
        batch = device_batch(batch, model.device)
        with torch.enable_grad(), moe.data_axis(group), \
                tensor_axis.tensor_axis(tensor):
            leaves = _leaves_like(state["params"])
            loss, aux = _loss_and_aux(model, leaves, batch, M)
            grads, _ = _grads(loss, leaves, None)
        metrics = {"loss": loss.detach()}
        if model.cfg.moe is not None:
            metrics["aux"] = aux.detach()
        norm = sgd.update_groups(
            [(state["params"], state["momentum"], grads, 0.0, None)],
            lr=lr, gamma=gamma, clip=clip, data=group, tensor=tensor,
            tensor_dims=dims)
        if clip:
            metrics["grad_norm"] = norm
        state["step"] += 1
        return state, metrics

    return train_step


def init_state(model, generator: torch.Generator, *, data=None,
               zero1: bool = True, tensor=None) -> Dict[str, Any]:
    """Params drawn from ``generator`` (with ``tensor=(rank, T)`` the
    rank's blocks, ``Model.init``) and zero momentum: whole, or with a
    data group of N > 1 and ``zero1`` the replica's ZeRO-1 pieces
    (``optim.sgd.init_shard``)."""
    params = model.init(generator, tensor=tensor)
    if zero1 and data is not None and data.world > 1:
        mom = sgd.init_shard(params, data.rank, data.world)
    else:
        mom = sgd.init(params).v
    return {"params": params, "momentum": mom, "step": 0}
