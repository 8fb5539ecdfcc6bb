"""Cross-pod asynchronous data parallelism with SpecTrain compensation,
the port's twin of ``repro/core/async_dp.py`` (beyond the paper).

At 2+ pods the inter-pod all-reduce rides the slow link between pods;
hiding it asynchronously re-creates the staleness the paper solves
inside the pipeline, so the same medicine is applied at pod level:

  * each pod applies its **local** gradient immediately;
  * the **remote** pods' gradients arrive ``delay`` steps late (the
    all-reduce overlaps the following steps' compute);
  * every pod computes its gradient at SpecTrain-predicted weights
    Ŵ = W − s·η·v with s = ``delay`` (Eq. 4), compensating the lag.

These are host-level references of the algorithm, as in JAX: one
process runs every pod in turn.  ``loss_fn(params, batch)`` takes torch
trees; the gradient comes from ``torch.autograd.grad``, the update from
the port's ``optim.sgd.update`` (the fused update kernel on the card, in
place), the prediction from ``core.spectrain.predict_weights``.  Because
the update is in place, each pod holds its own copy of the parameters
(JAX may alias one immutable tree across pods), and the queued remote
gradients are trees no later step writes.  Zhang et al.'s
staleness-dependent scaling of the remote gradient is ``remote_scale``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from repro_torch.core import spectrain as st
from repro_torch.core.pipeline_stream import _grads, _leaves_like
from repro_torch.models.layers import tree_map, tree_zip_map
from repro_torch.optim import sgd


def _clone(tree):
    return tree_map(lambda _, a: a.detach().clone(), tree)


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss as a float, gradient tree) of ``loss_fn`` at ``params``; a
    leaf the loss does not reach gets a zero gradient."""
    with torch.enable_grad():
        leaves = _leaves_like(params)
        loss = loss_fn(leaves, batch)
        grads, _ = _grads(loss, leaves, None)
    return float(loss.detach()), grads


def _mean(trees):
    """``sum(xs) / len(xs)`` leaf by leaf, the JAX twin's order."""
    return tree_zip_map(lambda *xs: sum(xs) / len(xs), *trees)


class AsyncPodDP:
    """Host-level reference of the cross-pod async scheme.

    loss_fn(params, batch) -> scalar tensor; one parameter copy per pod.
    """

    def __init__(self, loss_fn: Callable, params, *, n_pods: int = 2,
                 lr: float = 1e-2, gamma: float = 0.9,
                 predict: bool = True, remote_scale: float = 1.0,
                 delay: int = 1):
        self.loss_fn = loss_fn
        self.n = n_pods
        self.lr = lr
        self.gamma = gamma
        self.predict = predict
        self.remote_scale = remote_scale
        self.delay = delay
        self.params = [_clone(params) for _ in range(n_pods)]
        self.mom = [sgd.init(p) for p in self.params]
        # remote-gradient pipeline: arrivals are `delay` steps late
        self.remote_q: List[List[Any]] = [[] for _ in range(n_pods)]

    def step(self, batches: List[Any]) -> Dict[str, float]:
        if len(batches) != self.n:
            raise ValueError(f"{len(batches)} batches for {self.n} pods")
        grads, losses = [], []
        for p in range(self.n):
            w = self.params[p]
            if self.predict:
                # remote gradients land `delay` steps later: compute the
                # gradient at the weights predicted for arrival (Eq. 4)
                w = st.predict_weights(w, self.mom[p].v, self.lr,
                                       float(self.delay))
            loss, g = _value_and_grad(self.loss_fn, w, batches[p])
            grads.append(g)
            losses.append(loss)

        for p in range(self.n):
            others = [grads[q] for q in range(self.n) if q != p]
            # autograd's gradients are fresh tensors every step and the
            # update writes only params and momentum, so a queued tree
            # keeps its values until it is popped
            remote_now = _mean(others) if len(others) > 1 else others[0]
            self.remote_q[p].append(remote_now)
            remote = (self.remote_q[p].pop(0)
                      if len(self.remote_q[p]) > self.delay else None)
            if remote is None:
                combined = grads[p]
            else:
                combined = tree_zip_map(
                    lambda gl, gr: (gl + self.remote_scale * gr *
                                    (self.n - 1)) / self.n,
                    grads[p], remote)
            sgd.update(self.params[p], self.mom[p], combined, lr=self.lr,
                       gamma=self.gamma)
        return {"loss": sum(losses) / self.n}


class SyncPodDP:
    """Synchronous reference (every pod sees the full mean every step)."""

    def __init__(self, loss_fn: Callable, params, *, n_pods: int = 2,
                 lr: float = 1e-2, gamma: float = 0.9):
        self.loss_fn = loss_fn
        self.n = n_pods
        self.params = _clone(params)
        self.mom = sgd.init(self.params)
        self.lr, self.gamma = lr, gamma

    def step(self, batches) -> Dict[str, float]:
        gs, ls = [], []
        for b in batches:
            loss, g = _value_and_grad(self.loss_fn, self.params, b)
            gs.append(g)
            ls.append(loss)
        sgd.update(self.params, self.mom, _mean(gs), lr=self.lr,
                   gamma=self.gamma)
        return {"loss": sum(ls) / len(ls)}
