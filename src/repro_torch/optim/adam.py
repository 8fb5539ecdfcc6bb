"""AdamW (beyond-paper option) with a SpecTrain-compatible prediction
hook: the port's twin of ``repro/optim/adam.py``.

The paper's prediction (Eq. 4) is exact for momentum SGD.  For Adam the
analogous predicted displacement per step is the preconditioned first
moment: Ŵ_{t+s} ≈ W_t − s·η·m̂/(√v̂+ε).

Like the JAX twin (and unlike ``optim/sgd.py``, which updates in place
through the fused kernel) :func:`update` returns new trees; the moments
are fp32 whatever the parameters' dtype, every tensor on its leaf's
device.  No launcher reads it, in either package.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map, tree_zip_map


class AdamState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor         # int32 scalar


def init(params) -> AdamState:
    z = lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamState(m=tree_map(z, params), v=tree_map(z, params),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


def update(params, state: AdamState, grads, *, lr, b1=0.9, b2=0.999,
           eps=1e-8, weight_decay=0.0) -> Tuple[Any, AdamState]:
    c = state.count + 1
    cf = c.float()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=c.device)
    bc1 = 1.0 - f32(b1) ** cf
    bc2 = 1.0 - f32(b2) ** cf

    def upd(p, m, v, g):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * torch.square(gf)
        step = lr * (m2 / bc1.to(m2.device)) / (
            torch.sqrt(v2 / bc2.to(v2.device)) + eps)
        pf = p.float()
        p2 = pf - step - lr * weight_decay * pf
        return p2.to(p.dtype), m2, v2

    out = tree_zip_map(upd, params, state.m, state.v, grads)
    pick = lambda i: tree_zip_map(lambda _, o: o[i], params, out)
    return pick(0), AdamState(pick(1), pick(2), c)


def predict(params, state: AdamState, *, lr, s, eps=1e-8):
    """Ŵ = W − s·η·m/(√v+ε) leaf by leaf, in fp32 and cast back to each
    weight's dtype; ``s·η`` formed in fp32 (``spectrain.predict_weights``'
    way)."""
    s_lr = float(torch.tensor(float(s), dtype=torch.float32)
                 * torch.tensor(float(lr), dtype=torch.float32))

    def leaf(p, m, v):
        disp = m / (torch.sqrt(v) + eps)
        return (p.float() - s_lr * disp).to(p.dtype)

    return tree_zip_map(leaf, params, state.m, state.v)
