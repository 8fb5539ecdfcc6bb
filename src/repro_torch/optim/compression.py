"""Gradient compression for the data-axis all-reduce (beyond-paper; from
the paper's related-work menu: Aji&Heafield'17 / Lin et al.'17 / Seide
et al.'14): the port's twin of ``repro/optim/compression.py``.

* ``topk``  — magnitude top-k sparsification with error feedback: the
  residual of what wasn't transmitted is added back next step, so the
  compressed series telescopes to the true gradient sum.
* ``int8``  — per-tensor scale quantization with stochastic rounding
  (unbiased), the all-reduce-friendly analogue of 1-bit SGD.

A library, as in the JAX package: the JAX launcher parses
``--compress`` and reads it nowhere, and the port's launcher refuses the
flag (``launch/train.py``).  The stochastic rounding is split from its
draws (:func:`int8_round`), so that it equals the JAX twin's given the
same uniform draws; the draws themselves come from a
``torch.Generator``, whose stream is not JAX's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.layers import tree_map, tree_zip_map


# ---------------------------------------------------------------------------
# top-k with error feedback


def topk_init(grads) -> Any:
    return tree_map(lambda _, g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)


def topk_compress(grads, residual, *, frac: float = 0.01
                  ) -> Tuple[Any, Any, Dict[str, Any]]:
    """Returns (transmitted_dense, new_residual, stats).

    transmitted_dense is the sparsified gradient densified again (what the
    receiving side reconstructs); new_residual = carry for error feedback.
    """
    stats = {"kept": 0, "total": 0}

    def leaf(g, r):
        acc = g.float() + r
        flat = acc.reshape(-1)
        k = max(1, int(frac * flat.numel()))
        idx = torch.topk(flat.abs(), k).indices
        sent = torch.zeros_like(flat).index_put_((idx,), flat[idx])
        stats["kept"] += k
        stats["total"] += flat.numel()
        sent = sent.reshape(g.shape)
        return sent, acc - sent

    out = tree_zip_map(leaf, grads, residual)
    pick = lambda i: tree_zip_map(lambda _, o: o[i], grads, out)
    return pick(0), pick(1), stats


# ---------------------------------------------------------------------------
# int8 stochastic-rounding quantization


def int8_round(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Quantize ``g`` to int8 with a per-tensor scale, rounding up where
    the uniform draw ``u`` (fp32, g's shape) falls below the fractional
    part, and dequantize: the JAX twin's rounding of one leaf."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    x = gf / scale
    lo = torch.floor(x)
    p = x - lo
    up = u.to(x.device) < p
    q = torch.clamp(lo + up.float(), -127, 127)
    return (q * scale).to(g.dtype)


def int8_roundtrip(grads, generator: torch.Generator) -> Any:
    """Quantize to int8 with per-tensor scale + stochastic rounding, then
    dequantize (unbiased: E[deq] = g).  Models the wire format of an int8
    all-reduce (4x fewer bytes than fp32).  One uniform draw a gradient
    element from ``generator`` (on the gradients' device), leaf by leaf
    in tree order."""
    return tree_map(lambda _, g: int8_round(g, torch.rand(
        g.shape, generator=generator, device=g.device)), grads)
