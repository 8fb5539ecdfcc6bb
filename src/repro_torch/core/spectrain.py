"""SpecTrain: weight prediction via momentum-smoothed gradients (paper
§3.2), the port's copy of ``repro/core/spectrain.py`` in plain torch.

  (1)  v_t = γ·v_{t−1} + (1−γ)·g_t                     (smoothed gradient)
  (4)  Ŵ_{t+s} = W_t − s·η·v_{t−1}                      (s-step prediction)
  (5)  s_fwd  = ⌊k/2⌋ + N − k − 1                       (round-robin schedule)
  (6)  s_bwd  = ⌊k/2⌋

The streaming tick schedule (``core/pipeline_stream.py``) has
s_fwd = 2·(N − 1 − k), s_bwd = 0; the 1F1B flush schedules have 0 for
both, PipeDream-2BW 1 for both.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.layers import tree_leaves, tree_zip_map


# ---------------------------------------------------------------------------
# version differences


def _check_stage(stage: int, n_stages: int) -> None:
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} out of range for {n_stages} stages")


def version_difference_paper(stage: int, n_stages: int, phase: str) -> int:
    """Eqs. (5)/(6) — the paper's round-robin 1F1B schedule."""
    k, n = stage, n_stages
    _check_stage(k, n)
    if phase == "forward":
        return k // 2 + n - k - 1
    if phase == "backward":
        return k // 2
    raise ValueError(phase)


def version_difference_stream(stage: int, n_stages: int, phase: str) -> int:
    """The streaming-tick schedule (one 1F+1B wave per train_step)."""
    k, n = stage, n_stages
    _check_stage(k, n)
    if phase == "forward":
        return 2 * (n - 1 - k)
    if phase == "backward":
        return 0
    raise ValueError(phase)


def version_difference_1f1b(stage: int, n_stages: int, phase: str) -> int:
    """1F1B with flush and its interleaved variant: staleness-free."""
    _check_stage(stage, n_stages)
    if phase not in ("forward", "backward"):
        raise ValueError(phase)
    return 0


def version_difference_2bw(stage: int, n_stages: int, phase: str) -> int:
    """PipeDream-2BW: a uniform staleness of 1 for both phases."""
    _check_stage(stage, n_stages)
    if phase not in ("forward", "backward"):
        raise ValueError(phase)
    return 1


# ---------------------------------------------------------------------------
# prediction


def predict_weights(params: Any, momentum: Any, lr, s) -> Any:
    """Eq. (4): Ŵ_{t+s} = W_t − s·η·v_{t−1}, leaf by leaf, in fp32 and
    cast back to each weight's dtype.  ``s·η`` is formed in fp32 as the
    JAX twin forms it.  (The streaming runtime computes the same
    prediction inside the fused update kernel instead.)"""
    s_lr = (torch.tensor(float(s), dtype=torch.float32)
            * torch.tensor(float(lr), dtype=torch.float32)).item()
    return tree_zip_map(
        lambda w, v: (w.float() - s_lr * v.float()).to(w.dtype),
        params, momentum)


def predict_weights_stacked(params: Any, momentum: Any, lr, s_per_stage
                            ) -> Any:
    """Per-stage prediction for stage-stacked params: every leaf of
    ``params`` has a leading [n_stages] axis and ``s_per_stage`` is an int
    vector [n_stages], broadcast along that axis (``s·η`` in fp32 as the
    JAX twin forms it: s as fp32 times lr as fp32)."""
    s = torch.as_tensor(s_per_stage, dtype=torch.float32)
    lr = torch.tensor(float(lr), dtype=torch.float32)

    def leaf(w, v):
        sb = s.to(w.device).reshape((-1,) + (1,) * (w.dim() - 1))
        return (w.float() - sb * lr.to(w.device) * v.float()).to(w.dtype)

    return tree_zip_map(leaf, params, momentum)


# ---------------------------------------------------------------------------
# prediction-error metric (Fig. 8)


def rmse(a: Any, b: Any) -> torch.Tensor:
    """Root-mean-square error between two trees (global, fp32)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    sq = sum(torch.sum(torch.square(x.float() - y.float()))
             for x, y in zip(la, lb))
    n = sum(x.numel() for x in la)
    return torch.sqrt(sq / n)
