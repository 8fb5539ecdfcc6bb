"""Discrete-event timeline model of the paper's execution modes on the
4-GPU PCIe box (Figs. 9/10).

Models, per GPU: compute busy time (fwd/bwd), P2P transfer time,
P2P-induced idle (link contention), and imbalance-induced idle — the four
components of the paper's Fig. 10 breakdown.

The port's numpy twin of ``benchmarks/_timeline.py``, the cost model
the figure twins (``throughput``, ``breakdown``, ``comm_time``,
``comm_volume``) read.  Every time in it comes from the
paper's modelled platform (4x Tesla P40 on PCIe 3.0, ``_timeline``'s
``P40_FLOPS`` and ``PCIE_BW``), never from this port's card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

# paper platform constants (§4.1): 4x Tesla P40 on PCIe 3.0 x16
P40_FLOPS = 11.76e12 * 0.35     # fp32 peak x achievable efficiency
PCIE_BW = 12.0e9                # bytes/s effective per link
N_GPUS_DEFAULT = 4


@dataclass
class ModelCost:
    name: str
    params: int                     # total weights
    flops_per_sample: float         # fwd flops per sample
    cut_activations: Tuple[int, ...]  # elements crossing each pipeline cut
    batch: int = 128


def dp_step_time(m: ModelCost, n_gpus: int) -> Dict[str, float]:
    """Synchronous data parallelism: compute on batch/n, then grad sync.

    The Falconwitch box supports simultaneous P2P transfers (§4.1), so the
    sync is ring-style: 2 x params x 4B x (n-1)/n per link, plus ~20%
    switch-contention idle.
    """
    compute = 3.0 * m.flops_per_sample * (m.batch / n_gpus) / P40_FLOPS
    bytes_per_link = 2.0 * m.params * 4.0 * (n_gpus - 1) / n_gpus
    p2p = bytes_per_link / PCIE_BW
    p2p_idle = 0.2 * p2p
    step = compute + p2p + p2p_idle
    return {"step": step, "compute": compute, "p2p": p2p,
            "p2p_idle": p2p_idle, "imbalance_idle": 0.0}


def pipeline_step_time(m: ModelCost, n_gpus: int, *,
                       imbalance: float = 0.08) -> Dict[str, float]:
    """Steady-state 1F1B pipeline (PipeDream-style, zero bubble after
    warm-up): per-minibatch time = the slowest stage's fwd+bwd time, with
    activation transfers overlapped (background thread, §3.1) except for
    their on-link serialization."""
    per_stage_flops = 3.0 * m.flops_per_sample * m.batch / n_gpus
    stage = per_stage_flops / P40_FLOPS
    slowest = stage * (1.0 + imbalance)
    # activation + gradient bytes on the busiest link
    if m.cut_activations:
        cut = max(m.cut_activations)
        act_bytes = 2.0 * cut * 4.0 * m.batch
    else:
        act_bytes = 0.0
    p2p = act_bytes / PCIE_BW
    step = max(slowest, p2p)        # overlapped; the max wins
    imbalance_idle = slowest - stage
    p2p_idle = max(0.0, p2p - slowest)
    return {"step": step, "compute": stage, "p2p": min(p2p, step),
            "p2p_idle": p2p_idle, "imbalance_idle": imbalance_idle}


def single_gpu_step(m: ModelCost) -> float:
    return 3.0 * m.flops_per_sample * m.batch / P40_FLOPS


def throughput(m: ModelCost, mode: str, n_gpus: int) -> float:
    """samples/sec, normalized externally."""
    if mode == "single":
        return m.batch / single_gpu_step(m)
    if mode == "dp":
        return m.batch / dp_step_time(m, n_gpus)["step"]
    return m.batch / pipeline_step_time(m, n_gpus)["step"]


# ---------------------------------------------------------------------------
# the paper's six benchmark models (§4.1), as cost models


def paper_models() -> List[ModelCost]:
    return [
        # CNNs (CIFAR-10, 32x32): flops ~ 2 * params_eff * spatial reuse
        ModelCost("vgg16", 138_357_544, 0.63e9,
                  (128 * 16 * 16, 256 * 8 * 8, 512 * 4 * 4)),
        ModelCost("resnet152", 60_192_808, 2.3e9,
                  (256 * 16 * 16, 512 * 8 * 8, 1024 * 4 * 4)),
        ModelCost("inception_v4", 42_679_816, 1.4e9,
                  (384 * 8 * 8, 1024 * 4 * 4, 1536 * 2 * 2)),
        # SNN: 32 FC layers x 2048 (CIFAR input)
        ModelCost("snn", 32 * 2048 * 2048 + 3072 * 2048, 2 * 32 * 2048 * 2048,
                  (2048, 2048, 2048)),
        # Transformer: 6+6 blocks, d=512, seq 20 (IMDb)
        ModelCost("transformer", 44_000_000 + 30000 * 512,
                  2 * 44_000_000 * 20, (20 * 512, 20 * 512, 20 * 512)),
        # Residual LSTM: 8 layers, 1024 mem units, seq 80
        ModelCost("residual_lstm", 8 * 4 * (512 * 1024 + 1024 * 1024),
                  2 * 8 * 4 * (512 + 1024) * 1024 * 80,
                  (80 * 512, 80 * 512, 80 * 512)),
    ]


def lm_models() -> List[ModelCost]:
    """Our ten assigned archs as cost models (seq 4096 training shape),
    read through ``configs.arch_config``."""
    from repro_torch.configs import arch_config, list_archs
    out = []
    for name in list_archs():
        cfg = arch_config(name)
        seq = 4096
        out.append(ModelCost(
            name, cfg.param_count(),
            2.0 * cfg.active_param_count() * seq,
            tuple([cfg.d_model * seq] * 3), batch=16))
    return out
