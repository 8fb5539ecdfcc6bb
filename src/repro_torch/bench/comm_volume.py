"""Fig. 3 reproduction: inter-GPU data volume per minibatch, DP vs
pipelined MP, on the 4-GPU platform — for the paper's six models and the
ten assigned LM architectures.

The port's numpy twin of ``benchmarks/comm_volume.py``
(``python -m repro_torch.bench.comm_volume``): its ``main()`` lines are
string-equal to the JAX script's.  Every time in it comes from the
paper's modelled platform (4x Tesla P40 on PCIe 3.0, ``_timeline``'s
``P40_FLOPS`` and ``PCIE_BW``), never from this port's card.
"""
from __future__ import annotations

from typing import List

from repro_torch.bench._timeline import ModelCost, lm_models, paper_models


def volumes(m: ModelCost, n_gpus: int = 4):
    dp = 2.0 * m.params * 4.0 * n_gpus          # grads up + weights down
    mp = 2.0 * 4.0 * m.batch * sum(m.cut_activations)  # act fwd + grad bwd
    return dp, mp


def rows(models: List[ModelCost]):
    out = []
    for m in models:
        dp, mp = volumes(m)
        out.append((m.name, dp, mp, dp / max(mp, 1.0)))
    return out


def main(fast: bool = True):
    lines = []
    rs = rows(paper_models()) + rows(lm_models())
    for name, dp, mp, ratio in rs:
        lines.append(f"comm_volume/{name},0,"
                     f"dp_MB={dp/2**20:.1f};mp_MB={mp/2**20:.1f};"
                     f"ratio={ratio:.1f}")
    ratios = [r[3] for r in rs]
    import numpy as np
    lines.append(f"comm_volume/geomean_ratio,0,"
                 f"{float(np.exp(np.mean(np.log(ratios)))):.1f}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
