"""Fig. 10 reproduction: execution-time breakdown (compute / P2P /
P2P-idle / imbalance-idle) of Data-P vs Model-P, normalized to Data-P.

The port's numpy twin of ``benchmarks/breakdown.py``
(``python -m repro_torch.bench.breakdown``): its ``main()`` lines are
string-equal to the JAX script's.  Every time in it comes from the
paper's modelled platform (4x Tesla P40 on PCIe 3.0, ``_timeline``'s
``P40_FLOPS`` and ``PCIE_BW``), never from this port's card.
"""
from __future__ import annotations

from repro_torch.bench._timeline import (dp_step_time, paper_models,
                                  pipeline_step_time)


def main(fast: bool = True):
    lines = []
    for m in paper_models():
        dp = dp_step_time(m, 4)
        mp = pipeline_step_time(m, 4)
        norm = dp["step"]
        for mode, t in (("dp", dp), ("mp", mp)):
            parts = ";".join(
                f"{k}={t[k]/norm:.3f}"
                for k in ("compute", "p2p", "p2p_idle", "imbalance_idle"))
            lines.append(f"breakdown/{m.name}/{mode},"
                         f"{t['step']*1e6:.0f},{parts}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
