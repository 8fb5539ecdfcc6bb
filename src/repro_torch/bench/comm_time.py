"""Fig. 4 reproduction: % of training time spent on inter-GPU
communication under data parallelism (4 GPUs, PCIe).

The port's numpy twin of ``benchmarks/comm_time.py``
(``python -m repro_torch.bench.comm_time``): its ``main()`` lines are
string-equal to the JAX script's.  Every time in it comes from the
paper's modelled platform (4x Tesla P40 on PCIe 3.0, ``_timeline``'s
``P40_FLOPS`` and ``PCIE_BW``), never from this port's card.
"""
from __future__ import annotations

from repro_torch.bench._timeline import dp_step_time, lm_models, paper_models


def main(fast: bool = True):
    lines = []
    pcts = []
    for m in paper_models() + lm_models():
        t = dp_step_time(m, 4)
        pct = 100.0 * (t["p2p"] + t["p2p_idle"]) / t["step"]
        pcts.append(pct)
        lines.append(f"comm_time/{m.name},{t['step']*1e6:.0f},"
                     f"comm_pct={pct:.1f}")
    lines.append(f"comm_time/mean,0,comm_pct={sum(pcts)/len(pcts):.1f}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
