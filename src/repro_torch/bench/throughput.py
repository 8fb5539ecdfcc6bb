"""Fig. 9 reproduction: throughput of Data-P vs pipelined Model-P at 2 and
4 GPUs, normalized to single-GPU.

The port's numpy twin of ``benchmarks/throughput.py``
(``python -m repro_torch.bench.throughput``): its ``main()`` lines are
string-equal to the JAX script's.  Every time in it comes from the
paper's modelled platform (4x Tesla P40 on PCIe 3.0, ``_timeline``'s
``P40_FLOPS`` and ``PCIE_BW``), never from this port's card.
"""
from __future__ import annotations

from repro_torch.bench._timeline import paper_models, throughput


def main(fast: bool = True):
    lines = []
    fcn_speedups = []
    all_speedups = []
    for m in paper_models():
        base = throughput(m, "single", 1)
        for n in (2, 4):
            dp = throughput(m, "dp", n) / base
            mp = throughput(m, "pipe", n) / base
            lines.append(f"throughput/{m.name}/gpus{n},0,"
                         f"dp_x={dp:.2f};mp_x={mp:.2f}")
            if n == 4:
                all_speedups.append(mp / dp)
                if m.name in ("snn", "transformer", "residual_lstm"):
                    fcn_speedups.append(mp / dp)
    import numpy as np
    lines.append(f"throughput/mp_over_dp_4gpu_max,0,"
                 f"{max(all_speedups):.2f}")
    lines.append(f"throughput/mp_over_dp_4gpu_fcn_rnn_mean,0,"
                 f"{float(np.mean(fcn_speedups)):.2f}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
