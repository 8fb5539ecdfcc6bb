"""Fig. 8 reproduction: RMSE of SpecTrain-predicted vs stale weights at
version differences s ∈ {1,2,3}, measured on a real SNN training run
(the port's twin of ``benchmarks/rmse.py``).

    python -m repro_torch.bench.rmse [--device cpu] [--full]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench import cli, teacher_batches
from repro_torch.core.simulator import Simulator, make_mlp_staged


def main(fast: bool = True, *, device="cuda", in_dim: int = 32,
         width: int = 128, depth: int = 8, n_classes: int = 10,
         n_stages: int = 4, batch: int = 64, lr: float = 0.05,
         seed: int = 0, data_seed: int = 7):
    steps = 150 if fast else 600
    fns, params = make_mlp_staged(torch.Generator().manual_seed(seed),
                                  in_dim=in_dim, width=width, depth=depth,
                                  n_classes=n_classes, n_stages=n_stages,
                                  device=device)
    sim = Simulator(fns, params, n_stages=n_stages, scheme="spectrain",
                    lr=lr, gamma=0.9, rmse_s=(1, 2, 3))
    data = teacher_batches(in_dim=in_dim, n_classes=n_classes, batch=batch,
                           seed=data_seed, device=device)
    t0 = time.time()
    ms = [sim.step(next(data)) for _ in range(steps)]
    us = (time.time() - t0) / steps * 1e6

    lines = []
    for s in (1, 2, 3):
        pred = np.mean([m[f"rmse_pred_s{s}"] for m in ms[20:]])
        stale = np.mean([m[f"rmse_stale_s{s}"] for m in ms[20:]])
        lines.append(f"rmse/snn_s{s},{us:.0f},"
                     f"pred={pred:.2e};stale={stale:.2e};"
                     f"stale_over_pred={stale/pred:.2f}")
    return lines


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print("\n".join(main(not args.full, device=args.device)))
