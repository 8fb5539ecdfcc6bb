"""The paper's evaluation in one script: staleness RMSE (Fig. 8) and the
four-scheme convergence comparison (Fig. 11 / Table 1), on the
paper-exact event simulator (the port's twin of
``examples/spectrain_ablation.py``).

    python -m repro_torch.bench.ablation [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench import cli, teacher_batches
from repro_torch.core.simulator import Simulator, make_mlp_staged


def main(*, device="cuda", in_dim: int = 32, width: int = 64,
         depth: int = 8, n_classes: int = 10, n_stages: int = 4,
         batch: int = 64, rmse_steps: int = 200, conv_steps: int = 300,
         seed: int = 0, data_seed: int = 0):
    fns, params = make_mlp_staged(torch.Generator().manual_seed(seed),
                                  in_dim=in_dim, width=width, depth=depth,
                                  n_classes=n_classes, n_stages=n_stages,
                                  device=device)

    def data():
        return teacher_batches(in_dim=in_dim, n_classes=n_classes,
                               batch=batch, seed=data_seed, device=device)

    lines = ["== Fig. 8: prediction RMSE vs stale-weight RMSE =="]
    sim = Simulator(fns, params, n_stages=n_stages, scheme="spectrain",
                    lr=0.08, rmse_s=(1, 2, 3))
    it = data()
    ms = [sim.step(next(it)) for _ in range(rmse_steps)]
    for s in (1, 2, 3):
        p = np.mean([m[f"rmse_pred_s{s}"] for m in ms[20:]])
        st = np.mean([m[f"rmse_stale_s{s}"] for m in ms[20:]])
        lines.append(f"  s={s}: RMSE(predicted)={p:.2e}  "
                     f"RMSE(stale)={st:.2e}  -> {st/p:.2f}x better")

    lines.append(f"\n== Fig. 11 / Table 1: four schemes, {n_stages}-stage "
                 f"pipeline ==")
    for scheme in Simulator.SCHEMES:
        sim = Simulator(fns, params, n_stages=n_stages, scheme=scheme,
                        lr=0.12)
        it = data()
        losses = [sim.step(next(it))["loss"] for _ in range(conv_steps)]
        lines.append(f"  {scheme:10s} final loss "
                     f"{np.mean(losses[-40:]):.4f}")
    return lines


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print("\n".join(main(device=args.device)))
