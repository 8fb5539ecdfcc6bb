"""Fig. 11 / Table 1 reproduction: learning curves + final loss of the
four schemes (Data-P reference = sync, Vanilla Model-P, PipeDream,
SpecTrain), on real training runs of the paper's FCN (SNN) and
Transformer families — both in the paper-exact simulator and in the
streaming runtime (the port's twin of ``benchmarks/convergence.py``).

    python -m repro_torch.bench.convergence [--device cpu] [--full]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench import cli, teacher_batches
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import MeshPlan
from repro_torch.core import pipeline_stream
from repro_torch.core.simulator import Simulator, make_mlp_staged
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import Model


def tiny_cfg(name="granite-8b", *, n_layers=4, pipe=2, tensor=1, ticks=2,
             **kw):
    """Reduced fp32 config with a real pipeline split (the port's copy
    of ``benchmarks/conftest_shim.py::tiny_cfg``)."""
    cfg = smoke_config(get_config(name))
    return cfg.replace(
        n_layers=n_layers,
        mesh_plan=MeshPlan(pipe=pipe, tensor=tensor, num_microbatches=ticks),
        param_dtype="float32", compute_dtype="float32", **kw)


def snn_simulator(fast: bool, *, device="cuda", in_dim: int = 32,
                  width: int = 64, depth: int = 8, n_classes: int = 10,
                  n_stages: int = 4, batch: int = 64, lr: float = 0.12,
                  seed: int = 0, data_seed: int = 1):
    """{scheme: (mean loss of the last 40 steps, µs per step)}."""
    steps = 250 if fast else 1200
    fns, params = make_mlp_staged(torch.Generator().manual_seed(seed),
                                  in_dim=in_dim, width=width, depth=depth,
                                  n_classes=n_classes, n_stages=n_stages,
                                  device=device)
    out = {}
    for scheme in Simulator.SCHEMES:
        sim = Simulator(fns, params, n_stages=n_stages, scheme=scheme,
                        lr=lr)
        data = teacher_batches(in_dim=in_dim, n_classes=n_classes,
                               batch=batch, seed=data_seed, device=device)
        t0 = time.time()
        losses = [sim.step(next(data))["loss"] for _ in range(steps)]
        out[scheme] = (np.mean(losses[-40:]),
                       (time.time() - t0) / steps * 1e6)
    return out


def transformer_stream(fast: bool, *, device="cuda", n_layers: int = 4,
                       pipe: int = 4, seq: int = 16, batch: int = 8,
                       lr: float = 0.08, seed: int = 0, data_seed: int = 5):
    """({mode: (mean valid loss of the last 30 steps, µs per step)},
    the data's optimal loss)."""
    steps = 150 if fast else 800
    cfg = tiny_cfg("granite-8b", n_layers=n_layers, pipe=pipe)
    m = Model(cfg, device=device)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch,
                                  seed=data_seed))
    out = {}
    for mode in pipeline_stream.MODES:
        gen = torch.Generator(m.device).manual_seed(seed)
        state = pipeline_stream.init_state(m, gen, data.batch_at(0),
                                           mode=mode)
        step = pipeline_stream.make_train_step(m, mode=mode, lr=lr)
        losses = []
        t0 = time.time()
        for s in range(steps):
            state, met = step(state, data.batch_at(s))
            if float(met["loss_valid"]):
                losses.append(float(met["loss"]))
        out[mode] = (np.mean(losses[-30:]),
                     (time.time() - t0) / steps * 1e6)
    return out, data.optimal_loss()


def main(fast: bool = True, *, device="cuda"):
    lines = []
    sim = snn_simulator(fast, device=device)
    for scheme, (loss, us) in sim.items():
        lines.append(f"convergence/snn_sim/{scheme},{us:.0f},"
                     f"final_loss={loss:.4f}")
    lines.append(
        "convergence/snn_sim/spectrain_gap_vs_sync,0,"
        f"{sim['spectrain'][0] - sim['sync'][0]:+.4f}")
    tr, floor = transformer_stream(fast, device=device)
    for mode, (loss, us) in tr.items():
        lines.append(f"convergence/lm_stream/{mode},{us:.0f},"
                     f"final_loss={loss:.4f};floor={floor:.4f}")
    return lines


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print("\n".join(main(not args.full, device=args.device)))
