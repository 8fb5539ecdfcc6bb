"""Tracer overhead: traced vs untraced IR step wall time (the port's twin
of ``benchmarks/trace_overhead.py``).

    python -m repro_torch.bench.trace_overhead [--device cpu] [--full]

The ``--trace`` instrumentation (``repro_torch.obs.PipelineTracer``)
takes one mark per compute event of the round (a CUDA event recorded on
the stream on the card, a clock reading on the CPU) and synchronizes
the card once a step.  This benchmark bounds its cost on the step path:

Rows:
  trace/step_off — steady step wall time, tracer off (the round takes
                   no mark);
  trace/step_on  — same plan/model with the tracer attached; derived
                   column reports the relative overhead of the medians.

Both steps run on one state in alternating pairs (off, on, then on,
off, ...), each followed by a synchronize, after a warm call of each:
host-bound rounds drift with the host, and a pair sees the same drift.
The model is the 4-layer smoke granite on 2 stages in fp32, a 1f1b round
of 4 (``--full``: 16) microbatches of [1, 16]: a round of small
launches, where a mark's cost weighs most.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List, Tuple

import torch

from repro_torch.bench import cli


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def paired_walls(step_off, step_on, state, batch, device,
                 pairs: int = 5) -> Tuple[List[float], List[float]]:
    """Seconds a step of ``step_off`` and of ``step_on`` (the same round,
    untraced and traced) take on one ``state``, ``pairs`` of each in
    alternating order, each step followed by a synchronize; one warm
    call of each first."""
    steps = (step_off, step_on)
    for fn in steps:
        fn(state, batch)
    _sync(device)
    walls: Tuple[List[float], List[float]] = ([], [])
    for k in range(pairs):
        for i in ((0, 1) if k % 2 == 0 else (1, 0)):
            t0 = time.perf_counter()
            steps[i](state, batch)
            _sync(device)
            walls[i].append(time.perf_counter() - t0)
    return walls


def main(fast: bool = True, *, device="cuda", pairs: int = 10):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models import Model
    from repro_torch.obs import PipelineTracer
    from repro_torch.planner import plan, synthetic_profile

    cfg = smoke_config(get_config("granite-8b"))
    cfg = cfg.replace(
        n_layers=4,
        mesh_plan=dataclasses.replace(cfg.mesh_plan, pipe=2),
        param_dtype="float32", compute_dtype="float32")
    model = Model(cfg, device=device)
    dev = model.device
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    M = 4 if fast else 16
    p = plan(profile=synthetic_profile([1.0] * cfg.n_layers),
             n_stages=2, schedule="1f1b", n_microbatches=M)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (M, 16), generator=gen,
                              device=dev) for k in ("tokens", "targets")}

    state = ps.make_ir_state(model, params, plan=p)
    step_off = ps.make_ir_train_step(model, plan=p, mode="spectrain",
                                     lr=0.05, backend="scan")
    tracer = PipelineTracer(p, device=dev)
    step_on = tracer.wrap_step(ps.make_ir_train_step(
        model, plan=p, mode="spectrain", lr=0.05, backend="scan",
        tracer=tracer))
    off, on = paired_walls(step_off, step_on, state, batch, dev, pairs)
    us_off, us_on = (statistics.median(x) * 1e6 for x in (off, on))
    pct = (us_on / us_off - 1.0) * 100.0
    return [
        f"trace/step_off,{us_off:.0f},M={M};pairs={pairs}",
        f"trace/step_on,{us_on:.0f},overhead_pct={pct:.1f};M={M};"
        f"rounds={len(tracer.rounds)}",
    ]


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print("\n".join(main(not args.full, device=args.device)))
