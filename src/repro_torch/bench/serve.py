"""Continuous-batching serving throughput and per-token latency (the
port's twin of ``benchmarks/serve_bench.py``).

    python -m repro_torch.bench.serve [--device cpu] [--full]

Drives one seeded Poisson trace through the pipelined ``ServeEngine``
and the whole-model ``SimpleEngine`` and prints rows in the JAX
script's format (primary column: µs per emitted token, 1e6 / tok/s):

  serve/scan_tok    the pipelined engine (the scan backend); derived
                    tok/s and the p50/p99 per-token latency of its
                    round histogram;
  serve/mpmd_tok    the pipelined engine's mpmd backend on the same
                    trace, one process per stage (2 ranks, sharing the
                    card, or on the CPU), its tokens checked equal to
                    the scan backend's before its time is reported;
  serve/simple_tok  ``SimpleEngine`` on the same trace, its tokens
                    checked equal to the pipelined engine's; the derived
                    speedup is the continuous-batching win;
  serve/compile     the pipelined engine's warm-up, µs.

Wall time excludes the warm-ups (kernel build, one round or one prefill
and decode).
"""
from __future__ import annotations

import time

import torch

from repro_torch.bench import cli
from repro_torch.bench.convergence import tiny_cfg
from repro_torch.models import Model
from repro_torch.obs import MetricsRegistry
from repro_torch.planner import serve_plan
from repro_torch.serve import ServeEngine, SimpleEngine, poisson_trace


def _drive(engine, trace):
    t0 = time.perf_counter()
    results = engine.run(trace)
    wall_s = time.perf_counter() - t0
    return results, sum(len(t) for t in results.values()), wall_s


def _mpmd_rank(group, cfg, splan, trace):
    """One rank of the mpmd row: the same weights (seed 0) and trace;
    rank 0's (results, tokens, wall) after warm-up."""
    model = Model(cfg, device=group.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    eng = ServeEngine(model, params, splan, backend="mpmd", group=group)
    eng._warm_up()
    return _drive(eng, trace)


def main(fast: bool = True, *, device="cuda"):
    cfg = tiny_cfg("granite-8b", n_layers=4, pipe=2)
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(model.device).manual_seed(0))

    n_req = 8 if fast else 32
    splan = serve_plan(None, n_stages=2, n_slots=4, max_prefill=2,
                       prompt_budget=12, page_seq=32, n_layers=cfg.n_layers)
    trace = poisson_trace(n_req, rate=1.5, seed=0, prompt_lens=(2, 12),
                          gen_lens=(1, 8), vocab=cfg.vocab_size)

    reg = MetricsRegistry()
    eng = ServeEngine(model, params, splan, registry=reg)
    eng._warm_up()                 # both engines' walls exclude warm-up
    scan_res, n_tokens, wall_s = _drive(eng, trace)
    hist = reg.histogram("serve/token_ms")
    compile_s = reg.gauge("serve/compile_s").value or 0.0
    scan_us = wall_s / max(n_tokens, 1) * 1e6
    rows = [f"serve/scan_tok,{scan_us:.0f},"
            f"tok_per_s={n_tokens / max(wall_s, 1e-9):.1f};"
            f"p50_ms={hist.percentile(50.0):.2f};"
            f"p99_ms={hist.percentile(99.0):.2f};"
            f"requests={n_req};tokens={n_tokens}",
            f"serve/compile,{compile_s * 1e6:.0f},backend=scan"]

    from repro_torch.launch.mesh import run_stage_ranks
    mpmd_res, n_tokens, wall_s = run_stage_ranks(
        _mpmd_rank, splan.n_stages, device, args=(cfg, splan, trace))[0]
    if mpmd_res != scan_res:
        raise RuntimeError("the mpmd backend diverged from the scan "
                           "backend's tokens")
    mpmd_us = wall_s / max(n_tokens, 1) * 1e6
    rows.append(f"serve/mpmd_tok,{mpmd_us:.0f},"
                f"tok_per_s={n_tokens / max(wall_s, 1e-9):.1f};"
                f"ranks={splan.n_stages};vs_scan="
                f"{mpmd_us / max(scan_us, 1e-9):.2f}x")

    simple = SimpleEngine(model, params, splan)
    simple._warm_up()
    simple_res, n_tokens, wall_s = _drive(simple, trace)
    if simple_res != scan_res:
        raise RuntimeError(
            "pipelined serving diverged from the whole-model reference")
    simple_us = wall_s / max(n_tokens, 1) * 1e6
    rows.append(f"serve/simple_tok,{simple_us:.0f},"
                f"batching_speedup={simple_us / max(scan_us, 1e-9):.2f}x")
    return rows


if __name__ == "__main__":
    args = cli(__doc__.splitlines()[0])
    print("\n".join(main(not args.full, device=args.device)))
