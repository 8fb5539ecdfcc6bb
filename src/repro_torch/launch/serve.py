"""Greedy serving driver for the port (twin of ``repro/launch/serve.py``).

A seeded Poisson arrival trace (``serve/trace.py``) is served by the
whole-model ``SimpleEngine``: every request prefills in one causal call
and decodes token by token.  On the card every attention call goes
through the hand-written flash forward kernel and every RWKV-6 or
Mamba-2 recurrence through its hand-written scan kernel.  ``--arch``
takes granite-8b (dense), rwkv6-7b (attention-free) and zamba2-1.2b
(Mamba-2 with shared attention blocks).  The pipelined engine is a
later slice of the port, so ``--engine`` takes only ``simple``.

Unlike the JAX launcher, which always shrinks the model, this one
serves the full configuration unless ``--smoke`` is given.  It runs on
the card unless ``--device cpu`` is given; on a machine without a card,
``--device cuda`` (the default) fails.

Reported rates exclude the engine's warm-up (kernel build, one prefill,
one decode); ``--metrics-out`` appends the per-request events, the
per-token latency histogram and the summary record as JSONL.

Example (full-width granite-8b, or rwkv6-7b, on one H100):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --requests 8 --rate 1.5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import Model
from repro_torch.obs import MetricsRegistry
from repro_torch.planner import serve_plan
from repro_torch.serve import SimpleEngine, poisson_trace


def _pair(s: str):
    lo, hi = (int(x) for x in s.split(","))
    return lo, hi


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b",
                    help="granite-8b, rwkv6-7b or zamba2-1.2b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced smoke config of --arch")
    ap.add_argument("--engine", default="simple",
                    choices=("simple", "pipelined"),
                    help="'simple' serves each request through the "
                         "whole-model decode_step ('pipelined' is a later "
                         "slice of the port)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=8,
                    help="trace length (seeded Poisson arrivals)")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="mean arrivals per round")
    ap.add_argument("--prompt-lens", type=_pair, default=(2, 12),
                    dest="prompt_lens", metavar="LO,HI",
                    help="inclusive prompt-length range")
    ap.add_argument("--gen-lens", type=_pair, default=(1, 8),
                    dest="gen_lens", metavar="LO,HI",
                    help="inclusive generation-length range")
    ap.add_argument("--prompt-budget", type=int, default=16,
                    dest="prompt_budget",
                    help="longest prompt admitted")
    ap.add_argument("--page-seq", type=int, default=64, dest="page_seq",
                    help="KV positions per request (caps prompt + gen)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="", dest="metrics_out",
                    help="append per-request events, latency histograms "
                         "and the summary record as JSONL to this path")
    args = ap.parse_args(argv)
    if args.engine == "pipelined":
        raise SystemExit("--engine pipelined is not ported to PyTorch yet "
                         "(a later slice); use --engine simple")

    registry = MetricsRegistry(jsonl_path=args.metrics_out or None)
    try:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = smoke_config(cfg)
        if args.layers:
            cfg = cfg.replace(n_layers=args.layers)
        model = Model(cfg, device=args.device)
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = model.init(gen, dtype=cfg.compute_dtype)

        # the simple engine serves one request at a time on one device
        splan = serve_plan(cfg, n_stages=1, n_slots=1, max_prefill=1,
                           prompt_budget=args.prompt_budget,
                           page_seq=args.page_seq)
        trace = poisson_trace(
            args.requests, rate=args.rate, seed=args.seed,
            prompt_lens=args.prompt_lens, gen_lens=args.gen_lens,
            vocab=cfg.vocab_size)
        device_name = (torch.cuda.get_device_name(model.device)
                       if model.device.type == "cuda" else "cpu")
        print(f"# {splan.summary()}")
        print(f"# arch={cfg.name} engine=simple device={device_name} "
              f"layers={cfg.n_layers} d_model={cfg.d_model} "
              f"dtype={cfg.compute_dtype} requests={len(trace)} "
              f"rate={args.rate} seed={args.seed}")

        engine = SimpleEngine(model, params, splan, registry=registry)
        del params
        t0 = time.time()
        results = engine.run(trace)
        wall_s = time.time() - t0

        served = {r: t for r, t in results.items() if t}
        rejected = sorted(r for r, t in results.items() if not t)
        n_tokens = sum(len(t) for t in served.values())
        hist = registry.histogram("serve/token_ms")
        p50 = hist.percentile(50.0)
        p99 = hist.percentile(99.0)
        compile_s = registry.gauge("serve/compile_s").value or 0.0
        tok_per_s = n_tokens / max(wall_s, 1e-9)
        registry.gauge("serve/wall_s").set(wall_s)
        registry.gauge("serve/tok_per_s").set(tok_per_s)
        registry.emit(
            "serve_run", arch=cfg.name, engine="simple",
            execution="eager", device=device_name,
            n_requests=len(trace), n_served=len(served),
            n_rejected=len(rejected), n_tokens=n_tokens, rate=args.rate,
            seed=args.seed, wall_s=wall_s, compile_s=compile_s,
            tok_per_s=tok_per_s, token_ms_p50=p50, token_ms_p99=p99)
        print(f"compile: {compile_s:.2f}s   "
              f"decode: {tok_per_s:.1f} tok/s   "
              f"p50: {p50:.2f} ms/tok   p99: {p99:.2f} ms/tok")
        print(f"served {len(served)}/{len(trace)} requests "
              f"({len(rejected)} rejected), {n_tokens} tokens "
              f"in {wall_s:.2f}s")
        first = min(served) if served else None
        if first is not None:
            print(f"sample (rid {first}):", list(served[first])[:16])
        if not all(math.isfinite(v) for v in (tok_per_s, p50, p99)):
            raise RuntimeError("non-finite serving metrics")
        return 0
    finally:
        registry.close()


if __name__ == "__main__":
    raise SystemExit(main())
