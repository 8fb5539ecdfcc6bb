"""Greedy serving driver for the port (twin of ``repro/launch/serve.py``).

A seeded Poisson arrival trace (``serve/trace.py``) is served by one of
two engines.  ``--engine pipelined`` runs the continuous-batching
``ServeEngine``: each round, one decode wave over ``--slots`` request
slots and up to ``--max-prefill`` prefill lanes, interpreted from the
schedule IR's serve table over ``--pipe`` stages (all on one device)
with ``--pages`` KV pages of ``--page-seq`` positions.  ``--engine
simple`` serves each request on its own through the whole-model
``SimpleEngine``: prefill in one causal call, then token by token.
``--engine auto`` (the default) picks simple for hybrid and
encoder-decoder models, whose decode state the stage split cannot page,
and pipelined otherwise.
``--execution mpmd`` runs the pipelined engine stage-locally: one
process per stage (``launch/mesh.py``), rank 0 owning the batcher and
printing the summary, every rank a ``# rank`` line with its waves,
lanes, kernel launches and transfers; the transport (NCCL with a card
per rank, gloo through pinned host buffers when ranks share one, gloo
on the CPU) is printed.  Hybrid models are refused under it.  On
the card every attention call goes through the hand-written flash
forward kernel (the decode wave through its paged rows) and every
RWKV-6 or Mamba-2 recurrence through its hand-written scan kernel.
``--arch`` takes granite-8b, granite-20b and starcoder2-15b (dense),
minicpm3-4b (dense with multi-head latent attention: the caches hold
latents, expanded per call; the flash kernels at q.k width 96 and v
width 64), deepseek-moe-16b and grok-1-314b (MoE: every token routed
alone, as the JAX engines' one-token decode steps route it),
pixtral-12b (dense, its vision frontend unused by text prompts),
rwkv6-7b (attention-free),
zamba2-1.2b (Mamba-2 with shared attention blocks), and the
encoder-decoder whisper-base and transformer-paper (the decoder with
cross-attention over a zero cross cache, as the JAX SimpleEngine serves
them: the encoder never runs).

Unlike the JAX launcher, which always shrinks the model, this one
serves the full configuration unless ``--smoke`` is given.  It runs on
the card unless ``--device cpu`` is given; on a machine without a card,
``--device cuda`` (the default) fails.

The summary's ``compile`` is the engine's warm-up (kernel build and
one round, or one prefill and one decode), whose tokens are not
counted; its tok/s is over the whole ``run()``, warm-up included, as
the JAX launcher's (the pipelined engine's ``serve/decode_tok_per_s``
is over its rounds alone).  ``--metrics-out`` appends the scheduler's
admit/decode/evict events (pipelined) or the per-request events
(simple), the per-token latency histogram and the summary record as
JSONL.

Example (full-width granite-8b, or rwkv6-7b, on one H100):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --pipe 4 --slots 8 --requests 24 --rate 2.0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --engine simple
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional, Tuple

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import Model
from repro_torch.obs import MetricsRegistry
from repro_torch.planner import serve_plan
from repro_torch.serve import ServeEngine, SimpleEngine, poisson_trace


def _pair(s: str):
    lo, hi = (int(x) for x in s.split(","))
    return lo, hi


def main(argv=None, *, ranks_out: Optional[list] = None) -> int:
    """``ranks_out``, if given, receives each rank's report under
    ``--execution mpmd`` (a library hook: ``chip_smoke.py`` reads the
    tokens, launches and transfers through it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b",
                    help="granite-8b, granite-20b, starcoder2-15b, "
                         "minicpm3-4b, pixtral-12b, deepseek-moe-16b, "
                         "grok-1-314b, rwkv6-7b, zamba2-1.2b, whisper-base "
                         "or transformer-paper")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced smoke config of --arch")
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "pipelined", "simple"),
                    help="'pipelined' runs rounds through the schedule "
                         "IR; 'simple' serves each request through the "
                         "whole-model decode_step; 'auto' picks "
                         "pipelined except for hybrid and enc-dec archs")
    ap.add_argument("--pipe", type=int, default=2,
                    help="pipeline stages the serving rounds fold over "
                         "(pipelined engine)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--execution", default="spmd", choices=("spmd", "mpmd"),
                    help="pipelined engine: 'spmd' runs every stage in "
                         "this process, 'mpmd' one process per stage")
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
    ap.add_argument("--slots", type=int, default=4,
                    help="live-request slots (decode wave width)")
    ap.add_argument("--max-prefill", type=int, default=2,
                    dest="max_prefill",
                    help="prompts admitted per round (prefill lanes)")
    ap.add_argument("--pages", type=int, default=0,
                    help="KV pages per stage (default: --slots)")
    ap.add_argument("--max-rounds", type=int, default=0,
                    dest="max_rounds",
                    help="abort if the trace does not drain in this "
                         "many rounds (0: auto bound)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="", dest="metrics_out",
                    help="append per-request events, latency histograms "
                         "and the summary record as JSONL to this path")
    ap.add_argument("--tensor", type=int, default=1,
                    help="the mesh's tensor axis: serving runs 1 (larger "
                         "is refused)")
    args = ap.parse_args(argv)
    if args.tensor != 1:
        raise SystemExit(
            f"unsupported combination: --tensor {args.tensor} with serving "
            f"— the serving engines' decode caches and rounds are not split "
            f"over tensor ranks (the JAX package's decode_rules and "
            f"cache_specs over tensor are not ported to them); supported "
            f"alternative: --tensor 1 (with --pipe), or training with "
            f"python -m repro_torch.launch.train --tensor {args.tensor}")

    registry = MetricsRegistry(jsonl_path=args.metrics_out or None)
    try:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = smoke_config(cfg)
        if args.layers:
            cfg = cfg.replace(n_layers=args.layers)
        unpaged = cfg.is_encdec or (cfg.ssm is not None
                                    and cfg.ssm.shared_attn_every > 0)
        engine_kind = args.engine
        if engine_kind == "auto":
            engine_kind = "simple" if unpaged else "pipelined"
        if engine_kind == "pipelined":
            if unpaged:
                raise SystemExit(
                    f"--engine pipelined cannot serve {cfg.name}: hybrid/"
                    f"enc-dec decode state is not per-layer pageable; use "
                    f"--engine simple (or auto)")
            # the weights come split as the plan's stages (no regrouping)
            cfg = cfg.replace(mesh_plan=dataclasses.replace(
                cfg.mesh_plan, pipe=args.pipe, tensor=1))
        if args.execution == "mpmd" and engine_kind != "pipelined":
            raise SystemExit(
                f"unsupported combination: --execution mpmd with the "
                f"simple engine ({cfg.name}) — stage-local execution runs "
                f"the pipelined engine's serve streams, which cannot page "
                f"a hybrid or enc-dec model's decode state; supported "
                f"alternative: "
                f"--execution spmd, or --engine pipelined for a dense or "
                f"rwkv6 --arch")
        if engine_kind == "pipelined":
            splan = serve_plan(cfg, n_stages=args.pipe, n_slots=args.slots,
                               max_prefill=args.max_prefill,
                               prompt_budget=args.prompt_budget,
                               n_pages=args.pages or None,
                               page_seq=args.page_seq)
        else:
            # the simple engine serves one request at a time
            splan = serve_plan(cfg, n_stages=1, n_slots=1, max_prefill=1,
                               prompt_budget=args.prompt_budget,
                               page_seq=args.page_seq, validate=False)
        trace = poisson_trace(
            args.requests, rate=args.rate, seed=args.seed,
            prompt_lens=args.prompt_lens, gen_lens=args.gen_lens,
            vocab=cfg.vocab_size)
        print(f"# {splan.summary()}")
        if args.execution == "mpmd":
            from repro_torch.launch.mesh import run_stage_ranks
            registry.close()
            outs = run_stage_ranks(_serve_rank, args.pipe, args.device,
                                   args=(args, cfg, splan, trace))
            if ranks_out is not None:
                ranks_out.extend(outs)
            return outs[0]["rc"]
        model = Model(cfg, device=args.device)
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = model.init(gen, dtype=cfg.compute_dtype)
        if engine_kind == "pipelined":
            engine = ServeEngine(model, params, splan, registry=registry)
        else:
            engine = SimpleEngine(model, params, splan, registry=registry)
        del params
        return _serve(engine, trace, args, cfg, registry, engine_kind,
                      "scan" if engine_kind == "pipelined" else "eager")[0]
    finally:
        registry.close()


def _serve(engine, trace, args, cfg, registry, engine_kind: str,
           execution: str) -> Tuple[int, dict]:
    """Drive ``trace`` through ``engine`` and print (and record) the
    summary.  Returns ``(0, {rid: tokens})``."""
    device_name = (torch.cuda.get_device_name(engine.device)
                   if engine.device.type == "cuda" else "cpu")
    print(f"# arch={cfg.name} engine={engine_kind} execution={execution} "
          f"device={device_name} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} "
          f"dtype={cfg.compute_dtype} requests={len(trace)} "
          f"rate={args.rate} seed={args.seed}")
    t0 = time.time()
    if engine_kind == "pipelined":
        results = engine.run(trace, max_rounds=args.max_rounds or None)
    else:
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
        "serve_run", arch=cfg.name, engine=engine_kind,
        execution=execution, device=device_name,
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
    return 0, results


def _serve_rank(group, args, cfg, splan, trace) -> dict:
    """One stage rank of ``--execution mpmd``: its part of the model the
    SPMD run draws from ``--seed`` (``launch.mesh.draw_rank_part``).
    Rank 0 serves the trace and prints the summary; every rank prints
    its ``# rank`` line.  Returns the rank's report:
    ``rc``, the results (rank 0), the run's wall, its kernel launches
    and the transport counters."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import draw_rank_part
    model = Model(cfg, device=group.device)
    params = draw_rank_part(model, splan.stage_sizes, args.seed, group,
                            dtype=cfg.compute_dtype)
    lead = group.rank == 0
    registry = MetricsRegistry(jsonl_path=(args.metrics_out or None)
                               if lead else None)
    try:
        engine = ServeEngine(model, params, splan, backend="mpmd",
                             group=group, registry=registry)
        del params
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
        if lead:
            print(f"# mpmd: {group.describe()}; "
                  f"transport={group.transport}", flush=True)
        engine._warm_up()
        group.reset_counters()
        c0 = ops.launch_counts()
        t0 = time.time()
        if lead:
            rc, results = _serve(engine, trace, args, cfg, registry,
                                 "pipelined", "mpmd")
        else:
            rc, results = 0, engine.run(trace)
        wall_s = time.time() - t0
        launches = {k: v - c0.get(k, 0)
                    for k, v in ops.launch_counts().items()}
        rep = {"rank": group.rank, "rc": rc, "results": results,
               "wall_s": wall_s, "launches": launches,
               "n_waves": engine.n_waves, "n_lanes": engine.n_lanes,
               "round_ms": list(engine.round_ms),
               **group.counters()}
        print(f"# rank {group.rank}: waves={engine.n_waves} "
              f"lanes={engine.n_lanes} launches={launches} sent="
              f"{group.n_sent} ({group.bytes_sent} B) recv={group.n_recv} "
              f"transport={group.transport_s:.3f}s", flush=True)
        return rep
    finally:
        registry.close()


if __name__ == "__main__":
    raise SystemExit(main())
