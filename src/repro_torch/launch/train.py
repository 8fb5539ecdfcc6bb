"""Training launcher for the port (twin of ``repro/launch/train.py``,
restricted to what is ported).

Runs the streaming SpecTrain pipeline (``--mode {vanilla,pipedream,
spectrain}``, ``--schedule stream``) or the synchronous GPipe baseline
(``--mode sync``) on one device, every attention forward and backward
through the hand-written flash kernels and every optimizer update
through the fused update kernel.  Stage sizes are the uniform split
(the JAX launcher with ``--partitioner uniform``); in place of the
planner's summary it prints the closed-form ``s_fwd`` / ``bwd_lag`` /
``fb_gap``.  Unlike the JAX launcher, which always shrinks the model,
this one trains the full configuration unless ``--smoke`` or the size
flags cut it.  It runs on the card unless ``--device cpu`` is given; on
a machine without a card, ``--device cuda`` (the default) fails.

``--ckpt-dir`` saves the whole train state every ``--save-every`` steps
on a background thread (one writer at a time) and once at the end;
``--resume auto`` restores the newest checkpoint there and continues
from the step after it.  The format is the JAX package's
(``runtime/checkpoint.py``).

``--data-kind uniform`` draws i.i.d. tokens; the default ``bigram``
builds ``[V, V]`` float64 tables, fine at smoke size but 19.3 GB each
at granite-8b's full vocabulary.

Example (full-width granite-8b, 8 layers in 4 stages, on one H100):
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --layers 8 --pipe 4 --batch 8 --seq 512 --dtype bfloat16 \\
        --mode spectrain --data-kind uniform --steps 10 --log-every 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core import pipeline_stream, pipeline_sync
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.data.pipeline import KINDS
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves
from repro_torch.obs import MetricsRegistry, format_step
from repro_torch.runtime import checkpoint as ckpt

SCHEDULES = ("stream", "gpipe", "1f1b", "2bw", "interleaved")


def build(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    kw = {}
    if args.layers:
        kw["n_layers"] = args.layers
    if args.d_model:
        kw["d_model"] = args.d_model
        kw["head_dim"] = max(8, args.d_model // cfg.n_heads)
        kw["d_ff"] = args.d_model * 4
    if args.vocab:
        kw["vocab_size"] = args.vocab
    kw["mesh_plan"] = dataclasses.replace(
        cfg.mesh_plan, pipe=args.pipe, tensor=1,
        num_microbatches=args.ticks)
    kw["param_dtype"] = "float32"
    kw["compute_dtype"] = args.dtype
    return cfg.replace(**kw)


def _not_ported(args) -> Optional[str]:
    if args.schedule != "stream":
        return (f"--schedule {args.schedule} is not ported to PyTorch yet "
                f"(the IR-interpreter schedules are a later slice); use "
                f"--schedule stream")
    for flag, on in (("--trace", args.trace),
                     ("--compress", args.compress)):
        if on:
            return f"{flag} is not ported to PyTorch yet"
    return None


def main(argv=None, *, on_step: Optional[Callable] = None) -> int:
    """``on_step(step_index, state, metrics)``, if given, is called after
    every train step (a library hook: ``chip_smoke.py`` reads the
    kernels' launch counts and the weights through it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0, dest="d_model")
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--pipe", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=1)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mode", default="spectrain",
                    choices=("sync",) + pipeline_stream.MODES)
    ap.add_argument("--schedule", default="stream", choices=SCHEDULES,
                    help="pipeline schedule; only 'stream' is ported")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--gamma", type=float, default=0.9)
    ap.add_argument("--clip", type=float, default=0.0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--data-kind", default="bigram", choices=KINDS,
                    dest="data_kind",
                    help="synthetic token stream (bigram tables are "
                         "[V, V] float64: use uniform at full vocabulary)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line per logged step")
    ap.add_argument("--metrics-out", default="", dest="metrics_out",
                    help="append structured JSONL telemetry (step records, "
                         "summary) to this path")
    ap.add_argument("--ckpt-dir", default="", dest="ckpt_dir")
    ap.add_argument("--save-every", type=int, default=20, dest="save_every")
    ap.add_argument("--resume", default="", choices=("", "auto"))
    # accepted so that the JAX launcher's command lines fail clearly
    ap.add_argument("--trace", default="")
    ap.add_argument("--compress", default="", choices=("", "topk", "int8"))
    args = ap.parse_args(argv)
    why = _not_ported(args)
    if why:
        raise SystemExit(why)

    cfg = build(args)
    model = Model(cfg, device=args.device)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed, kind=args.data_kind))
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    S = model.n_stages
    if args.mode != "sync":
        s_fwd, lag, gap = pipeline_stream._plan_vectors(S)
        print(f"# stream schedule (closed forms, uniform split "
              f"{pipeline_stream.stage_sizes(model)}): s_fwd={s_fwd} "
              f"bwd_lag={lag} fb_gap={gap}")

    registry = MetricsRegistry(jsonl_path=args.metrics_out or None)
    bg_save = None
    interrupted = False
    # the last step run, and the last one saved: the final save writes
    # only a state no save has written, under its own step
    ran = saved = None
    try:
        if args.mode == "sync":
            state = pipeline_sync.init_state(model, gen)
            step_fn = pipeline_sync.make_train_step(
                model, lr=args.lr, gamma=args.gamma,
                num_microbatches=cfg.mesh_plan.num_microbatches,
                clip=args.clip or None)
        else:
            state = pipeline_stream.init_state(
                model, gen, data.batch_at(0), mode=args.mode,
                ticks_per_step=max(args.ticks, 1))
            step_fn = pipeline_stream.make_train_step(
                model, mode=args.mode, lr=args.lr, gamma=args.gamma,
                clip=args.clip or None, ticks_per_step=max(args.ticks, 1))
        start = 0
        if args.resume == "auto" and args.ckpt_dir:
            last = ckpt.latest_step(args.ckpt_dir)
            if last is not None:
                state, last = ckpt.restore(args.ckpt_dir, state)
                start = last + 1
                print(f"# resumed from step {last}")
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        device_name = (torch.cuda.get_device_name(model.device)
                       if model.device.type == "cuda" else "cpu")
        print(f"# arch={cfg.name} params={n_params:,} mode={args.mode} "
              f"pipe={S} layers={cfg.n_layers} d_model={cfg.d_model} "
              f"dtype={cfg.compute_dtype} device={device_name} "
              f"opt_floor={data.optimal_loss():.4f}")

        t0 = time.time()
        tokens = 0
        for s in range(start, args.steps):
            state, metrics = step_fn(state, data.batch_at(s))
            ran = s
            tokens += args.batch * args.seq
            if on_step is not None:
                on_step(s, state, metrics)
            if args.ckpt_dir and (s + 1) % args.save_every == 0:
                if bg_save is not None:
                    bg_save.join()  # never two writers on the same dir
                bg_save = ckpt.save(args.ckpt_dir, state, s,
                                    background=True)
                saved = s
            if (s + 1) % args.log_every == 0 or s == args.steps - 1:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                rec = registry.log_step(
                    step=s + 1, loss=round(loss, 4),
                    tok_per_s=round(tokens / max(dt, 1e-9), 1),
                    loss_valid=float(metrics.get("loss_valid", 1.0)))
                print(json.dumps(rec) if args.json else format_step(rec))
    except KeyboardInterrupt:
        interrupted = True
        print("# interrupted -- metrics flushed")
    finally:
        registry.close()
        if bg_save is not None:
            bg_save.join()
    if args.ckpt_dir and not interrupted and ran != saved:
        ckpt.save(args.ckpt_dir, state, ran)
    return 1 if interrupted else 0


if __name__ == "__main__":
    raise SystemExit(main())
