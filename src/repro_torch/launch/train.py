"""Training launcher for the port (twin of ``repro/launch/train.py``,
restricted to what is ported).

Runs the streaming pipeline (``--mode {vanilla,pipedream,spectrain}``,
``--schedule stream``), the round schedules through the IR interpreter
(``--schedule {gpipe,1f1b,2bw,interleaved}``, one flush round or 2BW
group per step; ``--virtual-stages v`` gives each device v chunk-stages
under ``interleaved``; ``--ir-backend {scan,unrolled}`` picks the round
body), or the synchronous GPipe baseline (``--mode sync``) on one
device, every attention forward and backward through the hand-written
flash kernels and every optimizer update through the fused update
kernel.  Every run is planned, as the JAX launcher plans it: a
``PipelinePlan`` for the schedule, with the stage split from
``--partitioner {dp,uniform}`` (default ``dp``) over a per-layer profile
(``--profile-method``, default ``analytic``; ``timed`` times one block
on the run's device), verified before the first step unless
``--no-verify``.  The round size of an IR schedule is ``--ticks`` when
given, else the largest divisor of ``--batch`` up to 2·pipe·v that the
schedule accepts.  It prints the plan (``# plan[...]``), the realized
stages and, for round schedules, the round size, bubble and stash
depths.  Unlike the JAX launcher, which always shrinks the model, this
one trains the full configuration unless ``--smoke`` or the size flags
cut it.  It runs on the card unless ``--device cpu`` is given; on a
machine without a card, ``--device cuda`` (the default) fails.
``--trace``, ``--compress``, ``--execution mpmd`` and
``--profile-method hlo`` are not ported yet and are refused.

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
        --schedule 1f1b --data-kind uniform --steps 10 --log-every 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import torch

from repro_torch.api import (Runtime, add_runtime_args,
                             runtime_config_from_args)
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import pipeline_stream, pipeline_sync
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.data.pipeline import KINDS
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves
from repro_torch.obs import MetricsRegistry, format_step
from repro_torch.planner import check_against_closed_forms
from repro_torch.planner import plan as make_plan
from repro_torch.runtime import checkpoint as ckpt


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
    for flag, on in (("--trace", args.trace),
                     ("--compress", args.compress),
                     ("--execution mpmd", args.execution == "mpmd"),
                     ("--profile-method hlo", args.profile_method == "hlo")):
        if on:
            return f"{flag} is not ported to PyTorch yet"
    return None


def round_size(schedule: str, batch: int, pipe: int, v: int,
               ticks: int) -> int:
    """The IR schedule's round size, by the JAX launcher's rule:
    ``ticks`` when it is > 1, else the largest divisor of ``batch`` up
    to 2·pipe·v that the schedule accepts (interleaved groups
    microbatches by pipe, 2bw needs m >= pipe for its two weight
    buffers).  Raises ``SystemExit`` when there is none."""
    def legal(M):
        if batch % M:
            return False
        if schedule == "interleaved":
            return M % pipe == 0
        if schedule == "2bw":
            return M >= pipe
        return True

    M = ticks if ticks > 1 else next(
        (c for c in range(min(2 * pipe * v, batch), 0, -1) if legal(c)), 0)
    if not M or not legal(M):
        raise SystemExit(
            f"no round size for --schedule {schedule}: need a divisor of "
            f"--batch {batch} that is "
            + ("a multiple of" if schedule == "interleaved" else "at least")
            + f" --pipe {pipe}" + (f" (got --ticks {M})" if M else ""))
    return M


def _print_plan(pplan, ir_round: bool) -> None:
    print(f"# {pplan.summary()}")
    stage_desc = " ".join(
        f"s{k}:L[{lo}:{hi})={c:.2e}s"
        for k, ((lo, hi), c) in enumerate(zip(pplan.stage_ranges,
                                              pplan.stage_costs_s)))
    print(f"# realized stages: {stage_desc}  "
          f"bottleneck={pplan.bottleneck_s:.2e}s "
          f"(uniform would be {pplan.uniform_bottleneck_s:.2e}s)")
    if ir_round:
        print(f"# schedule {pplan.schedule}: "
              f"round={pplan.round_microbatches} microbatches, "
              f"bubble={pplan.bubble_frac:.3f}, "
              f"act_stash={pplan.act_stash}, "
              f"w_stash_depth={pplan.w_stash_depth}")


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
    add_runtime_args(ap)
    ap.add_argument("--virtual-stages", type=int, default=1,
                    dest="virtual_stages",
                    help="chunks per device for --schedule interleaved")
    ap.add_argument("--partitioner", default="dp", choices=("dp", "uniform"),
                    help="stage-partition method for the planner")
    ap.add_argument("--profile-method", default="analytic",
                    choices=("auto", "hlo", "timed", "analytic"),
                    dest="profile_method",
                    help="per-layer cost acquisition for the planner "
                         "('timed' runs one block on --device)")
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
    if args.mode == "sync" and args.schedule != "stream":
        raise SystemExit(
            f"--mode sync runs the fill/drain pipeline and cannot honor "
            f"--schedule {args.schedule}; drop one of the two flags")
    if args.virtual_stages > 1 and args.schedule != "interleaved":
        raise SystemExit(
            f"--virtual-stages {args.virtual_stages} requires "
            f"--schedule interleaved, got --schedule {args.schedule}")
    rc = runtime_config_from_args(args, ticks_per_step=max(args.ticks, 1))

    cfg = build(args)
    model = Model(cfg, device=args.device)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed, kind=args.data_kind))
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    S = model.n_stages

    # the plan of the schedule this run executes (gpipe for the sync
    # fill/drain pipeline): its partition is executed, the runtimes
    # regroup the stage weights by its layer ranges
    schedule = "gpipe" if args.mode == "sync" else args.schedule
    ir_round = schedule in pipeline_stream.IR_SCHEDULES and \
        args.mode != "sync"
    plan_kw = {}
    if ir_round:
        plan_kw["n_microbatches"] = round_size(
            schedule, args.batch, args.pipe, args.virtual_stages,
            args.ticks)
    pplan = make_plan(
        cfg, n_stages=S, schedule=schedule,
        virtual_stages=args.virtual_stages, partitioner=args.partitioner,
        profile_method=args.profile_method, batch=args.batch, seq=args.seq,
        device=model.device, **plan_kw)
    check_against_closed_forms(pplan)
    _print_plan(pplan, ir_round)

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
            rt = Runtime(pplan, model, rc)
            state = rt.init_state(model.init(gen), data.batch_at(0))
            step_fn = rt.train_step
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
