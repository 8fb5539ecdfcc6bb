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
``--profile-method hlo`` counts one block on the meta device
(``planner/profiler.py``); ``--compress`` is refused, since the JAX
launcher parses it and reads it nowhere (``optim/compression.py`` is
ported as a library).

``--trace PATH`` instruments the run with a ``PipelineTracer``
(``repro_torch.obs``): one mark per compute event of a round schedule
(CUDA events on the card, the host clock on the CPU), one per
device-stream row and rank under ``--execution mpmd`` (the ranks'
tick durations gathered once a round), the step wall of the stream tick
attributed by ``probe_stage_costs``.  At the end it writes the Perfetto
trace (measured and IR-predicted lanes; rank 0 under MPMD) and prints
the drift report.  As in the JAX launcher it is refused with ``--mode
sync`` and with ``--pipe`` below 2.

``--execution mpmd`` runs a round schedule stage-locally: one process
per stage (``launch/mesh.py``), rank ``r`` on ``cuda:(r % cards)`` (or
the CPU with ``--device cpu``), activations and cotangents crossing the
stage cuts (NCCL when every rank has a card, gloo through pinned host
buffers when ranks share one, gloo on the CPU; the choice is printed).
Each rank draws the model from ``--seed`` as the SPMD run does (the
ranks in turn), keeps its part, and makes each batch itself; rank 0
prints the plan and the transport, the last chunk's rank the losses.  As in the JAX
launcher, ``--mode sync`` and ``--schedule stream`` are refused under
it, and so is ``--clip``.

``--ckpt-dir`` saves the whole train state every ``--save-every`` steps
on a background thread (one writer at a time) and once at the end;
``--resume auto`` restores the newest checkpoint there and continues
from the step after it.  The format is the JAX package's
(``runtime/checkpoint.py``).  Under ``--execution mpmd`` a save
gathers the state to rank 0, which writes the JAX package's packed MPMD
layout (``[v, S, Lmax, ...]`` stage leaves and ``chunk_sizes``); a
resume restores it on rank 0 and scatters it back.

``--data N`` (default 1) is the mesh's data axis: N replicas, one
process each (``launch/mesh.py``), under every mode and schedule: the
paper's Data-P baseline with ``--mode sync --pipe 1``, and with the
streaming tick or the round schedules the JAX package's GSPMD hybrid
(synchronous data parallelism across replicas, the pipeline's schedule
within each).  The plan is made once, here, and handed to every
replica.  Each replica holds every stage (drawn from ``--seed``; every
parameter leaf must be replicated over ``data``:
``runtime.sharding.check_data_replicated``; a config with ``fsdp`` is
refused), takes its block of every microbatch's rows
(``runtime.sharding.replica_rows``: a tick's or round microbatch's rows
split N ways, the whole batch's at one stage), runs the mode's step on
them and averages the gradients over the replicas before the update,
once a step (sync), a tick or a round, with ZeRO-1 momentum (the JAX
package's default layout): each replica holds its piece of every
momentum leaf, reduce-scatters the fp32 gradient, updates its pieces of
the weights, momentum and ŵ and all-gathers the weights and ŵ
(``StageGroup.reduce_scatter_mean`` / ``all_gather``: NCCL with a card
per replica, gloo through pinned host buffers when they share one, gloo
on the CPU; the choice is printed, and each rank prints the momentum
bytes it holds).  An MoE model's routing stays the whole microbatch's
(``models.moe.data_axis``).  Rank 0 prints the step lines (the loss the
mean of the replicas'), writes the checkpoints in the one-process
layout (the momentum gathered, the rings' rows gathered; every rank
restores the whole state and keeps its pieces, blocks and rows) and,
under ``--trace``, the trace with each step's reduction seconds.
Refused with ``--data`` > 1 (three-part messages): ``--execution mpmd``
(pure pipeline parallelism there, as in the JAX package), a ``--batch``
that N times the microbatches (``--ticks``, or the round size) does not
divide, and an MoE microbatch whose dispatch groups the replicas cannot
split whole.

``--tensor T`` (default 1) is the mesh's tensor axis, composable with
``--data N``: N·T processes, rank ``d·T + t`` (tensor innermost, as in
the JAX mesh).  The dense decoders (granite-8b, granite-20b,
starcoder2-15b and the paper's decoder-only configs) shard as the JAX
rules put ``heads``, ``kv``, ``mlp`` and ``vocab`` over ``tensor``
(Megatron-style: column-parallel ``wq`` / ``wk`` / ``wv`` / ``wg`` /
``w1`` and unembedding, row-parallel ``wo`` / ``w2``, a vocab-parallel
embedding and loss; ``models.tensor_axis``); each rank draws the model
from ``--seed`` as one process does and keeps its blocks.  The MoE
decoders split their routed experts (the routing replicated, each rank
dispatching to its ``E / T``) and shared experts' ``mlp``; rwkv6-7b
and zamba2-1.2b their heads (the scans at H / T heads; mamba2's
``w_zx`` held as its z and x blocks), zamba2's shared block as a dense
layer; minicpm3-4b its MLA heads.  Every mode and schedule runs (SPMD
only).  Refused in three parts: enc-dec and the vision frontend, an
expert or mamba2 head count T does not divide, ``--execution mpmd``.

``--arch`` takes the dense granite-8b, granite-20b, starcoder2-15b and
pixtral-12b (its text backbone: the data has no patches),
minicpm3-4b (multi-head latent attention, tied embeddings: ``embed/tok``
takes the head's and the embedding's gradient), the MoE
deepseek-moe-16b and grok-1-314b (and the paper's decoder-only configs);
for an MoE model each step line adds ``aux``, the routers' load-balance
loss included in ``loss`` (the stream tick's: over its valid stages'
forwards; the IR rounds leave it out of the loss, as the JAX twin's do,
and print none), and the SSM families: rwkv6-7b (RWKV-6) and the
zamba2-1.2b hybrid (Mamba-2 with a tied shared attention block a
stage), their scans differentiable through the backward kernels, on the
stream tick, the round schedules (interleaved refused for zamba2, whose
shared blocks are tied per device, as in the JAX launcher), ``--mode
sync`` and, for rwkv6-7b only, ``--execution mpmd``.  The
encoder-decoder whisper-base and transformer-paper are refused (no
frames or source tokens in the data, no pipeline stages: ``Model.loss``
trains them).

``--data-kind uniform`` draws i.i.d. tokens; the default ``bigram``
builds ``[V, V]`` float64 tables, fine at smoke size but 19.3 GB each
at granite-8b's full vocabulary.

Example (full-width granite-8b, 8 layers in 4 stages, on one H100; the
same for minicpm3-4b or rwkv6-7b at --layers 8, deepseek-moe-16b or
granite-20b at --layers 4, zamba2-1.2b at its 38 layers in --pipe 2):
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
from repro_torch.models import Model, moe
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.obs import (MetricsRegistry, PipelineTracer, drift_report,
                             format_drift, format_step, probe_stage_costs,
                             write_trace)
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
        cfg.mesh_plan, pipe=args.pipe, tensor=getattr(args, "tensor", 1),
        num_microbatches=args.ticks)
    kw["param_dtype"] = "float32"
    kw["compute_dtype"] = args.dtype
    return cfg.replace(**kw)


def _aux_field(metrics) -> dict:
    """The step record's ``aux`` (an MoE model's load-balance loss, the
    part of ``loss`` that the router adds), or nothing for the other
    models and for the IR rounds, whose loss leaves it out as the JAX
    twin's does."""
    if "aux" not in metrics:
        return {}
    return {"aux": round(float(metrics["aux"]), 6)}


def _not_ported(args) -> Optional[str]:
    """``--compress``: the JAX launcher parses it (``repro/launch/
    train.py:103``) and reads it nowhere, so no run of the reference
    compresses anything; refused here rather than accepted and ignored.
    The compressors themselves are ported as a library
    (``optim/compression.py``)."""
    if args.compress:
        return (f"--compress {args.compress} does nothing in the JAX "
                f"launcher either: it parses the flag (repro/launch/"
                f"train.py:103) and reads it nowhere, so no training run "
                f"compresses its gradients; the compressors are ported as "
                f"a library (repro_torch.optim.compression: topk_compress, "
                f"int8_roundtrip) for a step that calls them; run without "
                f"--compress")
    return None


def _mpmd_refusal(args) -> Optional[str]:
    """The JAX launcher's gates on ``--execution mpmd``, each in the
    three-part form: the combination, why, and what runs instead."""
    if args.execution != "mpmd":
        return None
    rounds = "/".join(pipeline_stream.IR_SCHEDULES)
    if args.mode == "sync":
        return str(pipeline_stream._unsupported(
            "--execution mpmd with --mode sync",
            f"--execution mpmd runs IR round schedules ({rounds}), not the "
            f"synchronous fill/drain baseline",
            "--execution spmd --mode sync, or --execution mpmd with "
            "--schedule gpipe"))
    if args.schedule == "stream":
        return str(pipeline_stream._unsupported(
            "--execution mpmd with --schedule stream",
            f"the streaming tick runtime keeps every stage's rings in one "
            f"state; stage-local execution runs IR round schedules "
            f"({rounds})",
            "--execution spmd --schedule stream, or --execution mpmd "
            "with a round schedule"))
    if args.clip:
        return str(pipeline_stream._unsupported(
            "--execution mpmd with --clip",
            "the global norm's canonical-order reduction is not "
            "bit-reproducible on the packed stage layout",
            "--execution spmd with --clip, or --execution mpmd without it"))
    return None


def _hybrid_refusal(args, model, execution: str) -> Optional[str]:
    """A hybrid model's gates, in the three-part form: its shared block
    is tied per stage, so no virtual stages and no stage-local layout
    (the JAX package refuses both)."""
    if not model.hybrid:
        return None
    U = pipeline_stream._unsupported
    if args.virtual_stages > 1:
        return str(U(
            f"--virtual-stages {args.virtual_stages} with the hybrid "
            f"{model.cfg.name}",
            "its shared block is tied across a device's chunks and "
            "independent chunk updates would fork it",
            "--schedule gpipe, 1f1b, 2bw or stream"))
    if execution == "mpmd":
        return str(U(
            f"--execution mpmd with the hybrid {model.cfg.name}",
            "per-stage 'shared' blocks have no flat layer order to pack "
            "into the [v, S, Lmax] stage-local layout",
            "--execution spmd"))
    return None


def _ir_round(args) -> bool:
    return args.mode != "sync" and \
        args.schedule in pipeline_stream.IR_SCHEDULES


def _microbatches(args) -> int:
    """The microbatches a step cuts the global batch into: the round
    size for a round schedule, else ``--ticks``."""
    if _ir_round(args):
        return round_size(args.schedule, args.batch, args.pipe,
                          args.virtual_stages, args.ticks)
    return max(args.ticks, 1)


def _data_refusal(args) -> Optional[str]:
    """The gates on ``--data N`` > 1, each in the three-part form."""
    N = args.data
    if N < 1:
        return f"--data {N}: the data axis needs at least one replica"
    if N == 1:
        return None
    U = pipeline_stream._unsupported
    if args.execution == "mpmd":
        return str(U(
            f"--data {N} with --execution mpmd",
            "mpmd runs pure pipeline parallelism; data/tensor axes belong "
            "to the SPMD path (the JAX package's _mpmd_mesh refuses every "
            "non-pipe mesh axis of size > 1)",
            f"--execution spmd --data {N}, or --execution mpmd with "
            f"--data 1"))
    M = _microbatches(args)
    per = N * M
    if args.batch % per:
        if _ir_round(args):
            combo = (f"--data {N} with --schedule {args.schedule} and "
                     f"--batch {args.batch}")
            unit = f"the round's {M} microbatches"
        else:
            combo = (f"--data {N} with --batch {args.batch} and --ticks "
                     f"{args.ticks}")
            unit = f"{M} microbatch{'es' if M > 1 else ''}"
        return str(U(
            combo,
            f"the step cuts the batch into {unit} and each replica takes "
            f"B / ({N}·{M}) rows of every one, so {per} must divide "
            f"--batch",
            f"a --batch that is a multiple of {per}"))
    return None


def _tensor_refusal(args, cfg) -> Optional[str]:
    """The gates on ``--tensor T`` > 1, each in the three-part form: the
    model kinds whose layers the port does not split over tensor ranks
    (``runtime.sharding.tensor_refusal``: the encoder-decoder, the vision
    frontend, widths T does not divide) and stage-local execution."""
    T = args.tensor
    if T < 1:
        return f"--tensor {T}: the tensor axis needs at least one rank"
    if T == 1:
        return None
    if args.execution == "mpmd":
        return str(pipeline_stream._unsupported(
            f"--tensor {T} with --execution mpmd",
            "mpmd runs pure pipeline parallelism; data/tensor axes belong "
            "to the SPMD path (the JAX package's _mpmd_mesh refuses every "
            "non-pipe mesh axis of size > 1)",
            f"--execution spmd --tensor {T}, or --execution mpmd with "
            f"--tensor 1"))
    from repro_torch.runtime import sharding as rsh
    return rsh.tensor_refusal(cfg, T)


def _forward_units(args, n_stages: int) -> int:
    """The forward units a step cuts the global batch into, each split
    over the data replicas (``runtime.sharding.replica_rows``): the
    round's microbatches, the ticks, or the sync pipeline's
    microbatches; the whole batch when one stage forwards it at once
    (the tick and sync at ``--pipe 1``)."""
    if n_stages == 1 and not _ir_round(args):
        return 1
    return _microbatches(args)


def _moe_split_refusal(args, model) -> Optional[str]:
    """An MoE model's gate on ``--data N`` > 1: the replicas must split
    each forward's dispatch groups whole (``models.moe.split_refusal``)."""
    units = _forward_units(args, model.n_stages)
    return moe.split_refusal(model.cfg, args.batch // units, args.seq,
                             args.data)


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
          f"(uniform would be {pplan.uniform_bottleneck_s:.2e}s; profile "
          f"{getattr(pplan.profile, 'method', None)})")
    if ir_round:
        print(f"# schedule {pplan.schedule}: "
              f"round={pplan.round_microbatches} microbatches, "
              f"bubble={pplan.bubble_frac:.3f}, "
              f"act_stash={pplan.act_stash}, "
              f"w_stash_depth={pplan.w_stash_depth}")


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags."""
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
                         "('timed' runs one block on --device, 'hlo' "
                         "counts one on the meta device)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--data", type=int, default=1,
                    help="the mesh's data axis: N replicas, one process "
                         "each")
    ap.add_argument("--tensor", type=int, default=1,
                    help="the mesh's tensor axis: T ranks a replica, one "
                         "process each (heads, KV heads, MLP and "
                         "vocabulary sharded)")
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
    ap.add_argument("--trace", default="",
                    help="write a Perfetto/Chrome trace JSON (per-device "
                         "measured + IR-predicted lanes) to this path and "
                         "print the predicted-vs-measured drift report")
    # accepted so that the JAX launcher's command lines fail clearly
    ap.add_argument("--compress", default="", choices=("", "topk", "int8"))
    return ap.parse_args(argv)


def run_plan(args, cfg, device):
    """The plan of the schedule the run executes (gpipe for the sync
    fill/drain pipeline), checked against the closed forms: its
    partition is executed, the runtimes regroup the stage weights by its
    layer ranges.  Returns ``(plan, ir_round)``."""
    schedule = "gpipe" if args.mode == "sync" else args.schedule
    ir_round = _ir_round(args)
    plan_kw = {}
    if ir_round:
        plan_kw["n_microbatches"] = _microbatches(args)
    pplan = make_plan(
        cfg, n_stages=Model(cfg, device="cpu").n_stages, schedule=schedule,
        virtual_stages=args.virtual_stages, partitioner=args.partitioner,
        profile_method=args.profile_method, batch=args.batch, seq=args.seq,
        device=device, **plan_kw)
    check_against_closed_forms(pplan)
    return pplan, ir_round


def main(argv=None, *, on_step: Optional[Callable] = None) -> int:
    """``on_step(step_index, state, metrics)``, if given, is called after
    every train step (a library hook: ``chip_smoke.py`` reads the
    kernels' launch counts and the weights through it)."""
    args = parse_args(argv)
    why = _not_ported(args) or _data_refusal(args) or _mpmd_refusal(args)
    if why:
        raise SystemExit(why)
    if args.mode == "sync" and args.schedule != "stream":
        raise SystemExit(
            f"--mode sync runs the fill/drain pipeline and cannot honor "
            f"--schedule {args.schedule}; drop one of the two flags")
    if args.trace and args.mode == "sync":
        raise SystemExit("--trace instruments the streaming/IR runtimes; "
                         "--mode sync is not traceable")
    if args.trace and args.pipe < 2:
        raise SystemExit("--trace needs a real pipeline (--pipe >= 2)")
    if args.virtual_stages > 1 and args.schedule != "interleaved":
        raise SystemExit(
            f"--virtual-stages {args.virtual_stages} requires "
            f"--schedule interleaved, got --schedule {args.schedule}")
    rc = runtime_config_from_args(args, ticks_per_step=max(args.ticks, 1))

    cfg = build(args)
    why = _tensor_refusal(args, cfg)
    if why:
        raise SystemExit(why)
    if cfg.is_encdec:
        raise SystemExit(
            f"{cfg.name} is an encoder-decoder model, which this launcher "
            f"cannot train: its data yields tokens and targets only (no "
            f"frames or source tokens), and the pipeline runtimes take "
            f"per-stage trees, which the {{'enc', 'dec'}} stacks are not "
            f"(the JAX launcher cannot either); train it through "
            f"Model.loss and optim.sgd")
    model = Model(cfg, device=args.device)
    why = _hybrid_refusal(args, model, rc.execution) or (
        _moe_split_refusal(args, model) if args.data > 1 else None)
    if why:
        raise SystemExit(why)
    pplan, ir_round = run_plan(args, cfg, model.device)
    _print_plan(pplan, ir_round)
    if args.data > 1 or args.tensor > 1:
        from repro_torch.launch.mesh import run_stage_ranks
        _print_data_axis(args, cfg, model, ir_round)
        outs = run_stage_ranks(_train, args.data * args.tensor, args.device,
                               args=(args, cfg, pplan, ir_round, rc,
                                     on_step))
        return max(outs)
    if rc.execution == "mpmd":
        from repro_torch.launch.mesh import run_stage_ranks
        outs = run_stage_ranks(_mpmd_rank, model.n_stages, args.device,
                               args=(args, cfg, pplan, rc, on_step))
        return max(outs)
    return _train(None, args, cfg, pplan, ir_round, rc, on_step)


def _train(group, args, cfg, pplan, ir_round: bool, rc, on_step) -> int:
    """The training loop of one process (``group`` None) or of one rank
    of the ``(data, tensor)`` grid of ``--data N --tensor T`` (``group``:
    the world's ``StageGroup``, made a grid here: ``group.data`` the
    rank's replicas, ``group.tensor`` its tensor ranks).  A rank draws
    the whole model from ``--seed`` as the one process does and keeps
    its tensor blocks, runs the mode's step on its replica's rows of
    every global batch with the gradients averaged over the replicas
    (ZeRO-1: its piece of the momentum), and restarts its peak-memory
    statistics once the state is built; rank 0 prints, logs, traces and
    writes the checkpoints.  ``on_step(step_index, state, metrics)``
    runs in every process with its state (under ``--data`` or
    ``--tensor`` it must pickle); ``metrics["loss"]`` is the process's
    own."""
    from repro_torch.runtime import sharding as rsh
    dgrp = tgrp = None
    if group is not None:
        rsh.init_grid(group, args.data, args.tensor)
        dgrp, tgrp = group.data, group.tensor
    n = 1 if group is None else dgrp.world
    lead = group is None or group.rank == 0
    model = Model(cfg, device=args.device if group is None
                  else group.device)
    dev = model.device
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed, kind=args.data_kind))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    units = _forward_units(args, model.n_stages)
    tblock = None if tgrp is None else (tgrp.rank, tgrp.world)
    tracer = None
    if args.mode == "sync":
        state = pipeline_sync.init_state(model, gen, data=dgrp,
                                         tensor=tblock)
        sync_step = pipeline_sync.make_train_step(
            model, lr=args.lr, gamma=args.gamma,
            num_microbatches=cfg.mesh_plan.num_microbatches,
            clip=args.clip or None, group=dgrp, tensor=tgrp)

        def step_fn(state, batch):
            if n > 1:
                batch = rsh.replica_rows(batch, units, dgrp.rank, n)
            return sync_step(state, batch)
    else:
        if args.trace and lead:
            tracer = PipelineTracer(pplan, device=dev)
        rt = Runtime(pplan, model, rc, tracer=tracer, data=dgrp,
                     tensor=tgrp)
        state = rt.init_state(model.init(gen, tensor=tblock),
                              data.batch_at(0))
        if tracer is not None and not ir_round:
            # the fused tick is not separable per stage: probe each
            # stage's cost alone (PipeDream-style) for the per-device
            # attribution in the trace and the drift report
            tracer.set_probed(probe_stage_costs(
                model, state["params"]["stages"],
                mb=max(1, args.batch // (max(args.ticks, 1) * n)),
                seq=args.seq))
        step_fn = rt.train_step
    if group is not None and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    dims = None if tgrp is None else rsh.tensor_leaf_dims(cfg, model,
                                                          tgrp.world)

    def save(s: int, background: bool = False):
        if group is None:
            return ckpt.save(args.ckpt_dir, state, s, background=background)
        return ckpt.save_data(args.ckpt_dir, state, s, dgrp,
                              background=background, tensor=tgrp,
                              tensor_dims=dims)

    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, last = (ckpt.restore(args.ckpt_dir, state)
                           if group is None else
                           ckpt.restore_data(args.ckpt_dir, state, dgrp,
                                             step=last, tensor=tgrp,
                                             tensor_dims=dims))
            start = last + 1
            if lead:
                print(f"# resumed from step {last}")
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    if lead:
        device_name = (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")
        print(f"# arch={cfg.name} params={n_params:,} mode={args.mode} "
              f"pipe={model.n_stages} layers={cfg.n_layers} "
              f"d_model={cfg.d_model} dtype={cfg.compute_dtype} "
              f"device={device_name} "
              f"opt_floor={data.optimal_loss():.4f}")
    if group is not None:
        from repro_torch.optim import sgd
        if lead:
            print(f"# data: {group.describe()}; transport="
                  f"{group.transport}")
        b = args.batch // (units * n)
        mom = sum(v.numel() * 4 for v in tree_leaves(state["momentum"]))
        zero1 = n > 1 and sgd.is_shard(state["params"], state["momentum"])
        where = (f"tensor rank {tgrp.rank} of replica {dgrp.rank}"
                 if tgrp is not None else f"replica {dgrp.rank}")
        print(f"# {where}: device={dev} rows "
              f"[{dgrp.rank * b}:{(dgrp.rank + 1) * b}) of each of "
              f"{units} unit{'s' if units > 1 else ''} of "
              f"{args.batch // units} rows; params {n_params:,}; momentum "
              f"{mom:,} B held ({'its ZeRO-1 pieces' if zero1 else 'whole'}"
              f"); ready {time.perf_counter() - group.t0:.1f} s after "
              f"joining", flush=True)

    registry = MetricsRegistry(jsonl_path=(args.metrics_out or None)
                               if lead else None)
    bg_save = None
    interrupted = False
    # the last step run, and the last one saved: the final save writes
    # only a state no save has written, under its own step
    ran = saved = None
    reduce_s = []     # each step's reduction seconds, under --trace
    t0 = time.time()
    tokens = 0
    try:
        for s in range(start, args.steps):
            r0 = None if group is None else dgrp.reduce_s + dgrp.gather_s
            state, metrics = step_fn(state, data.batch_at(s))
            if r0 is not None:
                reduce_s.append(dgrp.reduce_s + dgrp.gather_s - r0)
            ran = s
            tokens += args.batch * args.seq
            if on_step is not None:
                on_step(s, state, metrics)
            if args.ckpt_dir and (s + 1) % args.save_every == 0:
                if bg_save is not None:
                    bg_save.join()  # never two writers on the same dir
                bg_save = save(s, background=True)
                saved = s
            if (s + 1) % args.log_every == 0 or s == args.steps - 1:
                vals = [float(metrics["loss"])] + (
                    [float(metrics["aux"])] if "aux" in metrics else [])
                if group is not None:   # the replicas' mean
                    vals = [sum(v) / n for v in
                            zip(*dgrp.all_gather_object(vals))]
                if lead:
                    dt = time.time() - t0
                    rec = registry.log_step(
                        step=s + 1, loss=round(vals[0], 4),
                        tok_per_s=round(tokens / max(dt, 1e-9), 1),
                        loss_valid=float(metrics.get("loss_valid", 1.0)),
                        **_aux_field({"aux": vals[1]} if len(vals) > 1
                                     else {}))
                    print(json.dumps(rec) if args.json else format_step(rec),
                          flush=True)
    except KeyboardInterrupt:
        interrupted = True
        print("# interrupted -- metrics flushed")
    finally:
        registry.close()
        if bg_save is not None:
            bg_save.join()
    if args.ckpt_dir and not interrupted and ran != saved:
        save(ran)
    if tracer is not None and tracer.n_steps():
        _report_trace(args.trace, tracer, reduce_s if group else None)
    return 1 if interrupted else 0


def _report_trace(path: str, tracer, reduce_s=None) -> None:
    """Write the trace and print its summary and the drift report (and,
    for a replica of ``--data``, each step's reduction seconds)."""
    write_trace(path, tracer)
    print(f"# trace written to {path} ({tracer.n_steps()} steps recorded)")
    if tracer.is_round:
        print(f"# trace rounds: {len(tracer.rounds)} filed, "
              f"{tracer.dropped_rounds} dropped, {len(tracer.metas)} "
              f"events a round")
    print(format_drift(drift_report(tracer)), flush=True)
    if reduce_s is not None:
        print(f"# trace data reductions (replica 0, host s a step, in the "
              f"step walls above): {[round(x, 6) for x in reduce_s]}",
              flush=True)


def _print_data_axis(args, cfg, model, ir_round: bool) -> None:
    """Check that every parameter leaf is replicated over ``data`` (else
    ``SystemExit`` with the three-part refusal) and print the grid the
    ranks run: the schedule, the data axis's reductions a step (ZeRO-1's
    reduce-scatter of the gradient and all-gather of the weights over
    the replicas; each rank prints the momentum bytes it holds) and the
    tensor axis's sharded leaves."""
    import math
    from repro_torch.runtime import sharding as rsh
    n, T = args.data, args.tensor
    mesh = rsh.data_mesh(n, T)
    axes, shapes = model.param_axes(), model.param_specs()
    try:
        leaves = rsh.check_data_replicated(cfg, axes, shapes, mesh)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    z = rsh.zero1_layout(cfg, axes, shapes, mesh)
    n_params = sum(math.prod(sp.shape) for sp in tree_leaves(shapes))
    # one reduction a sync step or round, one a tick
    per = max(args.ticks, 1) if (args.mode != "sync" and not ir_round
                                 and model.n_stages > 1) else 1
    if args.mode == "sync":
        what, when = "the sync step", "once a step"
    elif ir_round:
        what = f"the {args.schedule} round ({args.mode})"
        when = "once a round"
    else:
        what = f"the streaming tick ({args.mode})"
        when = "once a tick" if model.n_stages > 1 else "once a step"
    stat = (f"; an [{cfg.moe.num_experts}] fp32 expert-fraction mean a "
            f"MoE layer a forward" if cfg.moe is not None else "")
    grid = f"{n} replica{'s' if n > 1 else ''}"
    if T > 1:
        dims = rsh.tensor_leaf_dims(cfg, model, T)
        names: list = []
        tree_map(lambda path, _: names.append(path[-1]), shapes)
        split = sum(1 for name in names if name in dims)
        grid += (f" x {T} tensor ranks ({n * T} processes; {split} of "
                 f"{leaves} parameter leaves sharded over tensor: "
                 f"{', '.join(sorted(dims))}; the rest replicated)")
    line = (f"# grid: {grid}, every stage on each; {what}")
    if n > 1:
        line += (f"; gradients averaged {when}: {per} reduction(s) a step "
                 f"of {4 * n_params // T:,} B a rank, ZeRO-1 "
                 f"(reduce-scatter, the update on the replica's pieces, "
                 f"all-gather of the weights{' and pred' if args.mode == 'spectrain' else ''}"
                 f"){stat}; {leaves} parameter leaves replicated over data; "
                 f"ZeRO-1 momentum over data: {z['sharded']} of "
                 f"{z['leaves']} leaves, the rules' layout "
                 f"{z['zero1_bytes']:,} B a rank against "
                 f"{z['replicated_bytes']:,} B replicated")
    print(line)


def _mpmd_rank(group, args, cfg, pplan, rc, on_step) -> int:
    """One stage rank of ``--execution mpmd``: its part of the model the
    SPMD run draws from ``--seed`` (``launch.mesh.draw_rank_part``),
    then the training loop; saves and resumes go through rank 0.
    Peak-memory statistics restart once the state is built.
    ``on_step(step_index, state, metrics)`` runs on every rank with the
    rank's local state (it must pickle).  Under ``--trace`` every rank
    marks its rounds and rank 0 writes the trace."""
    from repro_torch.launch import mesh
    from repro_torch.runtime import sharding as rsh
    dev = group.device
    model = Model(cfg, device=dev)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed, kind=args.data_kind))
    tracer = PipelineTracer(pplan, device=dev) if args.trace else None
    rt = Runtime(pplan, model, rc, group=group, tracer=tracer)
    part = mesh.draw_rank_part(model, pplan.partition.sizes(), args.seed,
                               group)
    state = rt.init_state(part, data.batch_at(0))
    del part
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    head = rsh.head_rank(pplan.n_chunks, group.world)
    lead = group.rank == 0
    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        if ckpt.latest_step(args.ckpt_dir) is not None:
            state, last = ckpt.restore_mpmd(args.ckpt_dir, state, model,
                                            pplan, group)
            start = last + 1
            if lead:
                print(f"# resumed from step {last}")

    def save(s: int) -> None:
        ckpt.save_mpmd(args.ckpt_dir, state, s, model, pplan, group)

    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    if lead:
        print(f"# mpmd: {group.describe()}; transport={group.transport}")
    print(f"# rank {group.rank}: device={dev} params={n_params:,} chunks="
          f"{rsh.local_chunks(group.rank, pplan.n_chunks, group.world)} "
          f"ready {time.perf_counter() - group.t0:.1f} s after joining",
          flush=True)
    registry = MetricsRegistry(jsonl_path=(args.metrics_out or None)
                               if group.rank == head else None)
    t0, tokens, ran, saved = time.time(), 0, None, None
    try:
        for s in range(start, args.steps):
            state, metrics = rt.train_step(state, data.batch_at(s))
            ran = s
            tokens += args.batch * args.seq
            if on_step is not None:
                on_step(s, state, metrics)
            if args.ckpt_dir and (s + 1) % args.save_every == 0:
                save(s)
                saved = s
            if group.rank == head and ((s + 1) % args.log_every == 0
                                       or s == args.steps - 1):
                dt = time.time() - t0
                rec = registry.log_step(
                    step=s + 1, loss=round(float(metrics["loss"]), 4),
                    tok_per_s=round(tokens / max(dt, 1e-9), 1),
                    loss_valid=float(metrics.get("loss_valid", 1.0)))
                print(json.dumps(rec) if args.json else format_step(rec),
                      flush=True)
    finally:
        registry.close()
    if args.ckpt_dir and ran is not None and ran != saved:
        save(ran)
    if lead and tracer is not None and tracer.n_steps():
        _report_trace(args.trace, tracer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
