"""Dry-run cost accounting of a cell: the port's twin of
``repro/launch/dryrun.py``.

The JAX dry-run lowers and compiles one step of a cell (an architecture
at one of :data:`repro_torch.configs.SHAPES`) on an abstract device mesh,
walks the compiled HLO (``runtime/hlo_cost.py``) and records the step's
FLOPs, bytes, collectives and memory beside the roofline terms.  This
twin lowers nothing: it builds the model on PyTorch's ``meta`` device
(shapes, no data, nothing allocated), runs one step of the cell on it
under ``runtime.op_cost.CostCounter`` and records the same keys.  The
kernel wrappers take their meta route there (their checks and
allocations, no launch) and record their ``cost()``; no card is
touched and no tensor memory is allocated, just as the JAX dry-run
compiles and never runs.  Where a key says "hlo"
(``hlo_flops_global``, ``hlo_bytes_global``) it means "counted" here;
there is no ``xla_cost``.

The steps counted:

* ``train``: the streaming tick (``core/pipeline_stream.py``:
  ``make_state`` / ``make_train_step``, ``--ticks`` ticks a step, with
  ``--fused-predict`` and ``--bwd-bf16``), or ``--runtime sync``
  (``core/pipeline_sync.py``);
* ``prefill``: ``Model.prefill`` of the whole prompt into a cache of the
  shape's length;
* ``decode``: one ``Model.decode_step`` at the cache's last position
  (every key of the cache attended), with the weights in bf16 under
  ``--serve-bf16``.

A cell runs ``--pipe P`` stages (default: the config's
``mesh_plan.pipe``) on one card, as ``launch/train.py`` does, and
``--data N`` replicas (default 1); ``chips`` is N.  A replica is counted
as the launcher runs it: its rows of every global batch, and ZeRO-1
(the JAX dry-run's ``zero1=True`` layout): the state holds its pieces of
the momentum (``runtime.sharding.shard_range``, the bytes of
``zero1_layout``) and its step runs the reduce-scatter of the fp32
gradient and the all-gathers of w (and ŵ on the spectrain tick) through
a data group that moves nothing and counts each call and its bytes as
``StageGroup`` does (:class:`CountingGroup`; 256 MiB buckets of
``shard_buckets``; the record's ``data_axis``).  The dry-run has no
tensor axis yet (ROADMAP §A.7).

The roofline uses one H100 (:data:`HW`, from the card's data sheet:
989 TFLOP/s bf16 and 67 fp32 dense, by the config's compute dtype; 3.35
TB/s of HBM; 450 GB/s of NVLink each way; 80 GB of HBM for ``fits``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out cells.jsonl

prints one JSON line a cell and exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import (SHAPES, MeshPlan, ShapeConfig, get_config,
                                 list_archs, shape_applicable, smoke_config)
from repro_torch.core import pipeline_stream, pipeline_sync
from repro_torch.models.layers import dtype_of, leaf_is_weight, \
    tree_leaves, tree_map
from repro_torch.models.model import Model, input_specs
from repro_torch.optim import sgd
from repro_torch.runtime.op_cost import CostCounter, ring_wire_bytes, \
    tree_bytes
from repro_torch.runtime.sharding import (BUCKET_BYTES, StageGroup,
                                          data_mesh, shard_buckets,
                                          shard_range, zero1_layout)

# one NVIDIA H100 SXM (80 GB HBM3): dense peak FLOP/s by compute dtype,
# HBM bytes/s, NVLink bytes/s each way, HBM bytes
HW = {"peak_flops": {"bfloat16": 989e12, "float32": 67e12},
      "hbm_bw": 3.35e12, "link_bw": 450e9, "hbm_bytes": 80e9}

META = torch.device("meta")


def _peak(cfg, hw) -> float:
    return hw["peak_flops"][cfg.compute_dtype]


def model_flops(cfg, shape) -> float:
    """Useful FLOPs per step: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill/decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token


def min_bytes(cfg, shape, cache_bytes: float = 0.0) -> float:
    """Unavoidable HBM traffic per step (global): weights read once per
    token-batch pass (+3x for train: grad write + momentum/update), and
    for decode the KV-cache/state read."""
    wbytes = cfg.active_param_count() * 2.0          # bf16 weights
    if shape.kind == "train":
        return 4.0 * cfg.param_count() * 2.0         # w, g, v, w'
    if shape.kind == "prefill":
        return wbytes
    return wbytes + cache_bytes                       # decode


def ideal_time(cfg, shape, n_chips: int, cache_bytes: float = 0.0,
               hw: Optional[Dict[str, Any]] = None) -> float:
    """Roofline-ideal step time: max of the compute floor and the
    unavoidable-memory floor (the right floor for decode), on ``hw``
    (default :data:`HW`)."""
    hw = HW if hw is None else hw
    tc = model_flops(cfg, shape) / (n_chips * _peak(cfg, hw))
    tm = min_bytes(cfg, shape, cache_bytes) / (n_chips * hw["hbm_bw"])
    return max(tc, tm)


# ---------------------------------------------------------------------------
# one cell on the meta device


def meta_params(model: Model, dtype: Optional[str] = None):
    """The model's parameters as meta tensors, shapes from
    ``param_specs`` (nothing drawn), in the param dtype; with ``dtype``
    the weights in it (the serving cast, ``leaf_is_weight``)."""
    cfg = model.cfg
    store = None if dtype is None else dtype_of(dtype)

    def leaf(path, spec):
        dt = dtype_of(spec.dtype or cfg.param_dtype)
        if store is not None and leaf_is_weight(path):
            dt = store
        return torch.empty(spec.shape, dtype=dt, device=META)

    return tree_map(leaf, model.param_specs())


def param_elements(model: Model) -> int:
    """The model's parameter count, from ``param_specs``."""
    return sum(math.prod(sp.shape)
               for sp in tree_leaves(model.param_specs()))


def _meta(specs):
    """Meta tensors for a tree (dicts) of ``input_specs``' ``ShapeDtype``s."""
    if isinstance(specs, dict):
        return {k: _meta(v) for k, v in specs.items()}
    return torch.empty(specs.shape, dtype=specs.dtype, device=META)


def cell_config(arch: str, *, smoke: bool = False,
                pipe: Optional[int] = None, layers: Optional[int] = None,
                ticks: Optional[int] = None, dtype: Optional[str] = None):
    """The cell's ``ArchConfig``: the registered config (``smoke``: the
    JAX dry-run's reduced one, 4 layers on 2 stages), cut to ``layers``,
    on ``pipe`` stages with ``ticks`` microbatches, computing in
    ``dtype``."""
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg).replace(
            n_layers=4, mesh_plan=MeshPlan(pipe=2, tensor=1,
                                           num_microbatches=2))
    plan = dataclasses.replace(cfg.mesh_plan, tensor=1)
    if pipe is not None:
        plan = dataclasses.replace(plan, pipe=pipe)
    if ticks is not None:
        plan = dataclasses.replace(plan, num_microbatches=ticks)
    kw: Dict[str, Any] = {"mesh_plan": plan}
    if layers is not None:
        kw["n_layers"] = layers
    if dtype is not None:
        kw["compute_dtype"] = dtype
    return cfg.replace(**kw)


class CountingGroup(StageGroup):
    """Replica ``rank`` of a data group of ``world`` that moves nothing:
    ZeRO-1's reduce-scatter leaves each piece as it is and the
    all-gathers leave the rest, while every call and its bytes are
    counted as :class:`~repro_torch.runtime.sharding.StageGroup`'s
    (``n_rs`` / ``bytes_rs``, ``n_ag`` / ``bytes_ag`` by the buckets of
    ``shard_buckets``; ``n_stat`` / ``bytes_stat``), so that a meta step
    counts the launcher's collectives exactly."""

    def __init__(self, rank: int, world: int, device=META):
        super().__init__(rank, world, torch.device(device), "gloo")

    def reduce_scatter_mean(self, leaves, *, bucket_bytes=BUCKET_BYTES):
        flats = [g.reshape(-1) for g in leaves]
        for width, _ in shard_buckets([f.numel() for f in flats],
                                      self.world, bucket_bytes // 4):
            self.n_rs += 1
            self.bytes_rs += 4 * self.world * width
        return [f[slice(*shard_range(f.numel(), self.rank, self.world))]
                for f in flats]

    def all_gather(self, leaves, *, bucket_bytes=BUCKET_BYTES) -> None:
        if not leaves:
            return
        el = leaves[0].element_size()
        for width, _ in shard_buckets([g.numel() for g in leaves],
                                      self.world, bucket_bytes // el):
            self.n_ag += 1
            self.bytes_ag += el * self.world * width

    def mean_stat(self, t: torch.Tensor) -> torch.Tensor:
        self.n_stat += 1
        self.bytes_stat += t.numel() * 4
        return t

    def all_reduce_scalar(self, t: torch.Tensor) -> torch.Tensor:
        self.n_stat += 1
        self.bytes_stat += t.numel() * t.element_size()
        return t


def make_train_step(model: Model, shape, *, runtime: str = "stream",
                    mode: str = "spectrain", ticks: int = 1,
                    fused_predict: bool = False, bwd_bf16: bool = False,
                    params=None, batch=None, data=None):
    """(state, step, batch) of one train step of ``model``: the stream
    runtime's ``ticks`` ticks or the sync step, on ``shape``'s
    ``global_batch`` rows, lr 1e-3; :func:`build_cell` counts one.
    ``params`` and ``batch`` default to meta tensors; given tensors on the
    card, the same code builds a real step there (``chip_smoke.py``
    counts one against the meta count).  ``data``: a replica's data
    group (:class:`CountingGroup`), with ZeRO-1 momentum pieces; the
    stream step then takes the global batch and cuts the replica's rows,
    the sync step takes the replica's rows, as the launcher's do."""
    if params is None:
        params = meta_params(model)
    if batch is None:
        batch = _meta(input_specs(model.cfg, shape)["batch"])
    if runtime == "stream":
        state = pipeline_stream.make_state(
            model, params, batch, mode=mode, ticks_per_step=ticks,
            fused_predict=fused_predict, data=data)
        step = pipeline_stream.make_train_step(
            model, mode=mode, lr=1e-3, ticks_per_step=ticks,
            bwd_dtype="bfloat16" if bwd_bf16 else None, data=data)
    elif runtime == "sync":
        mom = (sgd.init(params).v if data is None
               else sgd.init_shard(params, data.rank, data.world))
        state = {"params": params, "momentum": mom, "step": 0}
        step = pipeline_sync.make_train_step(
            model, lr=1e-3,
            num_microbatches=model.cfg.mesh_plan.num_microbatches,
            group=data)
    else:
        raise ValueError(f"unknown runtime {runtime!r}")
    return state, step, batch


def refused(args) -> Optional[str]:
    """The JAX dry-run's flags that have no meaning on one card, in the
    three-part form of ``launch/train.py``: the combination, why, and
    what runs instead."""
    _refusal = lambda *parts: str(pipeline_stream._unsupported(*parts))
    if args.multipod or args.both_meshes:
        flag = "--multipod" if args.multipod else "--both-meshes"
        return _refusal(
            f"{flag} on the port's dry-run",
            "the port's cells run on one H100 or on --data replicas, and "
            "there is no pod to span",
            "--data N for N replicas of the cell")
    if args.seq_shard or args.no_ring_tp:
        flag = "--seq-shard" if args.seq_shard else "--no-ring-tp"
        return _refusal(
            f"{flag} on the port's dry-run",
            "the port keeps the stream state's rings replicated, not "
            "sharded over tensor, and has no sequence sharding (ROADMAP "
            "§A.6)",
            "the cell without it (rings replicated, no sequence "
            "sharding)")
    if args.ssm_chunk:
        return _refusal(
            "--ssm-chunk on the port's dry-run",
            "the scans already run the chunked kernels (chunks of 64) at "
            "s >= 64 and the stepwise ones below",
            "the cell without it")
    return None


def build_cell(arch: str, shape: Union[str, ShapeConfig], *,
               runtime: str = "stream", mode: str = "spectrain",
               smoke: bool = False, pipe: Optional[int] = None,
               data: int = 1, layers: Optional[int] = None,
               dtype: Optional[str] = None, fused_predict: bool = False,
               bwd_bf16: bool = False, ticks: Optional[int] = None,
               serve_bf16: bool = False, by_op: bool = False
               ) -> Dict[str, Any]:
    """Count one step of a cell on the meta device (see the module note)
    and return its record.  ``shape`` is a name of :data:`SHAPES` or a
    ``ShapeConfig``; ``layers``, ``pipe``, ``ticks`` and ``dtype`` cut
    the config as ``launch/train.py``'s flags do; ``by_op`` adds each
    ATen op's count (``CostCounter.result()["by_op"]``)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name,
                           "mesh": f"{data}x1", "runtime": runtime,
                           "mode": mode}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", skip_reason=reason)
        return rec
    cfg = cell_config(arch, smoke=smoke, pipe=pipe, layers=layers,
                      ticks=ticks, dtype=dtype)
    if smoke:
        shape = ShapeConfig(shape.name, 64, 8, shape.kind)
    plan = cfg.mesh_plan
    n_ticks = ticks or plan.num_microbatches
    rec["opts"] = {"fused_predict": fused_predict, "bwd_bf16": bwd_bf16,
                   "ticks": n_ticks, "serve_bf16": serve_bf16}
    if data < 1 or shape.global_batch % data:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over --data {data}")
    model = Model(cfg, device=META)
    rec["chips"] = data
    rec["logical_mesh"] = {"data": data, "pipe": model.n_stages,
                           "tensor": 1}
    local = ShapeConfig(shape.name, shape.seq_len,
                        shape.global_batch // data, shape.kind)
    ins = input_specs(cfg, local)

    t0 = time.time()
    cache_bytes = 0.0
    group = None
    if shape.kind == "train":
        if runtime == "stream" and local.global_batch % n_ticks:
            raise ValueError(f"{local.global_batch} rows a replica do not "
                             f"split into {n_ticks} ticks")
        if data > 1:        # replica 0 under ZeRO-1, as the launcher's
            group = CountingGroup(0, data)
        state, step, batch = make_train_step(
            model, shape if group is not None and runtime == "stream"
            else local, runtime=runtime, mode=mode, ticks=n_ticks,
            fused_predict=fused_predict, bwd_bf16=bwd_bf16, data=group)
        args = (state, batch)
        with CostCounter() as counter:
            outs = step(state, batch)
    else:
        params = meta_params(model, "bfloat16" if serve_bf16 else None)
        with torch.no_grad():
            if shape.kind == "prefill":
                batch = _meta(ins["batch"])
                args = (params, batch)
                with CostCounter() as counter:
                    outs = model.prefill(params, batch, shape.seq_len)
            else:
                cache = model.init_cache(local.global_batch, shape.seq_len)
                cache_bytes = float(tree_bytes(cache)) * data
                token = _meta(ins["token"])
                args = (params, cache, token)
                with CostCounter() as counter:
                    outs = model.decode_step(params, cache, token,
                                             shape.seq_len - 1)
    rec["count_s"] = round(time.time() - t0, 2)
    hc = counter.result()
    mem = counter.memory(arguments=args, outputs=outs)
    coll = dict(hc["collectives"])
    wire = hc["wire_bytes"]
    if group is not None:
        c = group.counters()
        for kind, n, result in (
                ("reduce-scatter", c["n_rs"], c["bytes_rs"] / data),
                ("all-gather", c["n_ag"], c["bytes_ag"])):
            w = ring_wire_bytes(kind, result, data)
            coll[kind] = {"count": float(n), "result_bytes": float(result),
                          "wire_bytes": w}
            wire += w
        z = zero1_layout(cfg, model.param_axes(), model.param_specs(),
                         data_mesh(data))
        rec["data_axis"] = {
            **{k: c[k] for k in ("n_rs", "bytes_rs", "n_ag", "bytes_ag",
                                 "n_stat", "bytes_stat")},
            "momentum_bytes": tree_bytes(state["momentum"]),
            "zero1_bytes": z["zero1_bytes"],
            "replicated_bytes": z["replicated_bytes"]}
    rec.update(status="ok", memory=mem, collectives=coll,
               kernels=hc["kernels"])
    if by_op:
        rec["by_op"] = hc["by_op"]
    rec["wire_bytes_per_dev"] = wire
    rec["cost"] = {"flops": hc["flops"], "bytes_raw": hc["bytes"],
                   "bytes": hc["bytes_fused"],
                   "transcendentals": hc["transcendentals"],
                   "matmul_flops": hc["matmul_flops"]}
    per_dev = mem["argument_bytes"] + mem["temp_bytes"]
    rec["fits"] = per_dev <= HW["hbm_bytes"]

    # ---- roofline terms (global = per-device x chips for flops/bytes) ----
    mf = model_flops(cfg, shape)
    flops_g = hc["flops"] * data
    bytes_g = hc["bytes_fused"] * data
    terms = {
        "compute_s": flops_g / (data * _peak(cfg, HW)),
        "memory_s": bytes_g / (data * HW["hbm_bw"]),
        "collective_s": wire / HW["link_bw"],
    }
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    ideal = ideal_time(cfg, shape, data, cache_bytes)
    rec.update(
        model_flops=mf, hlo_flops_global=flops_g, hlo_bytes_global=bytes_g,
        useful_flops_ratio=(mf / flops_g if flops_g else 0.0),
        terms=terms, dominant=dom, ideal_s=ideal,
        roofline_fraction=(ideal / bound if bound else 0.0),
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry-run cost accounting on "
                                 "the meta device")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--runtime", default="stream",
                    choices=("stream", "sync"))
    ap.add_argument("--mode", default="spectrain",
                    choices=pipeline_stream.MODES)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (4 layers, 2 stages, 8 x 64)")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) cells")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--pipe", type=int, default=None,
                    help="pipeline stages on the card (default: the "
                         "config's mesh_plan.pipe)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel replicas (chips)")
    ap.add_argument("--fused-predict", action="store_true")
    ap.add_argument("--bwd-bf16", action="store_true")
    ap.add_argument("--ticks", type=int, default=0)
    ap.add_argument("--serve-bf16", action="store_true")
    # the JAX dry-run's mesh flags: parsed so that they are refused
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--no-ring-tp", action="store_true")
    args = ap.parse_args(argv)
    why = refused(args)
    if why:
        raise SystemExit(why)

    cells = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            try:
                rec = build_cell(arch, shape, runtime=args.runtime,
                                 mode=args.mode, smoke=args.smoke,
                                 pipe=args.pipe, data=args.data,
                                 fused_predict=args.fused_predict,
                                 bwd_bf16=args.bwd_bf16,
                                 ticks=args.ticks or None,
                                 serve_bf16=args.serve_bf16)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape,
                       "mesh": f"{args.data}x1", "status": "fail",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
            cells.append(rec)
            line = {k: v for k, v in rec.items()
                    if k not in ("collectives",)}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    print(f"# {len(cells)} cells, {failures} failures", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
