"""Async streaming pipeline — the paper's PipeDream-style runtime (twin of
the streaming half of ``repro/core/pipeline_stream.py``).

One ``train_step`` call = one pipeline **tick** (or ``ticks_per_step``
of them).  Every stage performs one forward (of the microbatch injected
``k`` ticks ago) and one backward (of the microbatch injected
``2(S−1)−k`` ticks ago) per tick; in-flight activations and cotangents
live in ring buffers kept in the train state.  Each stage applies its
own gradient the tick its backward completes.  After the 2(S−1)-tick
warm-up there is no bubble.

Weight-handling modes (§3.2 / Fig. 7):

  vanilla    fwd & bwd use current weights            (stale, inconsistent)
  pipedream  fwd uses current, bwd the stashed fwd weights
  spectrain  fwd uses Ŵ = W − s_fwd·η·v (Eq. 4 with s_fwd = 2(S−1−k));
             bwd uses current weights (s_bwd = 0)

All the stages run on one device, one after another, in the order the
JAX twin's tick lists them.  Where the port differs in mechanics (not
in numbers):

* the state is updated **in place**: parameters and momentum by the
  fused update kernel, rings by ``copy_``; ``train_step`` returns the
  same state object;
* in ``spectrain`` mode the state always holds ``pred``, the next
  tick's forward weights, written by the fused update kernel at the end
  of each tick with each stage's s_fwd.  Without ``fused_predict`` it
  is fp32 (Ŵ_{t+1} = W_{t+1} − s·η·v_{t+1}, what the JAX twin computes
  at the start of tick t+1); with it, the compute dtype.  At tick 0 it
  is W₀ (v₀ = 0).  Of the outer tree only ``embed.tok`` is predicted:
  the embedding reads nothing else, and the head loss uses the current
  outer weights;
* each stage's backward recomputes its forward from the stashed input
  under autograd and takes ``torch.autograd.grad`` with respect to the
  fp32 weight leaves (cast to ``bwd_dtype`` first when it is set), so
  gradients come back in that dtype.

One difference in numbers: in ``pipedream`` mode the last stage
(fb_gap 0) takes its backward at the current weights, the ones its
forward ran on in the same tick.  The JAX twin reads them from the
weight-stash slot it is about to overwrite, which holds the weights of
tick t − R (a fault of the reference, ROADMAP §C).

A planner ``PipelinePlan`` (``plan=``, stream schedule) supplies the
IR-derived prediction distances and ring offsets, and its partition
(a dp split may be ragged) the stage trees; without one the closed-form
stream schedule and the model's uniform split are used.

Besides the streaming tick loop, this module hosts the **IR
interpreter** (``make_ir_state`` / ``make_ir_train_step``), which runs
the planner's round schedules (GPipe, 1F1B PipeDream-flush,
PipeDream-2BW and interleaved virtual stages) by walking one round's
compute events in timeline order: one ``train_step`` call is one flush
round (or 2BW accumulation group).  ``backend="scan"`` interprets the
plan's dense ``EventTable`` row by row over two slot pools (as
``ServeEngine`` interprets its serve table); ``backend="unrolled"``
walks the round program with per-value dicts (the JAX twin's reference
oracle).  Both run the same arithmetic in the same order and agree bit
for bit.  Flush schedules read the current weights; 2BW reads the
stashed previous version (its IR-derived weight-stash depth is 2), and
``spectrain`` predicts each read forward by the event's IR-derived lag
(Eq. 4).  Each backward recomputes its chunk from the stashed input,
as the tick does.  The gradient is the mean over the round's
microbatches and the update runs once a round, one fused update launch
for the outer tree and one for each chunk tree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import spectrain as st
from repro_torch.models.layers import dtype_of, tree_leaves, tree_map
from repro_torch.models.model import cast_for_compute
from repro_torch.optim import sgd
from repro_torch.planner import schedule_ir as sir

MODES = ("vanilla", "pipedream", "spectrain")


def _plan_vectors(S: int, plan=None):
    """(s_fwd, bwd_lag, fb_gap) per stage — from a planner
    ``PipelinePlan`` when given (IR-derived), else the closed-form
    streaming schedule:

    ``s_fwd``   prediction distance, 2(S−1−k) — Eq. 4's s;
    ``bwd_lag`` injection→backward ticks, 2(S−1)−k — gates warm-up
                validity and the stage-0 batch-ring read;
    ``fb_gap``  same-stage fwd→backward ticks, 2(S−1−k) — the stash-ring
                read offsets.

    The runtime's dataflow (one fwd/bwd wave per tick) is the stream
    schedule, so only stream plans are accepted."""
    if plan is None:
        return ([st.version_difference_stream(k, S, "forward")
                 for k in range(S)],
                [2 * (S - 1) - k for k in range(S)],
                [2 * (S - 1 - k) for k in range(S)])
    if plan.schedule != "stream":
        raise ValueError(
            f"pipeline_stream executes the stream schedule, got a "
            f"{plan.schedule!r} plan (use core.simulator for those)")
    if plan.n_stages != S:
        raise ValueError(f"plan has {plan.n_stages} stages, model has {S}")
    return list(plan.s_fwd), list(plan.bwd_lag), list(plan.fb_gap)


def stage_sizes(model, plan=None) -> Tuple[int, ...]:
    """Per-stage layer counts this runtime executes: the model's uniform
    split without a plan, else the plan's partition, validated as an
    executable artifact (its layer ranges must tile exactly the model's
    layers across exactly the model's stages)."""
    if plan is None:
        return tuple(model.stage_sizes)
    if plan.partition.n_stages != plan.n_stages:
        raise ValueError(f"plan partition has {plan.partition.n_stages} "
                         f"stages but plan.n_stages={plan.n_stages}")
    return _partition_sizes(model, plan, model.n_stages, "stage")


def _partition_sizes(model, plan, n: int, unit: str) -> Tuple[int, ...]:
    """The plan partition's layer counts, checked to tile exactly the
    model's layers in exactly ``n`` non-empty units (stages or chunks,
    named by ``unit``)."""
    part = plan.partition
    if part.n_layers != model.cfg.n_layers:
        raise ValueError(
            f"plan partitions {part.n_layers} layers, model has "
            f"{model.cfg.n_layers}")
    sizes = part.sizes()
    if len(sizes) != n:
        raise ValueError(f"plan has {len(sizes)} {unit}s, expected {n}")
    if min(sizes) < 1:
        raise ValueError(f"plan has an empty {unit}: sizes={sizes}")
    return sizes


def device_batch(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as int64 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v).to(device, torch.int64)
            for k, v in batch.items()}


def _clone(tree, dtype=None):
    return tree_map(lambda _, p: p.detach().to(
        p.dtype if dtype is None else dtype, copy=True), tree)


def _leaves_like(tree, dtype=None):
    """Fresh autograd leaves holding ``tree``'s values (a cast copy when
    ``dtype`` differs, else the same storage)."""
    return tree_map(lambda _, p: (p.detach() if dtype is None
                                  else p.detach().to(dtype)
                                  ).requires_grad_(), tree)


def _grads(out, leaves, cot, *, extra=()):
    """``autograd.grad`` of ``out`` against ``cot`` with respect to the
    leaves of a tree (zeros for leaves ``out`` does not reach) and the
    tensors in ``extra``.  Returns (grad tree, [grads of extra])."""
    flat = tree_leaves(leaves)
    gs = torch.autograd.grad(out, flat + list(extra), cot,
                             allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g
          for p, g in zip(flat + list(extra), gs)]
    it = iter(gs[:len(flat)])
    return tree_map(lambda _, p: next(it), leaves), gs[len(flat):]


def make_state(model, params, batch, *, mode: str = "spectrain",
               ticks_per_step: int = 1, fused_predict: bool = False,
               plan=None) -> Dict[str, Any]:
    """Streaming train state: params + momentum + in-flight rings.

    ``params`` is the ragged canonical tree on the model's device, fp32;
    the state takes it over and the train step updates it in place.
    ``batch`` is an example global batch (arrays or tensors), which
    fixes the ring shapes.  ``ticks_per_step``: the global batch is split
    into this many per-tick minibatches.  ``fused_predict``: keep the
    prediction in the compute dtype (see the module docstring).
    ``plan``: a stream ``PipelinePlan``, whose partition regroups the
    stage trees (a copy when its sizes differ from the model's split)
    and whose IR-derived vectors size the rings."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    cfg = model.cfg
    S = model.n_stages
    dev = model.device
    if S == 1:
        return {"params": params, "momentum": sgd.init(params).v,
                "step": 0}
    _, lag, gap = _plan_vectors(S, plan)
    sizes = stage_sizes(model, plan)
    params = {"outer": params["outer"],
              "stages": model.partition_stage_params(params["stages"],
                                                     sizes)}
    state: Dict[str, Any] = {"params": params,
                             "momentum": sgd.init(params).v, "step": 0}
    cdt = dtype_of(cfg.compute_dtype)
    if mode == "spectrain":
        pdt = cdt if fused_predict else None
        state["pred"] = {
            "outer": {"embed": {"tok": _clone(
                params["outer"]["embed"]["tok"], pdt)}},
            "stages": tuple(_clone(t, pdt) for t in params["stages"]),
        }
    R = max(max(lag), max(gap)) + 1
    B, seq = (int(n) for n in np.shape(batch["tokens"])[:2])
    if B % ticks_per_step:
        raise ValueError(f"global batch {B} not divisible by "
                         f"ticks_per_step={ticks_per_step}")
    mb = B // ticks_per_step
    act = (S, mb, seq, cfg.d_model)
    state.update({
        "tick": 0,
        "fwd_buf": torch.zeros(act, dtype=cdt, device=dev),
        "bwd_buf": torch.zeros(act, dtype=cdt, device=dev),
        "stash_x": torch.zeros((S, R) + act[1:], dtype=cdt, device=dev),
        "batch_ring": {k: torch.zeros((R, mb) + tuple(np.shape(v)[1:]),
                                      dtype=torch.int64, device=dev)
                       for k, v in batch.items()},
    })
    if mode == "pipedream":
        # per-stage weight rings: leaves [R, ...] mirroring each stage
        state["w_stash"] = tuple(
            tree_map(lambda _, p: p.detach()[None].repeat(
                (R,) + (1,) * p.dim()), t)
            for t in params["stages"])
    return state


def init_state(model, generator: torch.Generator, batch, *,
               mode: str = "spectrain", ticks_per_step: int = 1,
               fused_predict: bool = False, plan=None):
    return make_state(model, model.init(generator), batch, mode=mode,
                      ticks_per_step=ticks_per_step,
                      fused_predict=fused_predict, plan=plan)


def make_train_step(model, *, mode: str = "spectrain", lr: float,
                    gamma: float = 0.9, clip: Optional[float] = None,
                    ticks_per_step: int = 1,
                    bwd_dtype: Optional[str] = None, plan=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, updating the
    state in place.  (The JAX twin's ``fused_predict`` is a ``make_state``
    option here: the step writes the prediction in whatever dtype the
    state keeps it.)  ``clip``: global-norm clipping of each tick's
    gradients.  ``bwd_dtype``: take each stage's backward at its weights
    cast to this dtype (e.g. "bfloat16"), so its gradients come back in
    it.  ``plan``: the stream ``PipelinePlan`` the state was made with
    (its ``s_fwd`` are the prediction distances, ``bwd_lag`` and
    ``fb_gap`` the ring offsets).  Metrics: ``loss`` (a 0-d tensor on the
    device) and ``loss_valid`` (1.0 once the pipeline has filled; with several ticks
    per step, the number of valid ticks averaged into ``loss``)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    S = model.n_stages
    s_fwd, bwd_lag, fb_gap = _plan_vectors(S, plan)
    if plan is not None:
        stage_sizes(model, plan)   # fail fast on an unexecutable plan
    R = max(max(bwd_lag), max(fb_gap)) + 1
    bdt = None if bwd_dtype is None else dtype_of(bwd_dtype)

    def stage_fn(sp, xk):
        zero = torch.zeros((), dtype=torch.float32, device=xk.device)
        return model.stage_apply(sp, (xk, zero))

    # ------------------------------------------------------------- S == 1
    def step_degenerate(state, batch):
        batch = device_batch(batch, model.device)
        with torch.enable_grad():
            leaves = _leaves_like(state["params"])
            loss = model.loss(leaves, batch)
            grads, _ = _grads(loss, leaves, None)
        if clip:
            grads, _ = sgd.clip_by_global_norm(grads, clip)
        sgd.update(state["params"], sgd.MomentumState(state["momentum"]),
                   grads, lr=lr, gamma=gamma)
        state["step"] += 1
        return state, {"loss": loss.detach(), "loss_valid": 1.0}

    if S == 1:
        return step_degenerate

    # ------------------------------------------------------------- S > 1
    def tick_fn(state: Dict[str, Any], batch):
        t = state["tick"]
        params, mom = state["params"], state["momentum"]
        outer, stages = params["outer"], params["stages"]
        slot = t % R
        fwd_buf, bwd_buf = state["fwd_buf"], state["bwd_buf"]
        stash, ring = state["stash_x"], state["batch_ring"]

        # ---------- forward weights (Eq. 4, written by the last update)
        if mode == "spectrain":
            stages_f = state["pred"]["stages"]
            outer_embed_f = state["pred"]["outer"]
        else:
            stages_f, outer_embed_f = stages, outer

        # ---------- inject + forward all stages --------------------------
        with torch.no_grad():
            fwd_buf[0].copy_(model.embed(outer_embed_f, batch))
            outs = [stage_fn(stages_f[k], fwd_buf[k])[0] for k in range(S)]
            stash[:, slot].copy_(fwd_buf)
            for name, r in ring.items():
                r[slot].copy_(batch[name])

        # ---------- head loss at the last stage (current outer) ---------
        valid_head = 1.0 if t >= S - 1 else 0.0
        tgt = ring["targets"][(t - (S - 1)) % R]
        with torch.enable_grad():
            outer_l = _leaves_like(outer)
            xlast = outs[S - 1].detach().requires_grad_()
            loss = model.head_loss(outer_l, xlast, tgt)
            g_outer, (cot_last,) = _grads(
                loss, outer_l, torch.tensor(valid_head, device=loss.device),
                extra=(xlast,))

        # ---------- backward all stages ---------------------------------
        # warm-up validity multiplies the cotangents by 0, as in JAX: the
        # backward and the update run every tick
        bwd_buf[S - 1].copy_(cot_last)
        valid_b = [float(t - bwd_lag[k] >= 0) for k in range(S)]
        idx = [(t - fb_gap[k]) % R for k in range(S)]
        if mode == "pipedream":
            # the weights this input's forward ran on, fb_gap[k] ticks
            # ago; with fb_gap 0 that is this tick, i.e. the current
            # weights (the JAX twin reads the ring slot this tick is about
            # to overwrite, tick t - R's weights: ROADMAP §C)
            stages_b = tuple(
                stages[k] if fb_gap[k] == 0 else
                tree_map(lambda _, r, i=idx[k]: r[i], state["w_stash"][k])
                for k in range(S))
        else:
            stages_b = stages
        gW: List[Any] = []
        gX: List[torch.Tensor] = []
        for k in range(S):
            with torch.enable_grad():
                sp = _leaves_like(stages_b[k], bdt)
                xk = stash[k, idx[k]].detach().requires_grad_()
                y, _aux = stage_fn(sp, xk)
                gw, (gx,) = _grads(y, sp, bwd_buf[k] * valid_b[k],
                                   extra=(xk,))
            gW.append(gw)
            gX.append(gx)

        # ---------- embed backward --------------------------------------
        old_tokens = ring["tokens"][(t - bwd_lag[0]) % R]
        with torch.enable_grad():
            tok = outer["embed"]["tok"].detach().requires_grad_()
            emb = model.embed({"embed": {"tok": tok}},
                              {"tokens": old_tokens})
            (g_tok,) = torch.autograd.grad(emb, [tok], gX[0] * valid_b[0])
        g_outer["embed"]["tok"] = g_outer["embed"]["tok"] + g_tok

        grads = {"outer": g_outer, "stages": tuple(gW)}
        if clip:
            grads, _ = sgd.clip_by_global_norm(grads, clip)

        # ---------- per-tick, per-stage update (in place) ---------------
        if mode == "pipedream":
            # the stash ring takes this tick's weights before the update
            for k in range(S):
                for r, p in zip(tree_leaves(state["w_stash"][k]),
                                tree_leaves(stages[k])):
                    r[slot].copy_(p)
        pred = state.get("pred")
        sgd.update(outer, sgd.MomentumState(mom["outer"]), grads["outer"],
                   lr=lr, gamma=gamma, s=s_fwd[0],
                   pred=None if pred is None else pred["outer"])
        for k in range(S):
            sgd.update(stages[k], sgd.MomentumState(mom["stages"][k]),
                       grads["stages"][k], lr=lr, gamma=gamma, s=s_fwd[k],
                       pred=None if pred is None else pred["stages"][k])

        # ---------- rotate in-flight buffers -----------------------------
        with torch.no_grad():
            for k in range(S):
                fwd_buf[k].copy_(outs[k - 1])
                bwd_buf[k].copy_(gX[(k + 1) % S])
        state["tick"] = t + 1
        state["step"] += 1
        return state, {"loss": loss.detach(), "loss_valid": valid_head}

    def train_step(state, batch):
        batch = device_batch(batch, model.device)
        T = ticks_per_step
        if T == 1:
            return tick_fn(state, batch)
        mbs = [{k: v.reshape((T, v.shape[0] // T) + tuple(v.shape[1:]))[i]
                for k, v in batch.items()} for i in range(T)]
        losses, valid = [], []
        for mb in mbs:
            state, met = tick_fn(state, mb)
            losses.append(met["loss"] * met["loss_valid"])
            valid.append(met["loss_valid"])
        n = max(sum(valid), 1.0)
        return state, {"loss": torch.stack(losses).sum() / n,
                       "loss_valid": sum(valid)}

    return train_step



# ===========================================================================
# IR interpreter: round schedules (gpipe / 1f1b / 2bw / interleaved)
# executed by walking one round of the planner IR's compute events
# ===========================================================================

IR_SCHEDULES = sir.ROUND_SCHEDULES
IR_BACKENDS = ("scan", "unrolled")
EXECS = ("spmd", "mpmd")


def _unsupported(combo: str, why: str, use: str) -> NotImplementedError:
    """The JAX twin's one shape of refusal: the combination, why it is
    out of scope, and the supported alternative."""
    return NotImplementedError(
        f"unsupported combination: {combo} — {why}; "
        f"supported alternative: {use}")


def _check_execution(execution: Optional[str]) -> None:
    execution = "spmd" if execution is None else execution
    if execution not in EXECS:
        raise ValueError(f"unknown execution {execution!r}; known: {EXECS}")
    if execution == "mpmd":
        raise _unsupported(
            "execution='mpmd'",
            "stage-local (one process per stage) execution is not ported "
            "to PyTorch yet; it is the next slice of the port",
            "execution='spmd' (every chunk on the one device)")


def _ir_plan_check(model, plan) -> Tuple[int, ...]:
    """Validate a plan as an executable artifact for the IR interpreter;
    returns the per-chunk layer counts."""
    if plan is None:
        raise ValueError("the IR-interpreter runtime needs a plan "
                         "(repro_torch.planner.plan(..., "
                         "schedule='1f1b'|...))")
    if plan.schedule not in IR_SCHEDULES:
        raise ValueError(
            f"IR interpreter executes {IR_SCHEDULES}, got a "
            f"{plan.schedule!r} plan (the stream schedule runs through "
            f"make_train_step)")
    if plan.n_stages != model.n_stages:
        raise ValueError(f"plan has {plan.n_stages} device stages, model "
                         f"has {model.n_stages}")
    sizes = _partition_sizes(model, plan, plan.n_chunks, "chunk-stage")
    if plan.round_microbatches < 1:
        raise ValueError(f"plan carries no round size "
                         f"(round_microbatches={plan.round_microbatches})")
    depth = max(plan.w_stash_depth) if plan.w_stash_depth else 1
    if depth > 2:
        raise _unsupported(
            f"a {plan.schedule!r} plan with IR-derived weight-stash "
            f"depth {depth}",
            "the interpreter implements only single-buffer and 2BW "
            "double-buffer weight reads (depth <= 2)",
            "a schedule whose IR derives depth <= 2 (1f1b, gpipe, "
            "interleaved, 2bw)")
    return sizes


def make_ir_state(model, params, batch=None, *, plan,
                  mode: str = "spectrain", execution: Optional[str] = None,
                  verify: bool = True) -> Dict[str, Any]:
    """Train state for the IR interpreter: chunked params + momentum
    (+ the 2BW double buffer when the IR derives a stash depth of 2).

    ``params`` is the ragged canonical tree (or the legacy stacked one)
    on the model's device, fp32; the state takes it over.  Its stage
    weights are regrouped into ``plan.n_chunks`` ragged chunk trees by
    the plan's partition (``Model.device_chunk_params`` gives the
    per-device grouping of virtual stages).  There are no activation
    rings: a round's in-flight activations live inside one step, sized
    by the schedule (peak = ``plan.act_stash``), so ``batch`` is not
    needed (the JAX twin's signature takes its shapes).  ``verify``
    statically verifies the plan's compiled artifacts first
    (``planner/verify.py``)."""
    del batch
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    _check_execution(execution)
    sizes = _ir_plan_check(model, plan)
    if verify:
        plan.verify()
    params = {"outer": params["outer"],
              "stages": model.partition_stage_params(
                  params["stages"], sizes, n_chunks=plan.n_chunks)}
    state: Dict[str, Any] = {"params": params,
                             "momentum": sgd.init(params).v, "step": 0}
    if max(plan.w_stash_depth) > 1:
        # 2BW: reads are pinned one version back; the stash starts equal
        # to the params (version 0 reads version 0, the IR's warm-up)
        state["stash"] = {"params": _clone(params),
                          "momentum": _clone(state["momentum"])}
    return state


def _stash_before_update(state) -> None:
    """2BW's buffer rotation, before the in-place update writes: the
    stash takes the weights and momentum this round read as current
    (the JAX twin's ``{"params": params, "momentum": mom}``, its old
    trees).  Copied: the update overwrites ``params`` in place, so a
    stash that only referenced them would read the new weights."""
    for dst, src in ((state["stash"]["params"], state["params"]),
                     (state["stash"]["momentum"], state["momentum"])):
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s)


class _Round:
    """One round's weight reads, event bodies and gradient accumulators,
    shared by both backends (which differ only in where a value waits
    between its producing and consuming events).

    Weight reads are cached per (chunk, lag): the base weights (current,
    or 2BW's stash), predicted forward by the lag in ``spectrain`` mode
    (Eq. 4), and for the chunks cast once to the compute dtype (every
    microbatch reads the same copy; a weight's gradient through it is
    the same as through a per-call cast).  Accumulators follow the JAX
    twin: the first contribution is taken as is (widened to fp32), later
    ones are added in place; head and embed contributions to the outer
    gradient accumulate apart and are summed once at the end.  A leaf a
    contribution does not reach (the embedding table in an untied head)
    adds nothing, where the JAX twin adds its zeros."""

    def __init__(self, model, base_p, base_m, *, mode: str, lr: float,
                 mbs: Dict[str, torch.Tensor], n_chunks: int):
        self.model, self.base_p, self.base_m = model, base_p, base_m
        self.mode, self.lr, self.mbs = mode, lr, mbs
        self.cdt = dtype_of(model.cfg.compute_dtype)
        self._w: Dict[Tuple[str, int], Any] = {}
        # per-leaf accumulators (None: no contribution yet)
        self.g_chunks: List[Optional[List]] = [None] * n_chunks
        self.g_head: Optional[List] = None
        self.g_tok: Optional[torch.Tensor] = None
        self.loss_sum: Optional[torch.Tensor] = None

    def mb(self, m: int) -> Dict[str, torch.Tensor]:
        return {k: v[m] for k, v in self.mbs.items()}

    def _predicted(self, w, v, s: int):
        if self.mode == "spectrain" and s > 0:
            return st.predict_weights(w, v, self.lr, float(s))
        return w

    def chunk_w(self, q: int, s: int):
        key = ("c%d" % q, s)
        if key not in self._w:
            w = self._predicted(self.base_p["stages"][q],
                                self.base_m["stages"][q], s)
            if self.cdt != torch.float32:
                w = cast_for_compute(w, self.cdt)
            self._w[key] = w
        return self._w[key]

    def outer_w(self, s: int):
        key = ("outer", s)
        if key not in self._w:
            self._w[key] = self._predicted(self.base_p["outer"],
                                           self.base_m["outer"], s)
        return self._w[key]

    @staticmethod
    def _acc(acc, gs, first: bool):
        if acc is None or first:
            return [None if g is None else g.float() for g in gs]
        for i, g in enumerate(gs):
            if g is None:
                continue
            if acc[i] is None:
                acc[i] = g.float()
            else:
                acc[i].add_(g)
        return acc

    def _stage(self, sp, x):
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return self.model.stage_apply(sp, (x, zero))[0]

    # ------------------------------------------------------------ events
    def embed(self, m: int, s: int) -> torch.Tensor:
        with torch.no_grad():
            return self.model.embed(self.outer_w(s), self.mb(m))

    def fwd(self, q: int, s: int, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._stage(self.chunk_w(q, s), x)

    def head(self, m: int, s: int, out: torch.Tensor, first: bool
             ) -> torch.Tensor:
        """Loss of the last chunk's output; accumulates the head's outer
        gradient and returns the cotangent of ``out``."""
        with torch.enable_grad():
            outer_l = _leaves_like(self.outer_w(s))
            xl = out.detach().requires_grad_()
            loss = self.model.head_loss(outer_l, xl,
                                        self.mb(m)["targets"])
            *gs, cot = torch.autograd.grad(
                loss, tree_leaves(outer_l) + [xl], allow_unused=True)
        self.g_head = self._acc(self.g_head, gs, first)
        loss = loss.detach()
        self.loss_sum = loss if self.loss_sum is None else \
            self.loss_sum + loss
        return cot

    def bwd(self, q: int, s: int, x: torch.Tensor, cot: torch.Tensor,
            first: bool) -> torch.Tensor:
        """Chunk q's backward, recomputed from its stashed input;
        accumulates its weight gradient and returns the input's."""
        with torch.enable_grad():
            sp = _leaves_like(self.chunk_w(q, s))
            xk = x.detach().requires_grad_()
            *gs, gx = torch.autograd.grad(
                self._stage(sp, xk), tree_leaves(sp) + [xk], cot,
                allow_unused=True)
        self.g_chunks[q] = self._acc(self.g_chunks[q], gs, first)
        return gx

    def embed_bwd(self, m: int, s: int, gx: torch.Tensor,
                  first: bool) -> None:
        with torch.enable_grad():
            tok = self.outer_w(s)["embed"]["tok"].detach().requires_grad_()
            emb = self.model.embed({"embed": {"tok": tok}},
                                   {"tokens": self.mb(m)["tokens"]})
            (g,) = torch.autograd.grad(emb, [tok], gx)
        self.g_tok = self._acc(None if self.g_tok is None else
                               [self.g_tok], [g], first)[0]

    def grads(self, params, M: int):
        """The round's mean gradient tree over ``params``' leaves (the
        accumulators, divided in place; zeros for a leaf nothing
        reached) and mean loss."""
        g_outer = _tree_of(params["outer"], self.g_head)
        g_outer["embed"]["tok"].add_(self.g_tok)
        grads = {"outer": g_outer,
                 "stages": tuple(_tree_of(t, g) for t, g in
                                 zip(params["stages"], self.g_chunks))}
        for g in tree_leaves(grads):
            g.div_(M)
        return grads, self.loss_sum / M


def _tree_of(like, leaves):
    """A tree shaped as ``like`` from a leaf list in its order, zeros
    (fp32) where an entry is None."""
    it = iter(leaves)

    def one(_, p):
        g = next(it)
        return torch.zeros(p.shape, dtype=torch.float32,
                           device=p.device) if g is None else g
    return tree_map(one, like)


def make_ir_train_step(model, *, plan, mode: str = "spectrain", lr: float,
                       gamma: float = 0.9, clip: Optional[float] = None,
                       backend: str = "scan", tracer=None,
                       execution: Optional[str] = None) -> Callable:
    """Schedule-driven step, ``train_step(state, batch) -> (state,
    metrics)`` updating the state in place: one call executes one flush
    round (gpipe / 1f1b / interleaved) or one 2BW accumulation group of
    ``plan.round_microbatches`` microbatches, by interpreting the IR's
    compute events in timeline order (see the module docstring for the
    weight reads, the backward and the update).

    ``backend``: ``"scan"`` interprets the plan's ``EventTable`` row by
    row over a value pool ``P`` and a cotangent pool ``Q`` (their slots
    register-allocated by the table); ``"unrolled"`` walks the round
    program with per-value dicts and raises on tensors left in flight.
    The plan is verified once, by :func:`make_ir_state`.  ``tracer``
    and ``execution="mpmd"`` are not ported yet and raise."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if backend not in IR_BACKENDS:
        raise ValueError(
            f"unknown IR backend {backend!r}; known: {IR_BACKENDS}")
    _check_execution(execution)
    if tracer is not None:
        raise _unsupported(
            "a tracer on the IR interpreter",
            "tracing (obs/trace.py, fed by CUDA events) is not ported to "
            "PyTorch yet; it is a later slice of the port",
            "tracer=None")
    _ir_plan_check(model, plan)
    prog = plan.round_program()
    C, M = plan.n_chunks, plan.round_microbatches
    two_buf = max(plan.w_stash_depth) > 1
    table = (sir.compile_event_table(prog, C, M) if backend == "scan"
             else None)

    def unrolled_round(rnd: _Round) -> None:
        acts: Dict[Tuple[int, int], torch.Tensor] = {}  # chunk inputs
        outs: Dict[Tuple[int, int], torch.Tensor] = {}  # chunk outputs
        cots: Dict[Tuple[int, int], torch.Tensor] = {}  # output cotangents
        for kind, m, q, s in prog:
            if kind == sir.FWD:
                x = rnd.embed(m, s) if q == 0 else outs.pop((m, q - 1))
                acts[(m, q)] = x
                outs[(m, q)] = rnd.fwd(q, s, x)
                continue
            if q == C - 1:
                cot = rnd.head(m, s, outs.pop((m, q)),
                               first=rnd.g_head is None)
            else:
                cot = cots.pop((m, q + 1))
            gx = rnd.bwd(q, s, acts.pop((m, q)), cot,
                         first=rnd.g_chunks[q] is None)
            if q == 0:
                rnd.embed_bwd(m, s, gx, first=rnd.g_tok is None)
            else:
                cots[(m, q)] = gx
        if acts or outs or cots:
            raise ValueError(
                f"{plan.schedule!r} round program (round size {M}) "
                f"left in-flight tensors: "
                f"{sorted(acts) + sorted(outs) + sorted(cots)}")

    def scan_round(rnd: _Round) -> None:
        # one activation shape at every cut (d_model wide), so one pool
        # of value slots and one of cotangent slots serve every chunk
        P = Q = None
        for row in table.rows.tolist():
            kind, q, s = table.branches[row[sir.COL_BRANCH]]
            m, a, b = row[sir.COL_MB], row[sir.COL_A], row[sir.COL_B]
            if kind == sir.FWD:
                if q == 0:
                    x = rnd.embed(m, s)
                    if P is None:
                        P = x.new_zeros((table.n_val_slots,) + x.shape)
                        Q = x.new_zeros((max(table.n_cot_slots, 1),)
                                        + x.shape)
                    P[a].copy_(x)
                P[b].copy_(rnd.fwd(q, s, P[a]))
                continue
            if q == C - 1:
                cot = rnd.head(m, s, P[b],
                               first=row[sir.COL_FIRST_O] > 0)
            else:
                cot = Q[b]
            # every input is read before the write: the table may hand
            # this event's freed cotangent slot to its own output
            gx = rnd.bwd(q, s, P[a], cot, first=row[sir.COL_FIRST_G] > 0)
            if q == 0:
                rnd.embed_bwd(m, s, gx, first=row[sir.COL_FIRST_E] > 0)
            else:
                Q[row[sir.COL_C]].copy_(gx)

    run_round = scan_round if backend == "scan" else unrolled_round

    def step(state: Dict[str, Any], batch):
        batch = device_batch(batch, model.device)
        B = batch["tokens"].shape[0]
        if B % M:
            raise ValueError(
                f"batch {B} not divisible by the {plan.schedule!r} plan's "
                f"round size (round_microbatches={M})")
        mbs = {k: v.reshape((M, B // M) + tuple(v.shape[1:]))
               for k, v in batch.items()}
        params, mom = state["params"], state["momentum"]
        base = state["stash"] if two_buf else {"params": params,
                                               "momentum": mom}
        rnd = _Round(model, base["params"], base["momentum"], mode=mode,
                     lr=lr, mbs=mbs, n_chunks=C)
        run_round(rnd)
        grads, loss = rnd.grads(params, M)
        del rnd
        if clip:
            grads, _ = sgd.clip_by_global_norm(grads, clip)
        if two_buf:
            _stash_before_update(state)
        # one fused update launch per stage group: the outer tree, then
        # each chunk tree
        sgd.update(params["outer"], sgd.MomentumState(mom["outer"]),
                   grads["outer"], lr=lr, gamma=gamma)
        for q in range(C):
            sgd.update(params["stages"][q],
                       sgd.MomentumState(mom["stages"][q]),
                       grads["stages"][q], lr=lr, gamma=gamma)
        state["step"] += 1
        return state, {"loss": loss, "loss_valid": 1.0}

    return step
