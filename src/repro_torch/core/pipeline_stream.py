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

The planner (``plan=``) is not ported: the closed-form stream schedule
gives the prediction distances and ring offsets, and the stage sizes
are the model's uniform split.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import spectrain as st
from repro_torch.models.layers import dtype_of, tree_leaves, tree_map
from repro_torch.optim import sgd

MODES = ("vanilla", "pipedream", "spectrain")


def _no_plan(plan) -> None:
    if plan is not None:
        raise NotImplementedError(
            "planner not ported to PyTorch yet: the streaming runtime runs "
            "the closed-form stream schedule with the uniform stage split "
            "(pass plan=None)")


def _plan_vectors(S: int, plan=None):
    """(s_fwd, bwd_lag, fb_gap) per stage, the closed-form streaming
    schedule:

    ``s_fwd``   prediction distance, 2(S−1−k) — Eq. 4's s;
    ``bwd_lag`` injection→backward ticks, 2(S−1)−k — gates warm-up
                validity and the stage-0 batch-ring read;
    ``fb_gap``  same-stage fwd→backward ticks, 2(S−1−k) — the stash-ring
                read offsets."""
    _no_plan(plan)
    return ([st.version_difference_stream(k, S, "forward")
             for k in range(S)],
            [2 * (S - 1) - k for k in range(S)],
            [2 * (S - 1 - k) for k in range(S)])


def stage_sizes(model, plan=None) -> Tuple[int, ...]:
    """Per-stage layer counts this runtime executes: the model's uniform
    split (remainder on the early stages)."""
    _no_plan(plan)
    return tuple(model.stage_sizes)


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
    prediction in the compute dtype (see the module docstring)."""
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
    it.  Metrics: ``loss`` (a 0-d tensor on the device) and
    ``loss_valid`` (1.0 once the pipeline has filled; with several ticks
    per step, the number of valid ticks averaged into ``loss``)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    S = model.n_stages
    s_fwd, bwd_lag, fb_gap = _plan_vectors(S, plan)
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

