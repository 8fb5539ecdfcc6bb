"""Paper-exact pipelined-training simulator (Fig. 7 semantics), the
port's twin of ``repro/core/simulator.py``.

Reproduces the *algorithmic* behaviour of the paper's 4 schemes on one
device, version-for-version:

  * ``sync``       — staleness-free reference (Data-P / single-GPU).
  * ``vanilla``    — pipelined, stale + inconsistent weights (Fig. 7b).
  * ``pipedream``  — weight stashing: bwd reuses the fwd weights (Fig. 7c).
  * ``spectrain``  — weight prediction, Eqs. (4)–(6) (Fig. 7d).

Timeline model (§3.1): the global weight version t advances once per time
unit; minibatch i reads stage-k forward weights at version

    v_f(i,k) = i + ⌈k/2⌉                (= t_c − s_fwd, Eq. 5)

and stage-k backward weights at

    v_b(i,k) = i + N − 1 − ⌊k/2⌋        (= t_c − s_bwd, Eq. 6)

with its round trip completing at t_c = i + N − 1, where its gradient is
applied (momentum SGD) producing version t_c + 1.  Processing minibatches
in order therefore only ever references versions that already exist.

Where the port differs in mechanics (not in numbers):

* the history is copy-on-write.  A version no step wrote is the same
  tree object as the version before it, as in JAX; the step producing
  version t_c + 1 clones version t_c's parameters and momentum and the
  fused update kernel overwrites the clone in place (``optim/sgd.py``
  updates in place: updating the stored tree would rewrite every version
  that aliases it);
* the update runs one group per stage tree and one for ``outer``: N + 1
  ``fused_update`` launches a step on the card (a launch takes at most
  64 tensors; the full-width SNN has 68 leaves);
* a step predicts (Eq. 4, ``spectrain.predict_weights``) only the stage
  tree or ``outer`` subtree it reads, not the whole tree;
* each stage's backward recomputes the stage under autograd and takes
  ``torch.autograd.grad`` with respect to its weight leaves and input.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import spectrain as st
from repro_torch.core.pipeline_stream import _clone, _grads, _leaves_like
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import sgd


@dataclass
class StagedFns:
    """A model split into N sequential stages.

    params layout: {"outer": {"in": ..., "out": ...}, "stages": [N trees]}
    ``embed`` consumes outer["in"], ``head_loss`` consumes outer["out"].
    """
    embed: Callable[[Any, Any], torch.Tensor]
    stage: Callable[[Any, torch.Tensor], torch.Tensor]
    head_loss: Callable[[Any, torch.Tensor, Any], torch.Tensor]


def _batch_on(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``,
    integer ones as int64 (they index)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


class Simulator:
    SCHEMES = ("sync", "vanilla", "pipedream", "spectrain")

    def __init__(self, fns: StagedFns, params, *, n_stages: int = 0,
                 scheme: str = "spectrain", lr: float = 1e-2,
                 gamma: float = 0.9, clip: Optional[float] = None,
                 rmse_s: Sequence[int] = (), plan=None):
        """``params``: fp32 tensors, all on one device (the simulator's);
        the simulator never writes them.  ``plan``: any object with
        ``n_stages``, optionally ``n_chunks``, and per-stage ``s_fwd`` /
        ``s_bwd`` (a planner ``PipelinePlan`` in the JAX package; the
        port has no planner yet); its staleness vectors replace the
        round-robin closed forms of Eqs. (5)/(6)."""
        if scheme not in self.SCHEMES:
            raise ValueError(f"scheme {scheme!r} not in {self.SCHEMES}")
        if plan is not None:
            n_chunks = getattr(plan, "n_chunks", plan.n_stages)
            if n_stages and n_stages != n_chunks:
                raise ValueError(f"n_stages={n_stages} contradicts "
                                 f"plan's {n_chunks} chunk-stages")
            n_stages = n_chunks
            self.s_fwd = tuple(plan.s_fwd)
            self.s_bwd = tuple(plan.s_bwd)
            # the per-stage staleness vectors must describe exactly the
            # stage list executed, or stage k's weights would pair with
            # stage j's s
            got = len(params["stages"])
            if got != n_chunks:
                raise ValueError(
                    f"params have {got} stage trees but plan has "
                    f"{n_chunks} (chunk-)stages")
        else:
            if not n_stages:
                raise ValueError("need n_stages or a plan")
            self.s_fwd = tuple(st.version_difference_paper(k, n_stages,
                                                           "forward")
                               for k in range(n_stages))
            self.s_bwd = tuple(st.version_difference_paper(k, n_stages,
                                                           "backward")
                               for k in range(n_stages))
        self.fns = fns
        self.N = n_stages
        self.scheme = scheme
        self.lr = lr
        self.gamma = gamma
        self.clip = clip
        self.rmse_s = tuple(rmse_s)
        self.device = tree_leaves(params)[0].device

        self.hist: Dict[int, Any] = {0: params}
        self.mhist: Dict[int, Any] = {0: sgd.init(params).v}
        self.latest = 0
        self.i = 0  # next minibatch index

    # ------------------------------------------------------------------ utils
    def _ensure(self, t: int):
        while self.latest < t:
            self.latest += 1
            self.hist[self.latest] = self.hist[self.latest - 1]
            self.mhist[self.latest] = self.mhist[self.latest - 1]

    def _gc(self, keep_from: int):
        for t in [t for t in self.hist if t < keep_from]:
            del self.hist[t]
            del self.mhist[t]

    def _weights_at(self, v: int, target: int, predicted: bool, part):
        """Subtree ``part`` (``("stages", k)`` or ``("outer", "in" |
        "out")``) of the weights the scheme exposes at read-version v:
        stored, or predicted ``target − v`` versions ahead (Eq. 4)."""
        w = self.hist[v][part[0]][part[1]]
        s = target - v
        if not predicted or s <= 0:
            return w
        return st.predict_weights(w, self.mhist[v][part[0]][part[1]],
                                  self.lr, s)

    # ------------------------------------------------------------------ step
    def step(self, batch) -> Dict[str, Any]:
        N, i, scheme, fns = self.N, self.i, self.scheme, self.fns
        batch = _batch_on(batch, self.device)
        if scheme == "sync":
            t_c = self.latest
            v_f = [t_c] * N
            v_b = [t_c] * N
        else:
            t_c = i + N - 1
            self._ensure(t_c)
            # max(0, ·) truncates warm-up reads to the initial weights;
            # under the round-robin closed forms these are exactly
            # v_f = i + ⌈k/2⌉ and v_b = i + N − 1 − ⌊k/2⌋
            v_f = [max(0, t_c - self.s_fwd[k]) for k in range(N)]
            v_b = [max(0, t_c - self.s_bwd[k]) for k in range(N)]
        predicted = scheme == "spectrain"

        # ---- forward ----------------------------------------------------
        with torch.no_grad():
            x = fns.embed(self._weights_at(v_f[0], t_c, predicted,
                                           ("outer", "in")), batch)
            xs_in: List[torch.Tensor] = []
            for k in range(N):
                xs_in.append(x)
                x = fns.stage(self._weights_at(v_f[k], t_c, predicted,
                                               ("stages", k)), x)

        # ---- backward ----------------------------------------------------
        def bwd_weights(k, part):
            if scheme == "pipedream":   # stashing: reuse the fwd weights
                return self._weights_at(v_f[k], t_c, False, part)
            return self._weights_at(v_b[k], t_c, predicted, part)

        with torch.enable_grad():
            w = _leaves_like(bwd_weights(N - 1, ("outer", "out")))
            xl = x.detach().requires_grad_()
            loss = fns.head_loss(w, xl, batch)
            g_out, (cot,) = _grads(loss, w, None, extra=(xl,))
            grads_stages: List[Any] = [None] * N
            for k in reversed(range(N)):
                w = _leaves_like(bwd_weights(k, ("stages", k)))
                xk = xs_in[k].detach().requires_grad_()
                grads_stages[k], (cot,) = _grads(fns.stage(w, xk), w, cot,
                                                 extra=(xk,))
            w = _leaves_like(bwd_weights(0, ("outer", "in")))
            g_in, _ = _grads(fns.embed(w, batch), w, cot)
        grads = {"outer": {"in": g_in, "out": g_out},
                 "stages": grads_stages}

        # ---- update (producing version t_c + 1) ---------------------------
        if self.clip:
            grads, _ = sgd.clip_by_global_norm(grads, self.clip)
        new_p, new_m = _clone(self.hist[t_c]), _clone(self.mhist[t_c])
        groups = [(new_p["outer"], new_m["outer"], grads["outer"])] + [
            (new_p["stages"][k], new_m["stages"][k], grads["stages"][k])
            for k in range(N)]
        for p, m, g in groups:
            sgd.update(p, sgd.MomentumState(m), g, lr=self.lr,
                       gamma=self.gamma)
        self.hist[t_c + 1] = new_p
        self.mhist[t_c + 1] = new_m
        self.latest = t_c + 1

        metrics: Dict[str, Any] = {"loss": float(loss.detach()),
                                   "version": t_c + 1}

        # ---- Fig. 8: prediction-vs-stale RMSE on the actual trajectory ----
        for s in self.rmse_s:
            v0 = t_c + 1 - s
            if v0 in self.hist:
                pred = st.predict_weights(self.hist[v0], self.mhist[v0],
                                          self.lr, s)
                metrics[f"rmse_pred_s{s}"] = float(st.rmse(pred, new_p))
                metrics[f"rmse_stale_s{s}"] = float(
                    st.rmse(self.hist[v0], new_p))

        self._gc(t_c + 1 - max(2 * N, max(self.s_fwd) + 2,
                               max(self.rmse_s or (0,)) + 1))
        self.i += 1
        return metrics

    # ------------------------------------------------------------------
    @property
    def params(self):
        return self.hist[self.latest]


# ===========================================================================
# small staged models for tests / convergence benchmarks
# ===========================================================================


def make_mlp_staged(generator: torch.Generator, *, in_dim: int, width: int,
                    depth: int, n_classes: int, n_stages: int,
                    sizes: Optional[Sequence[int]] = None, device="cuda"
                    ) -> Tuple[StagedFns, Any]:
    """SNN-style stacked-FC model split into ``n_stages`` stages, fp32.

    ``sizes``: per-stage layer counts (ragged, e.g. a DP partition's
    ``sizes()``); defaults to the uniform split (requires divisibility).
    The weights are drawn from ``generator`` on its own device and then
    moved to ``device``, so one CPU generator gives the same weights on
    the card and on the CPU.
    """
    dev = resolve_device(device)
    if sizes is None:
        if depth % n_stages:
            raise ValueError(f"{depth} layers do not split uniformly into "
                             f"{n_stages} stages; pass sizes")
        sizes = (depth // n_stages,) * n_stages
    sizes = tuple(int(n) for n in sizes)
    if len(sizes) != n_stages or sum(sizes) != depth or min(sizes) < 1:
        raise ValueError(f"sizes {sizes} do not split {depth} layers "
                         f"into {n_stages} stages")

    def dense(fan_in, fan_out):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=generator.device) / math.sqrt(fan_in)
        return {"w": w.to(dev), "b": torch.zeros((fan_out,), device=dev)}

    params = {"outer": {"in": dense(in_dim, width),
                        "out": dense(width, n_classes)},
              "stages": [{"layers": [dense(width, width)
                                     for _ in range(n)]} for n in sizes]}

    def embed(w, batch):
        return F.selu(batch["x"] @ w["w"] + w["b"])

    def stage(sp, x):
        for lw in sp["layers"]:
            x = F.selu(x @ lw["w"] + lw["b"])
        return x

    def head_loss(w, x, batch):
        logits = x @ w["w"] + w["b"]
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, batch["y"][:, None])[:, 0]
        return torch.mean(lse - gold)

    return StagedFns(embed, stage, head_loss), params


def staged_from_model(model, partition=None
                      ) -> Tuple[StagedFns, Callable[[Any], Any]]:
    """Adapt a dense ``repro_torch.models.Model`` into StagedFns.

    Returns (fns, repack) where ``repack(model_params)`` produces the
    simulator param layout.  ``partition``: an optional object with
    ``n_layers`` and ``sizes()`` (a planner ``Partition`` in the JAX
    package) — repack then builds ragged per-stage trees from its layer
    counts; one stage per pipeline stage (interleaved chunk-stages are
    not ported).
    """
    if partition is not None and partition.n_layers != model.cfg.n_layers:
        raise ValueError(f"partition covers {partition.n_layers} layers, "
                         f"model has {model.cfg.n_layers}")
    sizes = (partition.sizes() if partition is not None
             else tuple(model.stage_sizes))

    def repack(params):
        return {
            "outer": {"in": params["outer"], "out": params["outer"]},
            "stages": list(model.partition_stage_params(
                params["stages"], sizes, n_chunks=len(sizes))),
        }

    def embed(outer_in, batch):
        return model.embed(outer_in, batch)

    def stage(sp, x):
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return model.stage_apply(sp, (x, zero))[0]

    def head_loss(outer_out, x, batch):
        return model.head_loss(outer_out, x, batch["targets"])

    return StagedFns(embed, stage, head_loss), repack
