"""Per-layer cost profiles feeding the stage partitioner (twin of
``repro/planner/profiler.py``).

Acquisition methods:

  * ``"analytic"`` — closed-form FLOPs from ``ArchConfig.param_count``
                   (2·params·tokens per matmul-dominated layer, plus the
                   attention's O(s²d)); always available.
  * ``"timed"``  — run one block of the port's ``models/transformer.py``
                   and measure it (the PipeDream approach: profile, don't
                   model): on the card with CUDA events after a warm-up,
                   on the CPU with ``perf_counter``.  FLOPs are
                   back-filled analytically so the partitioner's compute
                   terms stay populated.
  * ``"hlo"``    — count one block's forward on the ``meta`` device
                   under ``runtime/op_cost.CostCounter`` (the twin of the
                   JAX package's compiled-HLO counters,
                   ``runtime/hlo_cost.py``): the FLOPs the counter sees,
                   the flash kernels' by their ``cost()``; nothing is
                   allocated or run.
  * ``"auto"``   — ``"hlo"``, falling back to ``"analytic"`` only if
                   counting raises; the profile records the method that
                   was used.

All blocks of one config are identical, so one representative block is
profiled and replicated ``n_layers`` times; ``ModelProfile.scaled``
models heterogeneous stacks.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import torch

from repro_torch.models.layers import dtype_of


@dataclass(frozen=True)
class LayerProfile:
    name: str
    flops: float            # forward FLOPs for one (batch, seq) slab
    param_bytes: float
    act_bytes: float        # output activation bytes (cut cost if split here)
    time_s: float = 0.0     # measured fwd wall time (timed method only)


@dataclass(frozen=True)
class ModelProfile:
    arch: str
    method: str
    batch: int
    seq: int
    layers: Tuple[LayerProfile, ...]

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def total_flops(self) -> float:
        return sum(lp.flops for lp in self.layers)

    def scaled(self, scale: Sequence[float]) -> "ModelProfile":
        """Per-layer compute multipliers (heterogeneous-stack modelling)."""
        if len(scale) != self.n_layers:
            raise ValueError(f"{len(scale)} scales for {self.n_layers} layers")
        return replace(self, layers=tuple(
            replace(lp, flops=lp.flops * s, time_s=lp.time_s * s)
            for lp, s in zip(self.layers, scale)))


def synthetic_profile(compute: Sequence[float], *, act_bytes: float = 0.0,
                      name: str = "synthetic") -> ModelProfile:
    """Profile from raw per-layer compute costs (tests / benchmarks).

    ``act_bytes`` defaults to 0 so abstract unit-cost profiles don't get
    dominated by the bytes→seconds hardware conversion; pass real byte
    counts to make transfer terms meaningful."""
    return ModelProfile(name, "synthetic", 1, 1, tuple(
        LayerProfile(f"layer{j}", float(c), 0.0, float(act_bytes))
        for j, c in enumerate(compute)))


# ---------------------------------------------------------------------------
# analytic


def _per_layer_params(cfg) -> float:
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    body = max(0, cfg.param_count() - emb)
    return body / max(1, cfg.n_layers)


def _analytic_layer(cfg, batch: int, seq: int) -> LayerProfile:
    p = _per_layer_params(cfg)
    pdt = dtype_of(cfg.param_dtype).itemsize
    cdt = dtype_of(cfg.compute_dtype).itemsize
    tokens = batch * seq
    # matmul-dominated: 2 FLOPs per param per token, plus O(s²d) attention
    flops = 2.0 * p * tokens
    if cfg.ssm is None:
        flops += 4.0 * batch * seq * seq * cfg.n_heads * cfg.hd
    act = float(batch * seq * cfg.d_model * cdt)
    return LayerProfile("block", flops, p * pdt, act)


# ---------------------------------------------------------------------------
# timed: one representative block of the port


def _timed_layer(cfg, batch: int, seq: int, *, device="cuda",
                 iters: int = 3) -> LayerProfile:
    """Mean forward time of one block at ``[batch, seq, d_model]``, its
    weights in the compute dtype (as the training path reads them)."""
    from repro_torch import resolve_device
    from repro_torch.models.layers import init_params, leaf_is_weight
    from repro_torch.models.transformer import block_apply, block_specs

    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(
        block_specs(cfg), gen, cfg.param_dtype, dev,
        store=lambda path: cdt if leaf_is_weight(path) else None)
    x = torch.zeros((batch, seq, cfg.d_model), dtype=cdt, device=dev)

    def f():
        return block_apply(cfg, params, x)[0]

    with torch.no_grad():
        f()                                   # build + warm
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                f()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                f()
            dt = (time.perf_counter() - t0) / iters
    return replace(_analytic_layer(cfg, batch, seq), time_s=dt)


# ---------------------------------------------------------------------------
# hlo: one representative block counted on the meta device


def _hlo_layer(cfg, batch: int, seq: int) -> LayerProfile:
    """The FLOPs of one block's forward at ``[batch, seq, d_model]``, its
    weights in the param dtype (the JAX twin's ``_hlo_layer`` compiles
    the same function), counted on ``meta``."""
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.transformer import block_apply, block_specs
    from repro_torch.runtime.op_cost import CostCounter

    meta = torch.device("meta")
    params = tree_map(lambda _, sp: torch.empty(
        sp.shape, dtype=dtype_of(sp.dtype or cfg.param_dtype), device=meta),
        block_specs(cfg))
    cdt = dtype_of(cfg.compute_dtype)
    x = torch.empty((batch, seq, cfg.d_model), dtype=cdt, device=meta)
    with torch.no_grad(), CostCounter() as counter:
        block_apply(cfg, params, x)
    pdt = dtype_of(cfg.param_dtype).itemsize
    pbytes = sum(p.numel() for p in tree_leaves(params)) * pdt
    return LayerProfile("block", float(counter.flops), float(pbytes),
                        float(batch * seq * cfg.d_model * cdt.itemsize))


METHODS = ("auto", "hlo", "timed", "analytic")


def profile_model(cfg, *, batch: int = 1, seq: int = 32,
                  method: str = "auto", device="cuda") -> ModelProfile:
    """Per-layer profile for an ArchConfig (one entry per layer).
    ``device`` is where ``"timed"`` runs its block (the card unless
    ``"cpu"`` is asked for); the other methods compute on the host."""
    if method not in METHODS:
        raise ValueError(f"unknown profile method {method!r}")
    used = method
    if method in ("auto", "hlo"):
        try:
            layer = _hlo_layer(cfg, batch, seq)
            used = "hlo"
        except Exception:
            if method == "hlo":
                raise
            layer = _analytic_layer(cfg, batch, seq)
            used = "analytic"
    elif method == "timed":
        layer = _timed_layer(cfg, batch, seq, device=device)
    else:
        layer = _analytic_layer(cfg, batch, seq)
    layers = tuple(replace(layer, name=f"block{j}")
                   for j in range(cfg.n_layers))
    return ModelProfile(cfg.name, used, batch, seq, layers)
