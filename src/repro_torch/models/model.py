"""Model assembly (twin of ``repro/models/model.py``): the serving half
(prefill, decode step, and the pipelined engine's per-chunk decode wave
and prefill lane) and the training half (stage apply, head loss,
whole-model forward and loss, stage repartitioning).

Parameters use the JAX package's ragged per-stage canonical layout:
``params["stages"]`` is a tuple of stage trees whose ``layers`` leaves
are ``[L_k, ...]`` (hybrid models add one ``shared`` attention block per
stage).  Both halves walk the layers through views of those stacks
(autograd accumulates each layer's gradient into its slice), so no
stage split is ever copied.  The decode cache follows JAX: for dense
models ``{"layers": {"k", "v": [L, b, max_seq, KV, hd]}}``; for rwkv6
and mamba2 the per-layer recurrent state stacked over ``L``; hybrid
models add ``{"shared": {"k", "v": [n_shared, ...]}}``.  The decode step
and prefill fill it in place.  The SSM families serve only: their scan
kernels have no backward, as in the JAX package.  ``cfg.remat`` is not
ported: the streaming runtime recomputes each stage from its stashed
input anyway.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dtype_of, embed_apply, embed_specs,
                                       init_params, leaf_is_weight,
                                       norm_apply, norm_specs, softmax_xent,
                                       stack_specs, tree_map, unembed_apply)
from repro_torch.models.transformer import (block_apply, block_specs,
                                            check_ported,
                                            shared_block_apply,
                                            shared_block_specs)


def uniform_stage_sizes(n_layers: int, n_stages: int) -> Tuple[int, ...]:
    """Equal-count contiguous split, remainder spread over early stages."""
    if n_stages < 1 or n_layers < n_stages:
        raise ValueError(f"cannot split {n_layers} layers into "
                         f"{n_stages} stages (a stage would be empty)")
    base, rem = divmod(n_layers, n_stages)
    return tuple(base + (1 if s < rem else 0) for s in range(n_stages))


def split_flat_stages(flat_stages, sizes) -> Tuple[Any, ...]:
    """Flat ``{"layers": [L, ...](, "shared": [S, ...])}`` -> ragged
    per-stage trees for ``sizes`` (views, not copies)."""
    out, lo = [], 0
    for k, n in enumerate(sizes):
        tree = {"layers": tree_map(lambda _, a, lo=lo, n=n: a[lo:lo + n],
                                   flat_stages["layers"])}
        if "shared" in flat_stages:
            tree["shared"] = tree_map(lambda _, a, k=k: a[k],
                                      flat_stages["shared"])
        out.append(tree)
        lo += n
    return tuple(out)


def flat_stage_layers(stages):
    """Merge ragged stage trees to one flat ``[L, ...]`` tree (a single
    stage is returned as is; more are concatenated, which copies)."""
    if len(stages) == 1:
        return stages[0]["layers"]
    trees = [t["layers"] for t in stages]
    return tree_map(
        lambda path, _: torch.cat([_at(t, path) for t in trees], 0),
        trees[0])


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _n_layers(stage) -> int:
    return int(stage["layers"]["ln1"]["scale"].shape[0])


def cast_for_compute(params, dtype: torch.dtype):
    """Cast every weight to the compute dtype once, leaving the leaves
    the forward reads in fp32 (``layers.FP32_LEAVES``) as they are: the
    forward then reads the same values the JAX twin's per-call
    ``.astype(dt)`` gives, without casting per token."""
    return tree_map(lambda path, a: a.to(dtype) if leaf_is_weight(path)
                    else a, params)


class Model:
    """Functional model wrapper for one dense, rwkv6 or mamba2/hybrid
    ``ArchConfig`` on one device (``cuda`` by default; raises there if no
    card is present)."""

    def __init__(self, cfg, device="cuda"):
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        plan = cfg.mesh_plan
        self.n_stages = (plan.pipe if plan.pipe_role == "stage"
                         and plan.pipe > 1 else 1)
        self.stage_sizes = uniform_stage_sizes(cfg.n_layers, self.n_stages)
        self.hybrid = (cfg.ssm is not None
                       and cfg.ssm.shared_attn_every > 0)

    def kernel_modules(self):
        """The kernel wrappers this model's forward launches on the card,
        each with a ``load()`` that builds its kernel."""
        mods = []
        if self.cfg.ssm is None or self.hybrid:
            mods.append(fa)
        if self.cfg.ssm is not None:
            mods.append(r6 if self.cfg.ssm.kind == "rwkv6" else m2)
        return mods

    # ------------------------------------------------------------------ specs
    def _outer_specs(self) -> Dict[str, Any]:
        return {"embed": embed_specs(self.cfg), "ln_f": norm_specs(self.cfg)}

    def _flat_param_specs(self) -> Dict[str, Any]:
        """All layers in one ``[n_layers, ...]`` stack (hybrid shared
        blocks ``[S, ...]``), split per stage by :meth:`init`."""
        stages = {"layers": stack_specs(block_specs(self.cfg),
                                        self.cfg.n_layers, "layer")}
        if self.hybrid:
            stages["shared"] = stack_specs(shared_block_specs(self.cfg),
                                           self.n_stages, "stage")
        return {"outer": self._outer_specs(), "stages": stages}

    def init(self, generator: torch.Generator, *,
             dtype: Optional[str] = None):
        """Random parameters drawn from ``generator`` (which must live on
        the model's device) with the JAX package's distributions.  With
        ``dtype``, weights are stored in it as they are drawn (see
        :func:`cast_for_compute`); the fp32 leaves keep the param
        dtype."""
        leaf_fn = None
        if dtype is not None:
            dt = dtype_of(dtype)
            leaf_fn = (lambda path, a: a.to(dt) if leaf_is_weight(path)
                       else a)
        params = init_params(self._flat_param_specs(), generator,
                             self.cfg.param_dtype, self.device, leaf_fn)
        return {"outer": params["outer"],
                "stages": split_flat_stages(params["stages"],
                                            self.stage_sizes)}

    # ------------------------------------------------------------ layers
    def flat_layers(self, stages):
        return flat_stage_layers(stages)

    def iter_layers(self, stages) -> Iterator[Dict[str, Any]]:
        """Each layer's parameter tree, in flat order, as views."""
        for stage in stages:
            for i in range(_n_layers(stage)):
                yield tree_map(lambda _, a, i=i: a[i], stage["layers"])

    def _fires_shared(self, i: int) -> bool:
        """Whether a stage's shared block runs after its local layer
        ``i``: after every *full* ``shared_attn_every`` segment, the JAX
        rule ``hi < L_s or lo + k == L_s`` (a short last segment, or a
        stage shorter than k, never runs it)."""
        return self.hybrid and (i + 1) % self.cfg.ssm.shared_attn_every == 0

    def stage_apply(self, stage_params, carry, *, pos_offset: int = 0):
        """One pipeline stage of a dense model: its blocks in order.  The
        layer count is read off the tree's leading axis, so uniform and
        ragged stages run the same code.  carry = (x [b, s, d], aux
        scalar); these blocks add nothing to aux.  The SSM families have
        no pipeline stages in the port: they serve only, and their
        whole-model forward is :meth:`_recurrent_layers`."""
        if self.cfg.ssm is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: pipeline stages of the SSM families are "
                f"not ported to PyTorch (they serve only; their scan "
                f"kernels have no backward)")
        x, aux = carry
        for i in range(_n_layers(stage_params)):
            lp = tree_map(lambda _, a, i=i: a[i], stage_params["layers"])
            x, _, _ = block_apply(self.cfg, lp, x, pos_offset=pos_offset)
        return x, aux

    # ------------------------------------------------------- embed/head
    def embed(self, outer, batch):
        return embed_apply(self.cfg, outer["embed"], batch["tokens"])

    def head_loss(self, outer, x, targets):
        return softmax_xent(self.logits(outer, x), targets,
                            self.cfg.vocab_size)

    def logits(self, outer, x):
        x = norm_apply(self.cfg, outer["ln_f"], x)
        return unembed_apply(self.cfg, outer["embed"], x)

    # -------------------------------------------------- reference fwd
    def hidden(self, params, batch):
        """Final hidden states (pre-head).  Returns (x, aux_loss)."""
        x = self.embed(params["outer"], batch)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cfg.ssm is not None:
            return self._recurrent_layers(params["stages"], x), zero
        carry = (x, zero)
        for sp in params["stages"]:
            carry = self.stage_apply(sp, carry)
        return carry

    def forward(self, params, batch):
        """Full (non-pipelined) forward.  Returns (logits, aux_loss)."""
        x, aux = self.hidden(params, batch)
        return self.logits(params["outer"], x), aux

    def loss(self, params, batch):
        logits, aux = self.forward(params, batch)
        return softmax_xent(logits, batch["targets"],
                            self.cfg.vocab_size) + aux

    # --------------------------------------------------------- ragged stages
    def partition_stage_params(self, stages, sizes, *, n_chunks=None):
        """Regroup stage params into per-stage trees for ``sizes`` (a
        per-stage layer-count vector summing to ``cfg.n_layers``, a
        planner ``Partition.sizes()``).  ``stages`` is the ragged
        canonical tuple (any partition) or the legacy stacked layout
        ``{"layers": [S, Lps, ...]}``.  A ragged input whose sizes
        already match is returned as is; any other is merged through the
        flat layer order and split again (views of one flat copy).

        ``n_chunks``: the expected tree count when it is not the model's
        stage count: interleaved plans split the layers into ``S·v``
        chunk-stages (device d then holds chunks d, d+S, …, see
        :meth:`device_chunk_params`), and the pipelined engine splits
        them into its plan's stages whatever ``cfg.mesh_plan.pipe``
        says.  The JAX twin also asks that ``n_chunks`` fold onto the
        model's devices, which one card does not need.  Hybrid shared
        blocks are not ported (the SSM families serve only)."""
        ragged_in = isinstance(stages, (tuple, list))
        if any("shared" in t for t in (stages if ragged_in else [stages])):
            raise NotImplementedError(
                "hybrid shared blocks are not ported to PyTorch yet")
        sizes = tuple(int(n) for n in sizes)
        if sum(sizes) != self.cfg.n_layers:
            raise ValueError(f"partition sizes {sizes} do not cover "
                             f"{self.cfg.n_layers} layers")
        want = self.n_stages if n_chunks is None else n_chunks
        if len(sizes) != want:
            raise ValueError(f"{len(sizes)} partition stages for "
                             f"{want} (chunk-)stages")
        if min(sizes) < 1:
            raise ValueError(f"empty stage in partition sizes {sizes}")
        if not ragged_in:
            # stacked [S, Lps, ...] leaves: the flat order is S-major
            flat = tree_map(lambda _, a: a.reshape((-1,) + a.shape[2:]),
                            stages["layers"])
            return split_flat_stages({"layers": flat}, sizes)
        if tuple(_n_layers(t) for t in stages) == sizes:
            return tuple(stages)
        return split_flat_stages({"layers": flat_stage_layers(stages)},
                                 sizes)

    def device_chunk_params(self, chunk_trees, n_devices=None):
        """Group chunk-stage trees by hosting device: device ``d`` hosts
        chunk-stages ``d, d+S, …`` (Megatron's round-robin placement),
        so the result is a tuple of ``n_devices`` tuples of ``v`` trees
        (the layout a stage-local deployment holds per device)."""
        S = n_devices if n_devices is not None else self.n_stages
        C = len(chunk_trees)
        if S < 1 or C % S:
            raise ValueError(f"{C} chunk trees do not fold onto {S} devices")
        v = C // S
        return tuple(tuple(chunk_trees[c * S + d] for c in range(v))
                     for d in range(S))

    # ------------------------------------------------------------------ decode
    def init_cache(self, batch: int, max_seq: int):
        cfg = self.cfg
        dt = dtype_of(cfg.compute_dtype)
        stack = lambda one, n: {
            k: torch.zeros((n,) + tuple(a.shape), dtype=a.dtype,
                           device=self.device) for k, a in one.items()}
        if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
            one = ssm_mod.rwkv6_init_state(cfg, batch, dt, self.device)
            return {"layers": stack(one, cfg.n_layers)}
        kv = attn_mod.gqa_init_cache(cfg, batch, max_seq, dt, self.device)
        if cfg.ssm is None:
            return {"layers": stack(kv, cfg.n_layers)}
        one = ssm_mod.mamba2_init_state(cfg, batch, dt, self.device)
        cache = {"layers": stack(one, cfg.n_layers)}
        if self.hybrid:
            # exactly the shared-block calls of one decode step,
            # floor(L_s / k) per stage, kept >= 1 so that the cache tree
            # stays constructible (JAX's init_cache)
            k = cfg.ssm.shared_attn_every
            cache["shared"] = stack(kv, max(1, sum(
                n // k for n in self.stage_sizes)))
        return cache

    def decode_step(self, params, cache, token, pos: int):
        """token [b, 1] int64, pos a Python int -> (logits [b, 1, V'],
        cache).  The cache is updated in place and returned."""
        cfg = self.cfg
        outer = params["outer"]
        x = embed_apply(cfg, outer["embed"], token)
        if cfg.ssm is not None:
            x = self._recurrent_layers(params["stages"], x, cache, pos=pos)
            return self.logits(outer, x), cache
        ck, cv = cache["layers"]["k"], cache["layers"]["v"]
        for i, lp in enumerate(self.iter_layers(params["stages"])):
            x, _, _ = block_apply(cfg, lp, x,
                                  cache={"k": ck[i], "v": cv[i]}, pos=pos)
        return self.logits(outer, x), cache

    def prefill(self, params, batch, max_seq: int):
        """Whole-prompt causal forward building a decode cache:
        batch {"tokens": [b, s]} -> (logits [b, s, V'], cache).  For
        dense models the cache's first s positions hold the prompt's
        keys and values.  For rwkv6 and mamba2 every layer runs the
        whole prompt through one scan-kernel call and the cache holds
        the state after the prompt (and, for hybrid models, the shared
        blocks' keys and values), what JAX's ``SimpleEngine`` gets by
        stepping ``decode_step`` over the prompt."""
        outer = params["outer"]
        x = self.embed(outer, batch)
        s = x.shape[1]
        cache = self.init_cache(x.shape[0], max_seq)
        if self.cfg.ssm is not None:
            x = self._recurrent_layers(params["stages"], x, cache)
            return self.logits(outer, x), cache
        ck, cv = cache["layers"]["k"], cache["layers"]["v"]
        for i, lp in enumerate(self.iter_layers(params["stages"])):
            x, new_c, _ = block_apply(self.cfg, lp, x, cache={})
            ck[i, :, :s] = new_c["k"].to(ck.dtype)
            cv[i, :, :s] = new_c["v"].to(cv.dtype)
        return self.logits(outer, x), cache

    # ------------------------------------------------------ pipelined serve
    def _check_pageable(self, what: str) -> None:
        if self.hybrid:
            raise NotImplementedError(
                f"{what} does not support hybrid models ({self.cfg.name}): "
                f"their decode state is not a per-layer scan (tied shared "
                f"blocks); serve them with launch/serve.py's whole-model "
                f"SimpleEngine")

    def decode_embed(self, outer, tokens, pos):
        """Embed decode tokens at per-row positions: ``tokens`` [b, s],
        ``pos`` broadcastable to it (the decode wave's [R, 1], a prefill
        lane's [1, n]).  The JAX twin adds a sinusoidal term here for
        ``pos_embed="sinusoidal"``, which the port does not serve
        (``transformer.check_ported``); rope is applied in attention, so
        this is :meth:`embed`."""
        return embed_apply(self.cfg, outer["embed"], tokens)

    def stage_decode(self, stage_params, chunk_cache, x, pos, pages):
        """One chunk of the decode wave over R requests: x [R, 1, d];
        pos and pages int32 [R] on the model's device (idle rows on the
        trash page at position 0), pages in ``[0, n_pages]`` and pos in
        ``[0, page_seq)``, which the caller checks on the host (the
        paged kernel call does not); ``chunk_cache`` the chunk's paged
        cache (``serve.engine.chunk_page_caches``), updated in place.
        Returns y [R, 1, d].  Dense layers write each row's key and value at
        (page, pos) and attend through one paged kernel call for all
        rows; rwkv6 layers gather the rows' states from their pages, run
        the scan's decode kernel at b = R and write the states back.
        The JAX twin (``_decode_chunk`` over ``stage_decode``) vmaps a
        scalar-position decode over the requests."""
        self._check_pageable("stage_decode")
        bufs = chunk_cache["layers"]
        for i in range(_n_layers(stage_params)):
            lp = tree_map(lambda _, a, i=i: a[i], stage_params["layers"])
            if self.cfg.ssm is None:
                x, _, _ = block_apply(
                    self.cfg, lp, x, cache={"k": bufs["k"][i],
                                            "v": bufs["v"][i]},
                    pos=pos, pages=pages)
                continue
            st = {k: buf[i][pages] for k, buf in bufs.items()}
            x, _, _ = block_apply(self.cfg, lp, x, state=st)
            for k, buf in bufs.items():
                buf[i][pages] = st[k]
        return x

    def stage_prefill(self, stage_params, chunk_cache, x_seq, page: int):
        """One chunk of a prefill lane: x_seq [1, n, d], the lane's n
        valid prompt tokens, in one causal call per layer from a fresh
        state, written into page ``page`` of ``chunk_cache`` (dense:
        positions [0, n), later ones masked by the wave's per-row
        lengths; rwkv6: the state after the prompt).  Returns y_seq
        [1, n, d].  The JAX twin scans its stage_decode over the padded
        prompt from a fresh init page."""
        self._check_pageable("stage_prefill")
        bufs = chunk_cache["layers"]
        n = x_seq.shape[1]
        x = x_seq
        for i in range(_n_layers(stage_params)):
            lp = tree_map(lambda _, a, i=i: a[i], stage_params["layers"])
            if self.cfg.ssm is None:
                x, kv, _ = block_apply(self.cfg, lp, x, cache={})
                bufs["k"][i, page, :n] = kv["k"][0].to(bufs["k"].dtype)
                bufs["v"][i, page, :n] = kv["v"][0].to(bufs["v"].dtype)
                continue
            st = {k: buf[i][page:page + 1] for k, buf in bufs.items()}
            for a in st.values():
                a.zero_()                      # rwkv6's init state
            x, _, _ = block_apply(self.cfg, lp, x, state=st)
        return x

    def _recurrent_layers(self, stages, x, cache=None, *,
                          pos: Optional[int] = None):
        """Every layer of an rwkv6 or mamba2/hybrid model over x
        [b, s, d], each shared block after every full segment of its
        stage (:meth:`_fires_shared`, on the tree's actual partition).
        Without ``cache`` this is the stateless whole-sequence forward.
        With it, each block reads its state from the cache and writes
        the new one over it in place.  With ``pos`` (a Python int,
        s == 1) this is a decode step and each shared block attends to
        its KV slot's first pos + 1 positions; without, a prefill from
        position 0 whose shared blocks run causally and fill their
        slots' first s positions."""
        cfg = self.cfg
        g = slot = 0
        for stage in stages:
            for i in range(_n_layers(stage)):
                lp = tree_map(lambda _, a, i=i: a[i], stage["layers"])
                st = (None if cache is None else
                      {k: buf[g] for k, buf in cache["layers"].items()})
                x, _, _ = block_apply(cfg, lp, x, state=st)
                g += 1
                if not self._fires_shared(i):
                    continue
                if cache is None:
                    x, _ = shared_block_apply(cfg, stage["shared"], x)
                    continue
                sk, sv = cache["shared"]["k"][slot], cache["shared"]["v"][slot]
                if pos is None:
                    x, kv = shared_block_apply(cfg, stage["shared"], x,
                                               cache={})
                    sk[:, :x.shape[1]] = kv["k"].to(sk.dtype)
                    sv[:, :x.shape[1]] = kv["v"].to(sv.dtype)
                else:
                    x, _ = shared_block_apply(cfg, stage["shared"], x,
                                              cache={"k": sk, "v": sv},
                                              pos=pos)
                slot += 1
        return x


def from_jax_params(tree, cfg, *, device="cuda"):
    """The JAX package's parameter tree, as nested dicts of numpy arrays
    (``{"outer": ..., "stages": (per-stage {"layers": ...(, "shared":
    ...)}, ...)}``, a leading layer axis on every ``layers`` leaf, one
    shared block per stage for hybrid models), as the port's parameters
    on ``device``, leaf for leaf in the same dtypes."""
    dev = resolve_device(device)
    check_ported(cfg)

    def leaf(path, a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # ml_dtypes has no torch twin
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))     # a writable copy
        return t.to(dev)

    stages = tree["stages"]
    if not isinstance(stages, (tuple, list)):
        raise ValueError("expected the ragged per-stage tuple layout")
    keep = ("layers", "shared")
    return {"outer": tree_map(leaf, tree["outer"]),
            "stages": tuple(tree_map(leaf, {k: s[k] for k in keep if k in s})
                            for s in stages)}

