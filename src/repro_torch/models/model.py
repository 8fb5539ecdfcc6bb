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
models ``{"layers": {"k", "v": [L, b, max_seq, KV, hd]}}`` (MLA models
``{"layers": {"c_kv": [L, b, max_seq, kv_lora_rank], "k_rope": [L, b,
max_seq, rope]}}``, the raw latents); for rwkv6
and mamba2 the per-layer recurrent state stacked over ``L``; hybrid
models add ``{"shared": {"k", "v": [n_shared, ...]}}``.  The decode step
and prefill fill it in place.

Encoder-decoder models (whisper-base, the paper's transformer-paper)
keep the JAX twin's tree: ``params["stages"]`` is ``{"enc": [n_enc,
...], "dec": [L, ...]}`` (no pipeline stages; the decoder layers add
cross-attention), the outer tree adds ``ln_f_enc``.  :meth:`Model.encode`
runs the encoder over audio frames or source tokens, :meth:`Model.
encdec_prefill_cache` projects its output into each decoder layer's
cross K/V, and their cache is ``{"self": {"k", "v": [L, b, max_seq, KV,
hd]}, "cross": {"k", "v": [L, b, frames, KV, hd]}}``.  The vision
frontend (pixtral-12b) writes ``batch["patches"]`` over the first
positions of the embedded tokens.  MoE layers dispatch as the JAX twin's on
the training half and route each token alone on the serving half
(``models/moe.py``).  The SSM families (rwkv6, mamba2 and the zamba2
hybrid, whose stages apply their tied ``shared`` block after every
full segment) train through the same stages, their scans
differentiable through the scan kernels' backward.  ``cfg.remat`` is
not ported: the streaming runtime recomputes each stage from its
stashed input anyway.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, NamedTuple,
                    Optional, Tuple)

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
                                       norm_apply, norm_specs, sinusoid_at,
                                       sinusoidal_pos, softmax_xent,
                                       stack_specs, tree_leaves, tree_map,
                                       unembed_apply)
from repro_torch.models.transformer import (block_apply, block_specs,
                                            check_ported,
                                            shared_block_apply,
                                            shared_block_specs)

WHISPER_ENC_FRAMES = 1500  # fixed encoder context for decode shapes


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


def pack_chunk_params(chunks, n_devices: int):
    """Ragged chunk trees -> the JAX package's dense MPMD layout: every
    ``layers`` leaf becomes ``[v, S, Lmax, ...]`` with chunk ``q`` at
    index ``[q // S, q % S]``, zero-padded to ``Lmax = max(sizes)``
    rows.  Returns ``(packed_tree, sizes)``.  In the port this is the
    on-disk and interchange format only: a rank holds its own chunks as
    ragged trees and needs no padding.  Hybrid ``shared`` blocks have no
    layer stack to pad and are refused, as in JAX."""
    C, S = len(chunks), int(n_devices)
    if S < 1 or C % S:
        raise ValueError(f"{C} chunk trees do not fold onto {S} devices")
    if any("shared" in t for t in chunks):
        raise ValueError(
            "hybrid stage trees carry per-stage 'shared' blocks with no "
            "flat layer order; the packed MPMD layout does not cover them")
    sizes = tuple(int(tree_leaves(t["layers"])[0].shape[0]) for t in chunks)
    Lmax, v = max(sizes), C // S
    trees = [t["layers"] for t in chunks]

    def leaf(path, _):
        xs = [_at(t, path) for t in trees]
        out = xs[0].new_zeros((C, Lmax) + tuple(xs[0].shape[1:]))
        for q, x in enumerate(xs):
            out[q, :x.shape[0]] = x
        return out.reshape((v, S, Lmax) + tuple(xs[0].shape[1:]))

    return {"layers": tree_map(leaf, trees[0])}, sizes


def unpack_chunk_params(packed, sizes) -> Tuple[Any, ...]:
    """Inverse of :func:`pack_chunk_params`: ``[v, S, Lmax, ...]`` leaves
    back to the ragged chunk trees (padding rows dropped; views)."""
    sizes = tuple(int(n) for n in sizes)
    C = len(sizes)

    def flat(_, a):
        if a.shape[0] * a.shape[1] != C:
            raise ValueError(
                f"packed leaf folds {a.shape[0] * a.shape[1]} chunks, "
                f"sizes cover {C}")
        return a.reshape((C,) + tuple(a.shape[2:]))

    rows = tree_map(flat, packed["layers"])
    return tuple({"layers": tree_map(lambda _, a, q=q: a[q, :sizes[q]],
                                     rows)} for q in range(C))


class _Rows:
    """One drawn layer leaf's rows, by chunk (a leaf to ``tree_map``)."""
    __slots__ = ("by_chunk",)

    def __init__(self, by_chunk):
        self.by_chunk = by_chunk

    def __getitem__(self, q):
        return self.by_chunk[q]


def _pruned(tree):
    """``tree`` without its None leaves and the dicts left empty."""
    if isinstance(tree, dict):
        out = {k: _pruned(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree


def _n_layers(stage) -> int:
    return int(stage["layers"]["ln1"]["scale"].shape[0])


def layer_views(layers) -> Iterator[Dict[str, Any]]:
    """Each layer's parameter tree of a stacked ``[L, ...]`` tree, in
    order, as views."""
    for i in range(int(layers["ln1"]["scale"].shape[0])):
        yield tree_map(lambda _, a, i=i: a[i], layers)


def _weight_dtype(dtype: Optional[str]):
    """``init_params``' ``store``: every weight in ``dtype`` (the fp32
    leaves of ``layers.FP32_LEAVES`` and everything when ``dtype`` is
    None keep the param dtype)."""
    if dtype is None:
        return None
    dt = dtype_of(dtype)
    return lambda path: dt if leaf_is_weight(path) else None


def cast_for_compute(params, dtype: torch.dtype):
    """Cast every weight to the compute dtype once, leaving the leaves
    the forward reads in fp32 (``layers.FP32_LEAVES``) as they are: the
    forward then reads the same values the JAX twin's per-call
    ``.astype(dt)`` gives, without casting per token."""
    return tree_map(lambda path, a: a.to(dtype) if leaf_is_weight(path)
                    else a, params)


class Model:
    """Functional model wrapper for one dense (GQA or MLA), MoE, rwkv6,
    mamba2/hybrid or encoder-decoder ``ArchConfig`` on one device
    (``cuda`` by default; raises there if no card is present)."""

    def __init__(self, cfg, device="cuda"):
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        plan = cfg.mesh_plan
        self.n_stages = (plan.pipe if plan.pipe_role == "stage"
                         and plan.pipe > 1 and not cfg.is_encdec else 1)
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
        outer = {"embed": embed_specs(self.cfg), "ln_f": norm_specs(self.cfg)}
        if self.cfg.is_encdec:
            outer["ln_f_enc"] = norm_specs(self.cfg)
        return outer

    def param_specs(self) -> Dict[str, Any]:
        """Specs in the canonical layout (the JAX model's
        ``param_specs``): the ragged per-stage tuple, ``layers`` leaves
        ``[L_k, ...]``, one ``shared`` block per stage for hybrid
        models; for enc-dec models the ``{"enc", "dec"}`` stacks."""
        cfg = self.cfg
        if cfg.is_encdec:
            return {"outer": self._outer_specs(), "stages": {
                "enc": stack_specs(block_specs(cfg), cfg.n_enc_layers,
                                   "layer"),
                "dec": stack_specs(block_specs(cfg, cross=True),
                                   cfg.n_layers, "layer")}}
        stages = []
        for n in self.stage_sizes:
            tree: Dict[str, Any] = {
                "layers": stack_specs(block_specs(self.cfg), n, "layer")}
            if self.hybrid:
                tree["shared"] = shared_block_specs(self.cfg)
            stages.append(tree)
        return {"outer": self._outer_specs(), "stages": tuple(stages)}

    def param_axes(self) -> Dict[str, Any]:
        """Every leaf's logical axis names (:meth:`param_specs`' axes)."""
        return tree_map(lambda _, sp: sp.axes, self.param_specs())

    def _flat_param_specs(self) -> Dict[str, Any]:
        """All layers in one ``[n_layers, ...]`` stack (hybrid shared
        blocks ``[S, ...]``), split per stage by :meth:`init` (enc-dec
        models: :meth:`param_specs`, which has no stages)."""
        if self.cfg.is_encdec:
            return self.param_specs()
        stages = {"layers": stack_specs(block_specs(self.cfg),
                                        self.cfg.n_layers, "layer")}
        if self.hybrid:
            stages["shared"] = stack_specs(shared_block_specs(self.cfg),
                                           self.n_stages, "stage")
        return {"outer": self._outer_specs(), "stages": stages}

    def init(self, generator: torch.Generator, *,
             dtype: Optional[str] = None,
             tensor: Optional[Tuple[int, int]] = None):
        """Random parameters drawn from ``generator`` (which must live on
        the model's device) with the JAX package's distributions.  With
        ``dtype``, weights are stored in it as they are drawn (see
        :func:`cast_for_compute`); the fp32 leaves keep the param
        dtype.  ``tensor=(rank, T)``: the whole model is drawn leaf by
        leaf as without it (the same values) and of each leaf the rules
        shard over a tensor axis of T only the rank's block is kept
        (``runtime.sharding.tensor_leaf_dims``), each draw freed before
        the next."""
        leaf_fn = None
        if tensor is not None and tensor[1] > 1:
            from repro_torch.runtime import sharding as rsh
            t, T = tensor
            dims = rsh.tensor_leaf_dims(self.cfg, self, T)

            def leaf_fn(path, a):
                return rsh.tensor_leaf(path, a, dims, t, T)
        params = init_params(self._flat_param_specs(), generator,
                             self.cfg.param_dtype, self.device, leaf_fn,
                             store=_weight_dtype(dtype))
        if self.cfg.is_encdec:
            return params
        return {"outer": params["outer"],
                "stages": split_flat_stages(params["stages"],
                                            self.stage_sizes)}

    def init_part(self, generator: torch.Generator, sizes, chunks,
                  keep_outer: Callable[[Tuple[str, ...]], bool], *,
                  dtype: Optional[str] = None):
        """The part of :meth:`init`'s draw that one stage rank holds: the
        whole model is drawn from ``generator`` leaf by leaf, as
        :meth:`init` draws it (the same values), and of each leaf only
        the layer rows of the chunks ``chunks`` of the split ``sizes``
        and the outer leaves whose path ``keep_outer`` accepts are kept,
        each draw freed before the next.  Returns ``{"outer": the kept
        leaves, "stages": one tree per chunk, {} where not kept}``.
        Hybrid shared blocks and enc-dec trees are not covered."""
        if self.hybrid or self.cfg.is_encdec:
            raise NotImplementedError(
                "init_part keeps layer rows; hybrid shared blocks and "
                "enc-dec stacks have no flat layer order of stages")
        sizes = tuple(int(n) for n in sizes)
        if sum(sizes) != self.cfg.n_layers:
            raise ValueError(f"partition sizes {sizes} do not cover "
                             f"{self.cfg.n_layers} layers")
        lo = np.cumsum((0,) + sizes)
        chunks = tuple(sorted(chunks))

        def leaf_fn(path, a):
            if path[0] == "stages":
                return _Rows({q: a[lo[q]:lo[q + 1]].clone() for q in chunks})
            return a if keep_outer(path[1:]) else None
        flat = init_params(self._flat_param_specs(), generator,
                           self.cfg.param_dtype, self.device, leaf_fn,
                           store=_weight_dtype(dtype))
        stages = tuple(
            {"layers": tree_map(lambda _, r, q=q: r[q],
                                flat["stages"]["layers"])}
            if q in chunks else {} for q in range(len(sizes)))
        return {"outer": _pruned(flat["outer"]), "stages": stages}

    # ------------------------------------------------------------ layers
    def flat_layers(self, stages):
        return flat_stage_layers(stages)

    def iter_layers(self, stages) -> Iterator[Dict[str, Any]]:
        """Each layer's parameter tree, in flat order, as views."""
        for stage in stages:
            yield from layer_views(stage["layers"])

    def _fires_shared(self, i: int) -> bool:
        """Whether a stage's shared block runs after its local layer
        ``i``: after every *full* ``shared_attn_every`` segment, the JAX
        rule ``hi < L_s or lo + k == L_s`` (a short last segment, or a
        stage shorter than k, never runs it)."""
        return self.hybrid and (i + 1) % self.cfg.ssm.shared_attn_every == 0

    def stage_apply(self, stage_params, carry, *, pos_offset: int = 0):
        """One pipeline stage: its blocks in order, and for a hybrid
        model its tied ``shared`` block after every full
        ``shared_attn_every`` segment (:meth:`_fires_shared`, the JAX
        twin's rule).  The layer count is read off the tree's leading
        axis, so uniform and ragged stages run the same code.  carry =
        (x [b, s, d], aux scalar), to which each MoE block adds its
        load-balance loss, as the JAX twin's ``_layer_body`` does."""
        self._check_staged("stage_apply")
        x, aux = carry
        for i in range(_n_layers(stage_params)):
            lp = tree_map(lambda _, a, i=i: a[i], stage_params["layers"])
            x, a, _, _ = block_apply(self.cfg, lp, x, pos_offset=pos_offset)
            if a is not None:
                aux = aux + a
            if self._fires_shared(i):
                x, _ = shared_block_apply(self.cfg, stage_params["shared"],
                                          x, pos_offset=pos_offset)
        return x, aux

    def _check_staged(self, what: str) -> None:
        if self.cfg.is_encdec:
            raise NotImplementedError(
                f"{what}: {self.cfg.name} is an encoder-decoder model, whose "
                f"{{'enc', 'dec'}} stacks are not pipeline stages (as in the "
                f"JAX package); train it through Model.loss")

    # ------------------------------------------------------- embed/head
    def embed(self, outer, batch):
        """Token embeddings [b, s, d] in the compute dtype; the vision
        frontend's ``batch["patches"]`` [b, P, d] replace the first P
        positions (the JAX twin's ``dynamic_update_slice`` at 0), and a
        sinusoidal model adds its table.  Enc-dec models embed in
        :meth:`forward`."""
        cfg = self.cfg
        if cfg.is_encdec:
            raise RuntimeError("use forward() for enc-dec")
        x = embed_apply(cfg, outer["embed"], batch["tokens"])
        if cfg.frontend == "vision" and "patches" in batch:
            patches = batch["patches"].to(x.dtype)
            x = torch.cat([patches, x[:, patches.shape[1]:]], 1)
        if cfg.pos_embed == "sinusoidal":
            x = x + sinusoidal_pos(x.shape[1], cfg.d_model, dtype=x.dtype,
                                   device=x.device)
        return x

    def head_loss(self, outer, x, targets):
        return softmax_xent(self.logits(outer, x), targets,
                            self.cfg.vocab_size,
                            vocab_padded=self.cfg.vocab_padded)

    def logits(self, outer, x):
        x = norm_apply(self.cfg, outer["ln_f"], x)
        return unembed_apply(self.cfg, outer["embed"], x)

    # -------------------------------------------------- reference fwd
    def hidden(self, params, batch):
        """Final hidden states (pre-head).  Returns (x, aux_loss)."""
        if self.cfg.is_encdec:
            return self._hidden_encdec(params, batch)
        x = self.embed(params["outer"], batch)
        carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
        for sp in params["stages"]:
            carry = self.stage_apply(sp, carry)
        return carry

    def forward(self, params, batch):
        """Full (non-pipelined) forward.  Returns (logits, aux_loss)."""
        x, aux = self.hidden(params, batch)
        return self.logits(params["outer"], x), aux

    def encode(self, params, batch):
        """The encoder stack -> enc_out [b, frames, d] (enc-dec models):
        ``batch["frames"]`` for the audio frontend, ``batch["src_tokens"]``
        through the shared embedding otherwise, plus the sinusoidal
        table, every encoder layer and ``ln_f_enc``.  The encoder's
        self-attention is causal, as the JAX twin's (its ``_layer_body``
        keeps ``block_apply``'s default; ROADMAP §C)."""
        cfg = self.cfg
        outer, stages = params["outer"], params["stages"]
        dt = dtype_of(cfg.compute_dtype)
        if cfg.frontend == "audio":
            x = batch["frames"].to(dt)
        else:
            x = embed_apply(cfg, outer["embed"], batch["src_tokens"])
        x = x + sinusoidal_pos(x.shape[1], cfg.d_model, dtype=dt,
                               device=x.device)
        for lp in layer_views(stages["enc"]):
            x, _, _, _ = block_apply(cfg, lp, x)
        return norm_apply(cfg, outer["ln_f_enc"], x)

    def encdec_prefill_cache(self, params, batch, max_seq: int):
        """Run the encoder and project its output into every decoder
        layer's cross keys and values: ``{"self": zeros [L, b, max_seq,
        KV, hd], "cross": {"k", "v": [L, b, frames, KV, hd]}}``."""
        cfg = self.cfg
        enc_out = self.encode(params, batch)
        b = enc_out.shape[0]
        kvs = [attn_mod.cross_kv(cfg, lp["xattn"], enc_out)
               for lp in layer_views(params["stages"]["dec"])]
        z = torch.zeros((cfg.n_layers, b, max_seq, cfg.n_kv_heads, cfg.hd),
                        dtype=enc_out.dtype, device=enc_out.device)
        return {"self": {"k": z, "v": z.clone()},
                "cross": {k: torch.stack([kv[k] for kv in kvs])
                          for k in ("k", "v")}}

    def _embed_decoder(self, outer, tokens, pos: int = 0):
        """The decoder's input: token embeddings plus the sinusoidal
        table at positions ``pos ..``."""
        cfg = self.cfg
        x = embed_apply(cfg, outer["embed"], tokens)
        return x + sinusoidal_pos(x.shape[1], cfg.d_model, pos,
                                  dtype=x.dtype, device=x.device)

    def _hidden_encdec(self, params, batch):
        enc_out = self.encode(params, batch)
        x = self._embed_decoder(params["outer"], batch["tokens"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in layer_views(params["stages"]["dec"]):
            x, a, _, _ = block_apply(self.cfg, lp, x, enc_out=enc_out)
            if a is not None:
                aux = aux + a
        return x, aux

    def loss(self, params, batch):
        return self.loss_and_aux(params, batch)[0]

    def loss_and_aux(self, params, batch):
        """(the loss, the MoE routers' aux loss it includes)."""
        logits, aux = self.forward(params, batch)
        return softmax_xent(logits, batch["targets"], self.cfg.vocab_size,
                            vocab_padded=self.cfg.vocab_padded) + aux, aux

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
        model's devices, which one card does not need.

        Hybrid models keep one tied ``shared`` block per stage: it stays
        with its stage index (a ragged input passes its trees' blocks
        through, a stacked one slices its ``[S, ...]`` stack), so the
        trees cannot be regrouped into another count, and virtual stages
        (``n_chunks`` above the stage count) are refused: sibling chunks
        would hold copies of a device's block that their updates fork,
        as the JAX twin refuses."""
        self._check_staged("partition_stage_params")
        ragged_in = isinstance(stages, (tuple, list))
        has_shared = "shared" in (stages[0] if ragged_in else stages)
        sizes = tuple(int(n) for n in sizes)
        if sum(sizes) != self.cfg.n_layers:
            raise ValueError(f"partition sizes {sizes} do not cover "
                             f"{self.cfg.n_layers} layers")
        want = self.n_stages if n_chunks is None else n_chunks
        if len(sizes) != want:
            raise ValueError(f"{len(sizes)} partition stages for "
                             f"{want} (chunk-)stages")
        if want > self.n_stages and has_shared:
            raise ValueError(
                f"virtual stages ({want} chunks on {self.n_stages} "
                f"devices) are unsupported for hybrid models: the "
                f"per-device shared block is tied across a device's "
                f"chunks and independent chunk updates would fork it")
        if min(sizes) < 1:
            raise ValueError(f"empty stage in partition sizes {sizes}")
        if ragged_in and has_shared and len(stages) != want:
            raise ValueError(
                f"cannot repartition {len(stages)} hybrid stage trees "
                f"into {want}: shared blocks are tied per stage")
        if not ragged_in:
            # stacked [S, Lps, ...] leaves: the flat order is S-major
            flat = tree_map(lambda _, a: a.reshape((-1,) + a.shape[2:]),
                            stages["layers"])
            out = split_flat_stages({"layers": flat}, sizes)
        elif tuple(_n_layers(t) for t in stages) == sizes:
            return tuple(stages)
        else:
            out = split_flat_stages({"layers": flat_stage_layers(stages)},
                                    sizes)
        if has_shared:
            out = tuple(
                {**t, "shared": (stages[k]["shared"] if ragged_in else
                                 tree_map(lambda _, a, k=k: a[k],
                                          stages["shared"]))}
                for k, t in enumerate(out))
        return out

    def stack_stage_params(self, stage_trees):
        """Inverse of :meth:`partition_stage_params` for uniform sizes:
        per-stage trees back to the legacy stacked ``{"layers": [S, Lps,
        ...](, "shared": [S, ...])}`` layout (copies; equal layer counts
        only)."""
        sizes = {_n_layers(t) for t in stage_trees}
        if len(sizes) != 1:
            raise ValueError(f"cannot stack ragged stages (sizes "
                             f"{sorted(sizes)}); uniform only")
        keys = ("layers", "shared") if "shared" in stage_trees[0] else \
            ("layers",)
        return {key: tree_map(
            lambda path, _, key=key: torch.stack(
                [_at(t[key], path) for t in stage_trees]),
            stage_trees[0][key]) for key in keys}

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
        if cfg.is_encdec:
            # the cross cache at the fixed encoder context, all zeros
            # until encdec_prefill_cache fills it (JAX's init_cache)
            return {n: stack(attn_mod.gqa_init_cache(
                cfg, batch, e, dt, self.device), cfg.n_layers)
                for n, e in (("self", max_seq),
                             ("cross", WHISPER_ENC_FRAMES))}
        if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
            one = ssm_mod.rwkv6_init_state(cfg, batch, dt, self.device)
            return {"layers": stack(one, cfg.n_layers)}
        kv = attn_mod.attn_init_cache(cfg, batch, max_seq, dt, self.device)
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
        cache).  The cache is updated in place and returned.  MoE layers
        route each row's token alone (``moe.moe_apply_tokens``); the JAX
        twin routes the b tokens of one call together, and its engines
        call it with b = 1."""
        cfg = self.cfg
        outer = params["outer"]
        if cfg.pos_embed == "sinusoidal":
            x = self._embed_decoder(outer, token, pos)
        else:
            x = embed_apply(cfg, outer["embed"], token)
        if cfg.is_encdec:
            return self._decode_encdec(params, cache, x, pos)
        if cfg.ssm is not None:
            x = self._recurrent_layers(params["stages"], x, cache, pos=pos)
            return self.logits(outer, x), cache
        bufs = cache["layers"]
        for i, lp in enumerate(self.iter_layers(params["stages"])):
            x, _, _, _ = block_apply(
                cfg, lp, x, cache={k: buf[i] for k, buf in bufs.items()},
                pos=pos)
        return self.logits(outer, x), cache

    def _decode_encdec(self, params, cache, x, pos: int):
        """Each decoder layer: a self-attention decode step into the
        self cache, then one cross-attention flash call of x's query
        against the layer's cached cross K/V over every key, unmasked
        (the JAX twin's ``_decode_encdec``), then the MLP."""
        sc, xc = cache["self"], cache["cross"]
        for i, lp in enumerate(layer_views(params["stages"]["dec"])):
            x, _, _, _ = block_apply(
                self.cfg, lp, x, cache={"k": sc["k"][i], "v": sc["v"][i]},
                pos=pos, cross_kv={"k": xc["k"][i], "v": xc["v"][i]})
        return self.logits(params["outer"], x), cache

    def prefill(self, params, batch, max_seq: int):
        """Whole-prompt causal forward building a decode cache:
        batch {"tokens": [b, s]} -> (logits [b, s, V'], cache).  For
        dense models the cache's first s positions hold the prompt's
        keys and values (MLA: its latents).  For rwkv6 and mamba2 every
        layer runs the whole prompt through one scan-kernel call and the
        cache holds the state after the prompt (and, for hybrid models,
        the shared blocks' keys and values), what JAX's ``SimpleEngine``
        gets by stepping ``decode_step`` over the prompt.  For the same
        reason an MoE layer routes each prompt token alone, with nothing
        dropped (``moe.moe_apply_tokens``).

        For enc-dec models the decoder runs the prompt causally against
        :meth:`init_cache`'s zero cross cache, whose cross term adds
        exactly 0, and the cache keeps it: what the JAX ``SimpleEngine``
        gets by stepping ``decode_step`` over the prompt from
        ``init_cache``, which never runs the encoder (ROADMAP §C); an
        encoded input goes through :meth:`encdec_prefill_cache` and
        :meth:`decode_step` instead."""
        outer = params["outer"]
        if self.cfg.is_encdec:
            return self._prefill_encdec(params, batch["tokens"], max_seq)
        x = self.embed(outer, batch)
        s = x.shape[1]
        cache = self.init_cache(x.shape[0], max_seq)
        if self.cfg.ssm is not None:
            x = self._recurrent_layers(params["stages"], x, cache)
            return self.logits(outer, x), cache
        bufs = cache["layers"]
        for i, lp in enumerate(self.iter_layers(params["stages"])):
            x, _, new_c, _ = block_apply(self.cfg, lp, x, cache={})
            for k, a in new_c.items():
                bufs[k][i, :, :s] = a.to(bufs[k].dtype)
        return self.logits(outer, x), cache

    def _prefill_encdec(self, params, tokens, max_seq: int):
        cache = self.init_cache(tokens.shape[0], max_seq)
        sc, xc = cache["self"], cache["cross"]
        x = self._embed_decoder(params["outer"], tokens)
        s = x.shape[1]
        for i, lp in enumerate(layer_views(params["stages"]["dec"])):
            x, _, kv, _ = block_apply(
                self.cfg, lp, x, cache={},
                cross_kv={"k": xc["k"][i], "v": xc["v"][i]})
            for k, a in kv.items():
                sc[k][i, :, :s] = a.to(sc[k].dtype)
        return self.logits(params["outer"], x), cache

    # ------------------------------------------------------ pipelined serve
    def _check_pageable(self, what: str) -> None:
        if self.hybrid or self.cfg.is_encdec:
            kind = "encoder-decoder" if self.cfg.is_encdec else "hybrid"
            raise NotImplementedError(
                f"{what} does not support {kind} models ({self.cfg.name}): "
                f"their decode state is not a per-layer scan (cross-"
                f"attention / tied shared blocks); serve them with "
                f"launch/serve.py's whole-model SimpleEngine")

    def decode_embed(self, outer, tokens, pos):
        """Embed decode tokens at per-row positions: ``tokens`` [b, s],
        ``pos`` an integer tensor broadcastable to it (the decode wave's
        [R, 1], a prefill lane's [1, n]), with the sinusoidal term at
        those positions for ``pos_embed="sinusoidal"`` (elementwise
        :meth:`decode_step`'s); rope is applied in attention."""
        x = embed_apply(self.cfg, outer["embed"], tokens)
        if self.cfg.pos_embed == "sinusoidal":
            x = x + sinusoid_at(pos, self.cfg.d_model).to(x.dtype)
        return x

    def stage_decode(self, stage_params, chunk_cache, x, pos, pages,
                     wave_len: Optional[int] = None):
        """One chunk of the decode wave over R requests: x [R, 1, d];
        pos and pages int32 [R] on the model's device (idle rows on the
        trash page at position 0), pages in ``[0, n_pages]`` and pos in
        ``[0, page_seq)``, which the caller checks on the host (the
        paged kernel call does not); ``chunk_cache`` the chunk's paged
        cache (``serve.engine.chunk_page_caches``), updated in place.
        Returns y [R, 1, d].  Dense layers write each row's key and value
        at (page, pos) and attend through one paged kernel call for all
        rows; MLA layers write each row's latents there, gather the rows'
        pages up to ``wave_len`` positions (``max(pos) + 1``, known on the
        host; None: the whole page), expand them and attend in one paged
        kernel call on the gathered rows; rwkv6 layers gather the rows'
        states from their pages, run the scan's decode kernel at b = R
        and write the states back.  The JAX twin (``_decode_chunk`` over
        ``stage_decode``) vmaps a scalar-position decode over the
        requests, so an MoE layer here routes each row's token alone
        (``moe.moe_apply_tokens``)."""
        self._check_pageable("stage_decode")
        bufs = chunk_cache["layers"]
        for i in range(_n_layers(stage_params)):
            lp = tree_map(lambda _, a, i=i: a[i], stage_params["layers"])
            if self.cfg.ssm is None:
                x, _, _, _ = block_apply(
                    self.cfg, lp, x,
                    cache={k: buf[i] for k, buf in bufs.items()}, pos=pos,
                    pages=pages, wave_len=wave_len)
                continue
            st = {k: buf[i][pages] for k, buf in bufs.items()}
            x, _, _, _ = block_apply(self.cfg, lp, x, state=st)
            for k, buf in bufs.items():
                buf[i][pages] = st[k]
        return x

    def stage_prefill(self, stage_params, chunk_cache, x_seq, page: int):
        """One chunk of a prefill lane: x_seq [1, n, d], the lane's n
        valid prompt tokens, in one causal call per layer from a fresh
        state, written into page ``page`` of ``chunk_cache`` (dense:
        keys and values, MLA: latents, at positions [0, n), later ones
        masked by the wave's per-row lengths; rwkv6: the state after the
        prompt).  Returns y_seq
        [1, n, d].  The JAX twin scans its stage_decode over the padded
        prompt from a fresh init page."""
        self._check_pageable("stage_prefill")
        bufs = chunk_cache["layers"]
        n = x_seq.shape[1]
        x = x_seq
        for i in range(_n_layers(stage_params)):
            lp = tree_map(lambda _, a, i=i: a[i], stage_params["layers"])
            if self.cfg.ssm is None:
                x, _, kv, _ = block_apply(self.cfg, lp, x, cache={})
                for k, a in kv.items():
                    bufs[k][i, page, :n] = a[0].to(bufs[k].dtype)
                continue
            st = {k: buf[i][page:page + 1] for k, buf in bufs.items()}
            for a in st.values():
                a.zero_()                      # rwkv6's init state
            x, _, _, _ = block_apply(self.cfg, lp, x, state=st)
        return x

    def _recurrent_layers(self, stages, x, cache, *,
                          pos: Optional[int] = None):
        """Every layer of an rwkv6 or mamba2/hybrid model over x
        [b, s, d], each shared block after every full segment of its
        stage (:meth:`_fires_shared`, on the tree's actual partition);
        each block reads its state from ``cache`` and writes the new one
        over it in place.  With ``pos`` (a Python int, s == 1) this is a
        decode step and each shared block attends to its KV slot's first
        pos + 1 positions; without, a prefill from position 0 whose
        shared blocks run causally and fill their slots' first s
        positions.  (The stateless forward is :meth:`stage_apply`'s.)"""
        cfg = self.cfg
        g = slot = 0
        for stage in stages:
            for i in range(_n_layers(stage)):
                lp = tree_map(lambda _, a, i=i: a[i], stage["layers"])
                st = {k: buf[g] for k, buf in cache["layers"].items()}
                x, _, _, _ = block_apply(cfg, lp, x, state=st)
                g += 1
                if not self._fires_shared(i):
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
    shared block per stage for hybrid models; ``{"enc", "dec"}`` stacks
    for enc-dec models), as the port's parameters on ``device``, leaf
    for leaf in the same dtypes."""
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
    if cfg.is_encdec:
        return {"outer": tree_map(leaf, tree["outer"]),
                "stages": tree_map(leaf, {k: stages[k]
                                          for k in ("enc", "dec")})}
    if not isinstance(stages, (tuple, list)):
        raise ValueError("expected the ragged per-stage tuple layout")
    keep = ("layers", "shared")
    return {"outer": tree_map(leaf, tree["outer"]),
            "stages": tuple(tree_map(leaf, {k: s[k] for k in keep if k in s})
                            for s in stages)}



# ===========================================================================
# cache logical axes and dry-run input shapes (the JAX twin's, read by the
# data rules: ``runtime.sharding.cache_specs`` / ``batch_specs``)
# ===========================================================================


class ShapeDtype(NamedTuple):
    """A model input's shape and dtype, allocated nowhere (the JAX
    twin's ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def cache_axes(model: Model):
    """Logical-axis tree mirroring :meth:`Model.init_cache`'s."""
    cfg = model.cfg
    gqa_ax = {"k": ("layer", "act_batch", "act_kvseq", "kv", "head_dim"),
              "v": ("layer", "act_batch", "act_kvseq", "kv", "head_dim")}
    if cfg.is_encdec:
        return {"self": gqa_ax, "cross": gqa_ax}
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return {"layers": {
            "x_tm": ("layer", "act_batch", "heads"),
            "x_cm": ("layer", "act_batch", "heads"),
            "S": ("layer", "act_batch", "heads", "head_dim", "head_dim"),
        }}
    if cfg.ssm is not None:
        ax = {"layers": {
            "conv_x": ("layer", "act_batch", None, "ssm"),
            "conv_bc": ("layer", "act_batch", None, None),
            "S": ("layer", "act_batch", "heads", "head_dim", "state"),
        }}
        if model.hybrid:
            ax["shared"] = gqa_ax
        return ax
    if cfg.mla is not None:
        return {"layers": {
            "c_kv": ("layer", "act_batch", "act_kvseq", None),
            "k_rope": ("layer", "act_batch", "act_kvseq", None),
        }}
    return {"layers": gqa_ax}


def input_specs(cfg, shape) -> Dict[str, Any]:
    """Stand-ins for every model input of a cell: ``shape`` has
    ``seq_len``, ``global_batch`` and ``kind`` (train | prefill |
    decode).  Tokens are int64, the port's index dtype (the JAX twin's
    are int32); a decode cell's cache is :meth:`Model.init_cache`'s tree
    of shapes, drawn on the meta device (nothing allocated)."""
    B, S = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    tok = lambda *s: ShapeDtype(s, torch.int64)
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": tok(B, S)}
        if shape.kind == "train":
            batch["targets"] = tok(B, S)
        if cfg.frontend == "audio":
            batch["frames"] = ShapeDtype((B, S, cfg.d_model), cdt)
        if cfg.frontend == "vision":
            batch["patches"] = ShapeDtype(
                (B, cfg.frontend_patches, cfg.d_model), cdt)
        return {"batch": batch}
    model = Model(cfg, device="cpu")
    model.device = torch.device("meta")
    cache = tree_map(lambda _, a: ShapeDtype(tuple(a.shape), a.dtype),
                     model.init_cache(B, S))
    return {"cache": cache, "token": tok(B, 1),
            "pos": ShapeDtype((), torch.int64)}
