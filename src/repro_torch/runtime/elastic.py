"""Elastic scaling and the stage-local layouts (twin of
``repro/runtime/elastic.py``).

Repartitioning keeps the flat layer order: stage weights regroup into
the new topology's ragged per-stage (or per-chunk) trees, momentum
follows, in-flight rings are re-initialised (an elastic event costs one
pipeline refill) and 2BW restarts its double buffer from the carried
weights.

Three layouts of one IR train state meet here:

  ragged   the SPMD state: ``params["stages"]`` one tree per chunk;
  packed   the JAX package's MPMD layout and the on-disk format of an
           MPMD checkpoint: ``[v, S, Lmax, ...]`` stage leaves and a
           ``chunk_sizes`` leaf (:func:`pack_mpmd_state` /
           :func:`unpack_mpmd_state`);
  local    one rank's part under ``execution="mpmd"``
           (``core.pipeline_stream.make_ir_state``): its own chunks,
           ``{}`` for the others, the outer leaves it reads.

:func:`gather_mpmd_state` collects the ranks' local states into the
ragged state on one rank and :func:`scatter_mpmd_state` is its inverse,
so an MPMD state and an SPMD state turn into one another.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import (_at, flat_stage_layers,
                                      pack_chunk_params, split_flat_stages,
                                      uniform_stage_sizes,
                                      unpack_chunk_params)
from repro_torch.runtime import sharding as rsh

_SEP = "/"


def _trees(state):
    """The (name, params-like tree) pairs of an IR state."""
    out = [("params", state["params"]), ("momentum", state["momentum"])]
    if "stash" in state:
        out += [("stash/params", state["stash"]["params"]),
                ("stash/momentum", state["stash"]["momentum"])]
    return out


def _with_trees(state, fn):
    """``state`` with every params-like tree ``t`` replaced by
    ``fn(t)``."""
    out = dict(state)
    out["params"] = fn(state["params"])
    out["momentum"] = fn(state["momentum"])
    if "stash" in state:
        out["stash"] = {"params": fn(state["stash"]["params"]),
                        "momentum": fn(state["stash"]["momentum"])}
    return out


def unpack_mpmd_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Packed MPMD state -> the ragged layout, detected by its
    ``chunk_sizes`` leaf (dropped); params, momentum and the 2BW stash
    unpack to per-chunk trees."""
    sizes = tuple(int(s) for s in torch.as_tensor(
        state["chunk_sizes"]).tolist())
    out = _with_trees(state, lambda t: {
        "outer": t["outer"],
        "stages": unpack_chunk_params(t["stages"], sizes)})
    del out["chunk_sizes"]
    return out


def pack_mpmd_state(state: Dict[str, Any], n_devices: int
                    ) -> Dict[str, Any]:
    """Ragged IR state -> the packed layout on ``n_devices`` (the JAX
    MPMD state's leaves, ``chunk_sizes`` an int32 tensor)."""
    sizes = [None]

    def pack(t):
        packed, sizes[0] = pack_chunk_params(list(t["stages"]), n_devices)
        return {"outer": t["outer"], "stages": packed}
    out = _with_trees(state, pack)
    out["chunk_sizes"] = torch.tensor(sizes[0], dtype=torch.int32)
    return out


def restack_stages(stages: Any, new_pipe: int) -> Any:
    """Legacy stacked ``[S, Lps, ...]`` -> ``[S', L/S', ...]`` in flat
    layer order (checkpoint migration and tests; the live path is
    :func:`reshard_params`)."""
    def leaf(_, a):
        total = a.shape[0] * a.shape[1]
        if total % new_pipe:
            raise ValueError(f"{total} layers not divisible by {new_pipe}")
        return a.reshape((new_pipe, total // new_pipe) + tuple(a.shape[2:]))
    return tree_map(leaf, stages)


def _shared_blocks(stages: Any) -> Optional[Any]:
    """The per-stage tied ``shared`` blocks of hybrid stage params as one
    ``[S, ...]`` stack (ragged trees are stacked, which copies), or None
    for a model without them."""
    if isinstance(stages, (tuple, list)):
        if "shared" not in stages[0]:
            return None
        trees = [t["shared"] for t in stages]
        return tree_map(lambda path, _: torch.stack(
            [_at(t, path) for t in trees]), trees[0])
    return stages.get("shared")


def reshard_params(params: Dict[str, Any], *, new_pipe: int,
                   sizes: Optional[Sequence[int]] = None,
                   old_pipe: Optional[int] = None) -> Dict[str, Any]:
    """Stage params (ragged or legacy stacked) -> the ragged trees of a
    new split ``sizes`` (default: the uniform split over ``new_pipe``),
    flat layer order kept (views of one flat copy).  The only hard error
    is an empty stage.  Hybrid models' per-stage shared blocks are tiled
    over the new stage count and cut to it, as the JAX twin does: stage
    k of the new split takes old block ``k % S_old``."""
    del old_pipe
    out = dict(params)
    raw = params["stages"]
    if isinstance(raw, (tuple, list)):
        flat = flat_stage_layers(raw)
    else:
        flat = tree_map(lambda _, a: a.reshape((-1,) + tuple(a.shape[2:])),
                        raw["layers"])
    L = int(tree_leaves(flat)[0].shape[0])
    sizes = uniform_stage_sizes(L, new_pipe) if sizes is None else \
        tuple(int(n) for n in sizes)
    if sum(sizes) != L or min(sizes) < 1:
        raise ValueError(f"sizes {sizes} do not tile {L} layers "
                         f"(empty stages are not executable)")
    flat_stages = {"layers": flat}
    shared = _shared_blocks(raw)
    if shared is not None:
        def tile(_, a):
            reps = -(-len(sizes) // a.shape[0])
            return a.repeat((reps,) + (1,) * (a.dim() - 1))[:len(sizes)]
        flat_stages["shared"] = tree_map(tile, shared)
    out["stages"] = split_flat_stages(flat_stages, sizes)
    return out


def elastic_restate(model_old, model_new, state: Dict[str, Any],
                    batch=None, *, mode: str = "spectrain",
                    ticks_per_step: int = 1, plan=None, registry=None,
                    execution: Optional[str] = None,
                    group=None) -> Dict[str, Any]:
    """The state of ``model_new`` (its plan ``plan``) carrying ``state``'s
    weights, momentum and step: a stream plan (or none) builds the tick
    runtime's state, an IR-schedule plan the interpreter's.  ``state`` is
    a whole state, ragged or packed (detected by ``chunk_sizes``); with
    ``execution="mpmd"`` and this rank's ``group`` the result is the
    rank's local part (every rank calls this with the whole state; to
    leave MPMD, :func:`gather_mpmd_state` first).  ``registry`` records
    one ``elastic_restate`` event."""
    from repro_torch.core import pipeline_stream as ps
    execution = execution or "spmd"
    if "chunk_sizes" in state:
        state = unpack_mpmd_state(state)
    ir_plan = plan is not None and plan.schedule in ps.IR_SCHEDULES
    if execution != "spmd" and not ir_plan:
        raise ValueError(f"execution={execution!r} needs an IR-schedule "
                         f"plan ({ps.IR_SCHEDULES})")
    sizes = plan.partition.sizes() if plan is not None else \
        model_new.stage_sizes

    def carried(tree):
        return reshard_params(tree, new_pipe=model_new.n_stages,
                              sizes=sizes)
    params = carried(state["params"])
    mom = carried(state["momentum"])
    if ir_plan:
        new = ps.make_ir_state(model_new, params, batch, plan=plan,
                               mode=mode, execution=execution, group=group)
        mom = {"outer": mom["outer"], "stages":
               model_new.partition_stage_params(mom["stages"], sizes,
                                                n_chunks=plan.n_chunks)}
        if execution == "mpmd":
            mom = ps.mpmd_local_params(model_new, mom, plan, group)
    else:
        new = ps.make_state(model_new, params, batch, mode=mode,
                            ticks_per_step=ticks_per_step, plan=plan)
    for dst, src in zip(tree_leaves(new["momentum"]), tree_leaves(mom)):
        dst.copy_(src)
    if "stash" in new:
        for name in ("params", "momentum"):
            for dst, src in zip(tree_leaves(new["stash"][name]),
                                tree_leaves(new[name])):
                dst.copy_(src)
    new["step"] = int(state["step"])
    if registry is not None:
        registry.emit(
            "elastic_restate", old_pipe=model_old.n_stages,
            new_pipe=model_new.n_stages,
            schedule=(plan.schedule if plan is not None else "stream"),
            execution=execution, step=new["step"])
    return new


# ------------------------------------------------------- gather / scatter
def _flat(tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    tree_map(lambda path, a: out.__setitem__(_SEP.join(path), a), tree)
    return out


def _holders(key: str, n_chunks: int, world: int, tied: bool):
    """The ranks holding the leaf at ``key`` (a path inside a
    params-like tree: ``stages/<q>/...`` or ``outer/...``)."""
    parts = key.split(_SEP)
    if parts[0] == "stages":
        return (rsh.chunk_rank(int(parts[1]), world),)
    return rsh.outer_leaf_ranks(parts[1:], n_chunks, world, tied)


def _unflatten(flat: Dict[str, Any], n_chunks: int):
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = root
        *head, last = key.split(_SEP)
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    root["stages"] = tuple(root.get("stages", {}).get(str(q), {})
                           for q in range(n_chunks))
    root.setdefault("outer", {})
    return root


def gather_mpmd_state(state: Dict[str, Any], model, plan, group, *,
                      dst: int = 0) -> Optional[Dict[str, Any]]:
    """The ranks' local MPMD states -> the whole ragged state on rank
    ``dst``, its leaves on the CPU (None on the other ranks).  Every
    rank of the group calls it.  A leaf two ranks hold (a tied
    embedding) is taken from the lower rank."""
    names = [n for n, _ in _trees(state)]
    mine = {f"{n}/{k}": t for n, tree in _trees(state)
            for k, t in _flat(tree).items()}
    metas = group.all_gather_object(
        [(k, tuple(t.shape), str(t.dtype).split(".")[-1])
         for k, t in mine.items()])
    if group.rank != dst:
        group.exchange([(mine[k], dst, rsh.TAG_CTL) for k, _, _ in
                        metas[group.rank]], [])
        return None
    got: Dict[str, torch.Tensor] = {}
    for src in range(group.world):
        if src == dst:
            leaves = [mine[k] for k, _, _ in metas[src]]
        else:
            leaves = group.exchange([], [
                (shape, getattr(torch, dt), src, rsh.TAG_CTL)
                for _, shape, dt in metas[src]])
        for (k, _, _), t in zip(metas[src], leaves):
            got.setdefault(k, t.detach().to("cpu", copy=True))
    out = {k: v for k, v in state.items() if k not in ("params",
                                                       "momentum", "stash")}
    for n in names:
        pre = n + _SEP
        tree = _unflatten({k[len(pre):]: t for k, t in got.items()
                           if k.startswith(pre)}, plan.n_chunks)
        if n.startswith("stash/"):
            out.setdefault("stash", {})[n.split(_SEP)[1]] = tree
        else:
            out[n] = tree
    return out


def scatter_mpmd_state(full: Optional[Dict[str, Any]], model, plan, group,
                       *, src: int = 0) -> Dict[str, Any]:
    """Inverse of :func:`gather_mpmd_state`: the whole ragged state on
    rank ``src`` (None elsewhere) -> each rank's local MPMD state, its
    leaves copied onto the rank's device.  Every rank calls it."""
    C, S = plan.n_chunks, group.world
    tied = model.cfg.tie_embeddings
    if group.rank == src:
        leaves = {f"{n}/{k}": t for n, tree in _trees(full)
                  for k, t in _flat(tree).items()}
        meta = ([(k, tuple(t.shape), str(t.dtype).split(".")[-1])
                 for k, t in leaves.items()],
                {k: v for k, v in full.items()
                 if k not in ("params", "momentum", "stash")})
    else:
        meta = None
    meta = group.all_gather_object(meta)[src]
    specs, rest = meta

    def held(key: str, r: int) -> bool:
        sub = key.split(_SEP)
        sub = sub[2:] if sub[0] == "stash" else sub[1:]
        return r in _holders(_SEP.join(sub), C, S, tied)

    if group.rank == src:
        sends = [(leaves[k], r, rsh.TAG_CTL) for r in range(S) if r != src
                 for k, _, _ in specs if held(k, r)]
        group.exchange(sends, [])
        mine = {k: leaves[k] for k, _, _ in specs if held(k, src)}
    else:
        want = [(k, shape, dt) for k, shape, dt in specs
                if held(k, group.rank)]
        got = group.exchange([], [(shape, getattr(torch, dt), src,
                                   rsh.TAG_CTL) for _, shape, dt in want])
        mine = {k: t for (k, _, _), t in zip(want, got)}
    mine = {k: t.detach().to(group.device, copy=True)
            for k, t in mine.items()}
    out = dict(rest)
    for n in ("params", "momentum", "stash/params", "stash/momentum"):
        pre = n + _SEP
        if not any(k.startswith(pre) for k, _, _ in specs):
            continue
        tree = _unflatten({k[len(pre):]: t for k, t in mine.items()
                           if k.startswith(pre)}, C)
        if n.startswith("stash/"):
            out.setdefault("stash", {})[n.split(_SEP)[1]] = tree
        else:
            out[n] = tree
    return out
