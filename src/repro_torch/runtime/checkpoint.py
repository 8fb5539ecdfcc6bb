"""Atomic, async checkpointing with exact-resume semantics: the port's
twin of ``repro/runtime/checkpoint.py``, in the same on-disk format, so
a checkpoint written by either package restores into the other.

Layout:  <dir>/step_<N>/  shard_0.npz  +  manifest.json
Commit protocol: write into ``step_<N>.tmp`` then ``os.replace`` — a
directory either exists fully or not at all, so a crash mid-write can
never corrupt the restore path (restart just picks the previous step).
Saving is double-buffered: the host snapshot (device→numpy) happens on
the step path, the file write on a background thread.

Checkpoints are keyed by tree path, the keys joined by ``/`` exactly as
the JAX package spells them (``params/stages/0/layers/…``,
``w_stash/1/…``, ``step``, ``tick``): dict keys, and tuple / list
indices, in the order :func:`repro_torch.models.layers.tree_map` visits
them (JAX's).  Python ints (the port keeps ``step`` and ``tick`` as
ints) are written as int32 scalars, as JAX holds them, and restore as
ints.

bf16: numpy on the card's machine has no bf16 (no ``ml_dtypes``).  A
bf16 tensor is written widened to float32, exactly; the JAX ``restore``
reads that back to the same bf16 bits (an ``astype`` of representable
values), which it would not do with raw ``uint16`` bits (it converts
integers by value).  On restore into a bf16 leaf, a 2-byte ``V2``
(void) array — a JAX ``ml_dtypes.bfloat16`` leaf loaded without
``ml_dtypes`` — or a ``uint16`` array is read as the bf16 bits.

Three bit-exact migrations run at restore (see the JAX module for the
layouts): **stacked → ragged** (a pre-ragged ``[S, Lps, ...]`` leaf
serves stage ``k``'s key by slicing), **partition → partition** (a
checkpoint written under other stage sizes serves a layer-stack key by
concatenating its per-stage arrays to the flat ``[L, ...]`` order and
re-slicing the template's range; in-flight rings and per-stage
``shared`` blocks raise instead), and **packed ↔ ragged** (the MPMD
``[v, S, Lmax, ...]`` layout with its ``chunk_sizes`` leaf, in both
directions through the same flat layer order; ``chunk_sizes`` always
restores from the template's own value).

On a data axis (replicas of a data-parallel run, each holding the whole
model and its block of every microbatch's rows) a checkpoint keeps the
one-process layout: :func:`save_data` gathers the rings' rows over the
replicas in rank order and replica 0 writes; :func:`restore_data` reads
the whole state on every replica and keeps the replica's rows.  So a
checkpoint written under any number of replicas restores under any
other that splits its microbatches.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import tree_map

_SEP = "/"


def _key(path) -> str:
    return _SEP.join(path)


def _flat(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    tree_map(lambda path, leaf: out.append((_key(path), leaf)), tree)
    return out


def _host(key: str, leaf) -> np.ndarray:
    """A host copy of one leaf, in a dtype both packages read back."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    raise TypeError(f"checkpoint leaf {key!r} has type "
                    f"{type(leaf).__name__}")


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", np.shape(leaf)))


def save(ckpt_dir: str, state: Any, step: int, *, keep: int = 3,
         background: bool = False) -> "threading.Thread | None":
    """Write ``state`` as checkpoint ``step``, keeping the newest
    ``keep``.  The host snapshot is taken before this returns, so the
    caller may update the state in place at once; with ``background``
    the file write runs on the returned (started) thread."""
    os.makedirs(ckpt_dir, exist_ok=True)
    pairs = [(k, _host(k, leaf)) for k, leaf in _flat(state)]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"

    def _write():
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_0.npz"),
                 **{k: v for k, v in pairs})
        manifest = {"step": step, "keys": [k for k, _ in pairs],
                    "nshards": 1}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep)

    if background:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


# `<prefix>/stages/<k>/<rest>` (ragged canonical) whose stacked
# pre-ragged spelling is `<prefix>/stages/<rest>`; also covers the
# pipedream weight ring (`w_stash/<k>/…` ← stacked `w_stash/…`)
_RAGGED_KEY_RE = re.compile(r"^(.*/|)(stages|w_stash)/(\d+)/(.+)$")

# `<prefix>/stages/layers/<rest>` — the packed MPMD layout; the spelling
# collides with the pre-ragged stacked one, and `chunk_sizes`'s
# presence in the checkpoint disambiguates
_PACKED_KEY_RE = re.compile(r"^(.*/|)stages/(layers/.+)$")


def _pack_group(flat: np.ndarray, sizes, want, key: str) -> np.ndarray:
    """Serve a packed ``[v, S, Lmax, ...]`` template leaf from a group's
    flat ``[L, ...]`` layer stack (ragged → packed), zero padding."""
    total = sum(sizes)
    if flat.shape[0] != total:
        raise ValueError(
            f"checkpoint covers {flat.shape[0]} layers for the group of "
            f"{key!r}, packed template wants {total}")
    v, S = int(want[0]), int(want[1])
    if v * S != len(sizes):
        raise ValueError(
            f"packed template {key!r} holds {v * S} chunk slots, "
            f"chunk_sizes has {len(sizes)} entries")
    if tuple(flat.shape[1:]) != tuple(want[3:]):
        raise ValueError(
            f"checkpoint layers for {key!r} have per-layer shape "
            f"{tuple(flat.shape[1:])}, template wants {tuple(want[3:])}")
    out = np.zeros(tuple(want), flat.dtype)
    lo = 0
    for q, Lq in enumerate(sizes):
        out[q // S, q % S, :Lq] = flat[lo:lo + Lq]
        lo += Lq
    return out


def _migrate_stacked_leaf(key: str, data, want_shape) -> Optional[np.ndarray]:
    """Serve a ragged per-stage key from a pre-ragged stacked checkpoint
    (stage ``k`` is slice ``k`` of the leading axis); None when the key
    is not a ragged stage key or the stacked spelling is absent."""
    m = _RAGGED_KEY_RE.match(key)
    if m is None:
        return None
    old_key = f"{m.group(1)}{m.group(2)}/{m.group(4)}"
    if old_key not in data.files:
        return None
    stacked = data[old_key]
    k = int(m.group(3))
    if k >= stacked.shape[0]:
        raise ValueError(
            f"stacked checkpoint leaf {old_key!r} has {stacked.shape[0]} "
            f"stages; cannot serve stage {k} for {key!r}")
    arr = stacked[k]
    if tuple(arr.shape) != tuple(want_shape):
        raise ValueError(
            f"stacked checkpoint leaf {old_key!r} stage {k} has shape "
            f"{arr.shape}, template wants {tuple(want_shape)} — the "
            f"migration shim only covers uniform pre-ragged layouts")
    return arr


def _template_group_sizes(flat) -> dict:
    """{(prefix, rest): {stage index: leading dim}} over the template's
    ragged stage *layer* leaves: the partition the template wants."""
    groups: dict = {}
    for key, leaf in flat:
        m = _RAGGED_KEY_RE.match(key)
        if m is None or m.group(2) != "stages" or \
                not m.group(4).startswith("layers" + _SEP):
            continue
        groups.setdefault((m.group(1), m.group(4)),
                          {})[int(m.group(3))] = int(_shape(leaf)[0])
    return groups


def _repartition_slice(flat: np.ndarray, sizes: dict, k: int, want_shape,
                       key: str) -> np.ndarray:
    """Stage ``k``'s slice of a group's flat ``[L, ...]`` layer stack
    under the template partition ``sizes``."""
    total = sum(sizes[i] for i in sorted(sizes))
    if flat.shape[0] != total:
        raise ValueError(
            f"checkpoint covers {flat.shape[0]} layers for the group of "
            f"{key!r}, template wants {total}")
    lo = sum(sizes[i] for i in sorted(sizes) if i < k)
    arr = flat[lo:lo + sizes[k]]
    if tuple(arr.shape) != tuple(want_shape):
        raise ValueError(
            f"repartitioned leaf for {key!r} has shape {arr.shape}, "
            f"template wants {tuple(want_shape)}")
    return arr


def _as_leaf(arr: np.ndarray, leaf, key: str):
    """``arr`` in the template leaf's kind, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and (
                arr.dtype.kind == "V" or arr.dtype == np.uint16):
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, int):
        return int(arr)
    raise TypeError(f"template leaf {key!r} has type {type(leaf).__name__}")


def restore(ckpt_dir: str, template: Any, *, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore onto ``template``'s tree structure: a new tree whose
    leaves take each template leaf's kind, dtype and device (the
    template is not written).  Returns (state, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _flat(template)
    group_sizes = _template_group_sizes(flat)
    group_cache: dict = {}
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        packed_ckpt = "chunk_sizes" in data.files

        def tmpl_chunk_sizes(key):
            """The packed template's partition, from its own
            ``chunk_sizes`` leaf (never the checkpoint's)."""
            for k, leaf in flat:
                if k.rsplit(_SEP, 1)[-1] == "chunk_sizes":
                    return tuple(int(s) for s in leaf.tolist())
            raise KeyError(
                f"packed template leaf {key!r} has no sibling chunk_sizes "
                f"leaf to define its partition")

        def ckpt_group(prefix, rest):
            """(per-stage layer counts, flat [L, ...] concat) of one leaf
            group as the checkpoint stores it (flat is None when the
            checkpoint has no ragged keys for the group)."""
            g = (prefix, rest)
            if g not in group_cache:
                parts = []
                j = 0
                while f"{prefix}stages/{j}/{rest}" in data.files:
                    parts.append(data[f"{prefix}stages/{j}/{rest}"])
                    j += 1
                if not parts and packed_ckpt and \
                        f"{prefix}stages/{rest}" in data.files:
                    # packed: [v, S, Lmax, ...], chunk q at [q//S, q%S];
                    # strip each chunk's padding to its real layers
                    a = data[f"{prefix}stages/{rest}"]
                    sizes = tuple(int(s) for s in data["chunk_sizes"])
                    v, S = int(a.shape[0]), int(a.shape[1])
                    if v * S != len(sizes):
                        raise ValueError(
                            f"packed checkpoint leaf for {rest!r} holds "
                            f"{v * S} chunk slots, its chunk_sizes has "
                            f"{len(sizes)} entries")
                    a2 = a.reshape((v * S,) + a.shape[2:])
                    group_cache[g] = (sizes, np.concatenate(
                        [a2[q, :Lq] for q, Lq in enumerate(sizes)], axis=0))
                elif not parts and f"{prefix}stages/{rest}" in data.files:
                    # pre-ragged stacked [S, Lps, ...]: the same flat order
                    stacked = data[f"{prefix}stages/{rest}"]
                    group_cache[g] = (
                        (int(stacked.shape[1]),) * int(stacked.shape[0]),
                        stacked.reshape((-1,) + stacked.shape[2:]))
                else:
                    group_cache[g] = (
                        tuple(int(p.shape[0]) for p in parts),
                        np.concatenate(parts, axis=0) if parts else None)
            return group_cache[g]

        leaves = {}
        for key, leaf in flat:
            want = _shape(leaf)
            arr = None
            m = _RAGGED_KEY_RE.match(key)
            if key.rsplit(_SEP, 1)[-1] == "chunk_sizes":
                arr = np.asarray(tmpl_chunk_sizes(key), np.int32)
            elif m is not None and m.group(2) == "stages" and \
                    m.group(4).startswith("layers" + _SEP):
                # repartitioning is a group decision: compare the whole
                # stage-size vectors, never one leaf's shape
                grp = group_sizes.get((m.group(1), m.group(4)), {})
                tmpl_vec = tuple(grp[j] for j in sorted(grp))
                c_vec, c_flat = ckpt_group(m.group(1), m.group(4))
                if c_vec and (c_vec != tmpl_vec or packed_ckpt):
                    arr = _repartition_slice(c_flat, grp, int(m.group(3)),
                                             want, key)
            elif m is None:
                pm = _PACKED_KEY_RE.match(key)
                if pm is not None:
                    c_vec, c_flat = ckpt_group(pm.group(1), pm.group(2))
                    if c_flat is not None:
                        sizes = tmpl_chunk_sizes(key)
                        if not (c_vec == sizes and key in data.files and
                                tuple(data[key].shape) == want):
                            arr = _pack_group(c_flat, sizes, want, key)
            if arr is None and key in data.files:
                arr = data[key]
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"checkpoint leaf {key!r} has shape "
                        f"{tuple(arr.shape)}, template wants {want} — not a "
                        f"stage layer stack that can be repartitioned "
                        f"(in-flight rings and shared blocks do not cross "
                        f"partitions; re-init them instead)")
            if arr is None:
                arr = _migrate_stacked_leaf(key, data, want)
            if arr is None:
                raise KeyError(
                    f"checkpoint {d} has no leaf {key!r} (and no stacked "
                    f"or differently-partitioned spelling to migrate from)")
            leaves[key] = _as_leaf(arr, leaf, key)
    return tree_map(lambda path, _: leaves[_key(path)], template), step


# ----------------------------------------------------------- data axis
# the stream state's rings and the axis of their rows (a replica holds
# its block of every microbatch there); every other leaf is replicated
RING_ROW_DIMS = {"fwd_buf": 1, "bwd_buf": 1, "stash_x": 2, "batch_ring": 1}


def _momenta(state) -> List[Tuple[Tuple[str, ...], Any, Any]]:
    """The (path, params, momentum) of every momentum tree of a train
    state: ``momentum``, and 2BW's ``stash/momentum``."""
    out = [(("momentum",), state["params"], state["momentum"])]
    if isinstance(state.get("stash"), dict) and "momentum" in state["stash"]:
        out.append((("stash", "momentum"), state["stash"]["params"],
                    state["stash"]["momentum"]))
    return out


def _with(state, path, value):
    """``state`` with the sub-tree at ``path`` replaced (shallow copies)."""
    out = dict(state)
    if len(path) == 1:
        out[path[0]] = value
    else:
        out[path[0]] = _with(state[path[0]], path[1:], value)
    return out


def whole_state(state: Any, group, *, tensor=None, tensor_dims=None):
    """A grid rank's state with its ZeRO-1 momentum pieces gathered whole
    over the data ``group`` (``optim.sgd.whole_momentum``) and its
    tensor blocks over ``tensor`` by ``tensor_dims``
    (``runtime.sharding.gather_tensor``), on every rank (collectives of
    both groups); the rings keep the replica's rows."""
    from repro_torch.optim import sgd
    from repro_torch.runtime.sharding import gather_tensor
    for path, params, mom in _momenta(state):
        state = _with(state, path, sgd.whole_momentum(params, mom, group))
    if tensor is not None and tensor.world > 1:
        state = gather_tensor(state, tensor_dims, tensor)
    return state


def save_data(ckpt_dir: str, state: Any, step: int, group, *,
              keep: int = 3, background: bool = False, tensor=None,
              tensor_dims=None) -> "threading.Thread | None":
    """Checkpoint a rank's state of a ``(data, tensor)`` grid in the
    one-process layout: every rank calls it; ZeRO-1 momentum pieces are
    gathered whole over the data ``group`` (``optim.sgd.whole_momentum``),
    the tensor blocks over ``tensor`` by ``tensor_dims``
    (``runtime.sharding.gather_tensor``), and the rings' rows to replica
    0 in rank order (``StageGroup.gather_rows``); rank 0 of both writes
    (on a background thread with ``background``, returned there; None
    elsewhere).  What is left is written as it is: every replica holds
    the same bits."""
    state = whole_state(state, group, tensor=tensor,
                        tensor_dims=tensor_dims)

    def whole(path, leaf):
        d = RING_ROW_DIMS.get(path[0])
        return leaf if d is None else group.gather_rows(leaf, d)
    full = tree_map(whole, state)
    if group.rank or (tensor is not None and tensor.rank):
        return None
    return save(ckpt_dir, full, step, keep=keep, background=background)


def restore_data(ckpt_dir: str, state: Any, group, *,
                 step: Optional[int] = None, tensor=None,
                 tensor_dims=None) -> Tuple[Any, int]:
    """Every rank of a ``(data, tensor)`` grid: restore checkpoint
    ``step`` (default the newest) of the one-process layout onto
    ``state``'s structure, keeping the replica's block of the rings'
    rows, its tensor blocks (``tensor_dims``) and, where ``state`` holds
    ZeRO-1 momentum pieces, the replica's pieces.  Returns (state,
    step)."""
    from repro_torch.optim import sgd
    from repro_torch.runtime.sharding import gather_tensor, tensor_leaf
    N, r = group.world, group.rank
    sharded = [(path, params) for path, params, mom in _momenta(state)
               if N > 1 and sgd.is_shard(params, mom)]
    for path, params in sharded:
        state = _with(state, path, tree_map(
            lambda _, p: torch.empty(p.shape, dtype=torch.float32,
                                     device=p.device), params))
    split = tensor is not None and tensor.world > 1
    if split:       # whole shapes (the values are overwritten)
        state = gather_tensor(state, tensor_dims, tensor)

    def whole_like(path, leaf):
        d = RING_ROW_DIMS.get(path[0])
        if d is None:
            return leaf
        shape = list(leaf.shape)
        shape[d] *= N
        return torch.empty(shape, dtype=leaf.dtype, device=leaf.device)

    def mine(path, leaf):
        d = RING_ROW_DIMS.get(path[0])
        if d is None:
            return leaf
        b = leaf.shape[d] // N
        return leaf.narrow(d, r * b, b).clone()
    full, step = restore(ckpt_dir, tree_map(whole_like, state), step=step)
    out = tree_map(mine, full)
    if split:
        out = tree_map(lambda path, leaf: tensor_leaf(
            path, leaf, tensor_dims, tensor.rank, tensor.world), out)
    for path, _ in sharded:
        node, params = out, out["params"] if path[0] == "momentum" else \
            out["stash"]["params"]
        for k in path:
            node = node[k]
        out = _with(out, path, sgd.own_piece(params, node, r, N))
    return out, step


# ------------------------------------------------------------------ mpmd
def save_mpmd(ckpt_dir: str, state: Any, step: int, model, plan, group,
              *, keep: int = 3) -> None:
    """Checkpoint an MPMD state: every rank calls it; the ranks' states
    gather to rank 0 (``runtime.elastic.gather_mpmd_state``), which
    writes the JAX package's packed layout (``[v, S, Lmax, ...]`` stage
    leaves and ``chunk_sizes``), so JAX ``restore`` plus
    ``unpack_mpmd_state`` reads it.  Returns once the write is done on
    every rank."""
    from repro_torch.runtime import elastic
    full = elastic.gather_mpmd_state(state, model, plan, group)
    if group.rank == 0:
        save(ckpt_dir, elastic.pack_mpmd_state(full, group.world), step,
             keep=keep)
    group.barrier()


def restore_mpmd(ckpt_dir: str, state: Any, model, plan, group, *,
                 step: Optional[int] = None) -> Tuple[Any, int]:
    """Every rank: restore checkpoint ``step`` (default the newest) of
    any layout (packed, ragged, another partition) into this rank's MPMD
    ``state``'s layout.  Rank 0 reads it into the gathered whole state
    and scatters it back.  Returns (the rank's state, step)."""
    from repro_torch.runtime import elastic
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    full = elastic.gather_mpmd_state(state, model, plan, group)
    if group.rank == 0:
        full, step = restore(ckpt_dir, full, step=step)
    return elastic.scatter_mpmd_state(full, model, plan, group), step
