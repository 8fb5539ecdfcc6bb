"""Spawning the stage ranks: the port's counterpart of building the JAX
package's ``pipe`` mesh (``repro/launch/mesh.py``) for stage-local
execution.

:func:`run_stage_ranks` runs ``fn(group, *args)`` in ``n_ranks``
processes started with ``torch.multiprocessing``'s ``spawn``, each
joined to one ``torch.distributed`` group through a ``FileStore`` in a
fresh temporary directory, and returns every rank's result in rank
order.  The parent waits with a deadline: when a rank raises or dies,
or the deadline passes, it kills the survivors and raises with the
failing rank's traceback, so a deadlock fails and never hangs.  When
``RANK`` / ``WORLD_SIZE`` are set (as under ``torchrun``) it joins that
group instead and runs ``fn`` in this process, returning ``[its
result]``.

As with any ``spawn`` start, each rank imports the caller's main module
again: a script that calls :func:`run_stage_ranks` keeps its work under
``if __name__ == "__main__":``.

On the CPU each rank runs one intra-op thread, so a rank's arithmetic
does not depend on how many cores the machine has.

The JAX module's production and smoke meshes are here as rank grids
(:func:`make_production_mesh`, :func:`make_smoke_mesh`: a
``runtime.mesh_utils.RankMesh`` of integer ranks).  They need no
device: no machine gives one process 256 cards, so they are the shape
arithmetic the sharding rules read.  The data-parallel launcher spawns
its replicas through :func:`run_stage_ranks` as well.
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.runtime import sharding
from repro_torch.runtime.mesh_utils import RankMesh


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod:   (pod=2, data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RankMesh(np.arange(int(np.prod(shape))).reshape(shape), axes)


def make_smoke_mesh(*, data: int = 2, model: int = 4) -> RankMesh:
    """Tiny (data, model) grid for CI-scale tests."""
    return RankMesh(np.arange(data * model).reshape(data, model),
                    ("data", "model"))


def _rank_entry(fn, rank: int, world: int, device: str, store_path: str,
                pg_timeout_s: float, cards, args: Sequence[Any],
                out) -> None:
    status, payload = "ok", None
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        group = sharding.init_stage_group(rank, world, device,
                                          store_path=store_path,
                                          timeout_s=pg_timeout_s,
                                          cards=cards)
        payload = fn(group, *args)
    except Exception:               # reported to the parent, which fails
        status, payload = "err", traceback.format_exc()
    out.put((rank, status, payload))
    if status == "ok":
        sharding.close_stage_group()
    out.close()
    out.join_thread()
    # a failed rank leaves at once: its peers may be blocked on it, and
    # the parent kills them
    os._exit(0 if status == "ok" else 1)


def run_stage_ranks(fn: Callable, n_ranks: int, device: str = "cuda", *,
                    args: Sequence[Any] = (), timeout_s: float = 900.0,
                    pg_timeout_s: float = 60.0,
                    cards: Optional[int] = None) -> List[Any]:
    """``[fn(group, *args) for each rank]``, run in ``n_ranks`` spawned
    processes (``fn`` and ``args`` must pickle; ``fn`` a module-level
    function).  ``timeout_s`` bounds the whole run, ``pg_timeout_s``
    every collective and point-to-point wait of the group; ``cards``
    spreads the ranks over the first this many cards (default all; the
    transport follows, ``runtime.sharding.choose_transport``)."""
    env = sharding.env_rank_world()
    if env is not None:
        rank, world = env
        if world != n_ranks:
            raise ValueError(f"WORLD_SIZE={world}, the run needs "
                             f"{n_ranks} ranks")
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        group = sharding.init_stage_group(rank, world, device,
                                          timeout_s=pg_timeout_s,
                                          cards=cards)
        try:
            return [fn(group, *args)]
        finally:
            sharding.close_stage_group()
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="stage_ranks_")
    out = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_entry, daemon=True,
        args=(fn, r, n_ranks, device, os.path.join(tmp, "store"),
              pg_timeout_s, cards, tuple(args), out))
        for r in range(n_ranks)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(results) < n_ranks:
            try:
                rank, status, payload = out.get(timeout=0.1)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(
                        f"stage rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode} before reporting")
                if time.monotonic() > deadline:
                    late = sorted(set(range(n_ranks)) - set(results))
                    raise TimeoutError(f"stage ranks {late} did not finish "
                                       f"within {timeout_s:.0f} s")
                continue
            if status != "ok":
                raise RuntimeError(f"stage rank {rank} of {n_ranks} "
                                   f"failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n_ranks)]


def draw_rank_part(model, sizes, seed: int, group, *,
                   dtype: Optional[str] = None):
    """The rank's part of the model the SPMD run draws from ``seed`` on
    the device (``Model.init_part`` over the chunk split ``sizes``: the
    rank's chunks and the outer leaves it reads).  The ranks draw in
    turn and each returns its draw's cache to the card before the next
    starts, so the whole model's transient is on the card once."""
    C, S, r = len(sizes), group.world, group.rank
    tied = model.cfg.tie_embeddings
    part = None
    for turn in range(S):
        if turn == r:
            gen = torch.Generator(device=group.device).manual_seed(seed)
            part = model.init_part(
                gen, sizes, sharding.local_chunks(r, C, S),
                lambda path: r in sharding.outer_leaf_ranks(path, C, S, tied),
                dtype=dtype)
            if group.device.type == "cuda":
                torch.cuda.empty_cache()
        group.barrier()
    return part
