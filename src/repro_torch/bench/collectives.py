"""The data axis's collectives on the transport two ranks get: gloo's
ring ``all_reduce`` against its ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` on the same buffer, and ZeRO-1's forms of the
two (``StageGroup.reduce_scatter_mean`` / ``all_gather``) over a leaf of
that size.

    python -m repro_torch.bench.collectives [--device cpu] [--mib 256]

Two ranks (``launch.mesh.run_stage_ranks``): on the card they share it
and go through pinned host buffers (gloo-host), on the CPU plain gloo.
Each call is timed on rank 0's host clock between barriers, after one
warm-up call, as the median of ``--reps``.  Prints one line a call:
seconds and the buffer's MB/s.
"""
from __future__ import annotations

import argparse
import time
import warnings

import torch
import torch.distributed as dist


def _time(group, fn, reps: int) -> float:
    fn()
    out = []
    for _ in range(reps):
        group.barrier()
        t0 = time.perf_counter()
        fn()
        group.barrier()
        out.append(time.perf_counter() - t0)
    return sorted(out)[len(out) // 2]


def _rank(group, mib: int, reps: int) -> dict:
    warnings.simplefilter("ignore", FutureWarning)
    n = mib * 2**20 // 4
    N = group.world
    host = group.transport == "gloo-host"
    mk = (lambda k: torch.empty(k, pin_memory=True)) if host else \
        (lambda k: torch.empty(k, device=group.device))
    buf, part = mk(n), mk(n // N)
    buf.normal_()
    leaf = torch.randn(n, device=group.device)
    rows = {
        "all_reduce": lambda: dist.all_reduce(buf),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            part, buf),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            buf, part),
        "StageGroup.reduce_scatter_mean": lambda: group.reduce_scatter_mean(
            [leaf.clone()]),
        "StageGroup.all_gather": lambda: group.all_gather([leaf]),
    }
    return {name: _time(group, fn, reps) for name, fn in rows.items()}


def main(argv=None) -> int:
    from repro_torch.launch.mesh import run_stage_ranks
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mib", type=int, default=256,
                    help="the buffer (the all-reduce's bucket) in MiB")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    got = run_stage_ranks(_rank, 2, args.device, args=(args.mib, args.reps))
    mb = args.mib * 2**20 / 1e6
    for name, s in got[0].items():
        print(f"{name:<32} {s:.4f} s  {mb / s:.1f} MB/s of a {mb:.1f} MB "
              f"buffer")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
