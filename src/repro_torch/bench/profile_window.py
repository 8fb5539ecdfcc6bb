"""How many device records ``torch.profiler`` loses at the edges of its
capture window, with and without a settling margin.

    python -m repro_torch.bench.profile_window [--trials 100] [--kernels 2000]

Each trial synchronizes the card, starts a CUDA-only profile, waits the
margin, launches one marker fill, ``--kernels`` small adds and a closing
matmul, synchronizes, waits the margin again and stops.  The raw kineto
events are then counted by kind.  A fill or a matmul missing from a
trial whose adds are all there is a record lost at the window's edge.
Prints one JSON line per margin: trials short of each kind, and the
least gaps between the window's ends (the profile's start, the host's
clock just before the stop) and the first and last kernel.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def _trial(x, a, n_kernels, margin_s):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    if margin_s:
        time.sleep(margin_s)
    x.fill_(1.0)
    for _ in range(n_kernels):
        x.add_(1.0)
    torch.mm(a, a)
    torch.cuda.synchronize()
    if margin_s:
        time.sleep(margin_s)
    stop_ns = time.time_ns()
    prof.__exit__(None, None, None)
    res = prof.profiler.kineto_results
    ev = [e for e in res.events() if e.device_type() == DeviceType.CUDA]
    kinds = {"fill": 0, "add": 0, "mm": 0}
    for e in ev:
        name = e.name().lower()
        kind = ("fill" if "fill" in name else "mm" if "gemm" in name
                or "cutlass" in name or "sm90" in name else "add")
        kinds[kind] += 1
    first = min((e.start_ns() for e in ev), default=None)
    last = max((e.end_ns() for e in ev), default=None)
    return kinds, (None if first is None else first - res.trace_start_ns(),
                   None if last is None else stop_ns - last)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trials", type=int, default=100)
    p.add_argument("--kernels", type=int, default=2000)
    p.add_argument("--margins-ms", default="0,20")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_window needs a CUDA card")
    x = torch.zeros(1024, device="cuda")
    a = torch.randn(1024, 1024, device="cuda")
    _trial(x, a, 10, 0.0)                       # the profiler's first start
    for margin_ms in (float(m) for m in args.margins_ms.split(",")):
        short = {"fill": 0, "add": 0, "mm": 0}
        head, tail = [], []
        for _ in range(args.trials):
            kinds, (h, t) = _trial(x, a, args.kernels, margin_ms / 1e3)
            want = {"fill": 1, "add": args.kernels, "mm": 1}
            for k in short:
                short[k] += kinds[k] < want[k]
            if h is not None:
                head.append(h)
                tail.append(t)
        print(json.dumps({
            "margin_ms": margin_ms, "trials": args.trials,
            "kernels": args.kernels, "trials_short": short,
            "min_head_us": min(head) / 1e3 if head else None,
            "min_tail_us": min(tail) / 1e3 if tail else None,
            "median_tail_us": sorted(tail)[len(tail) // 2] / 1e3
            if tail else None}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
