#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds, serves and trains on the
card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one NVIDIA card
(an H100 is what the numbers are for).  It imports nothing of JAX or of
the JAX package, and in phases:

  1. prints the card (nvidia-smi's name and power limit, torch's name
     and device count);
  2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/
     csrc`` (one nvcc per source, all five at once), with ptxas's
     registers and shared memory, and for the three bf16 tensor-core
     kernels (``flash_fwd_mma_kernel``, ``flash_bwd_dq_mma_kernel``,
     ``flash_bwd_dkv_mma_kernel``) and the scans' decode, scores and
     chunked kernels their registers, spills and static and dynamic
     shared memory;
  3. holds each kernel against its plain PyTorch version on the card
     (TF32 off for the plain versions): the flash forward at the serving
     paths' decode and prefill shapes (granite-8b's attention, head_dim
     128, and zamba2-1.2b's shared block, head_dim 64), the training
     shapes (the tick's batch of 8 rows, an IR round's microbatch of
     one row), the repository's kernel test cases in fp32 and in bf16, a
     long causal case and the packed-row edges of the bf16 kernel (G in
     {1, 2, 4, 8} with sq G off the 16- and 64-row blocks, kv_len off
     the 64-key tile, q_offset > 0 causal and not, head_dim 16 to 128,
     sq != sk) (2e-5 in fp32 on the FMA kernel, 2e-2 in bf16 on the
     tensor-core kernel, each launch counted by its variant); the paged
     rows of both forward kernels (the decode wave: R in {1, 3, 8} rows
     at lengths 1, 17 and 64, two rows on one trash page, d 128 and 64,
     fp32 and bf16, one launch a call); the flash
     backward (dq, dk/dv) at the training shapes, the repository's
     backward test case, a non-causal GQA case with masked keys, the
     same packed-row edges and the dk/dv kernel's own edges in bf16
     (atol 2e-5 / rtol 1e-3 in fp32, 2e-2 in bf16, both kernels on the
     tensor cores in bf16; dk and dv exactly zero past kv_len, and a
     rerun into NaN-filled outputs repeating the first bit for bit); the
     fused update on a ragged group of tensors, with and without the
     prediction and with bf16 gradients (1e-6 in fp32, 2e-2 in bf16),
     and (in phase 8) on the training path's two groups, a full-width
     stage and the outer tree; the two scans (``rwkv6_scan``,
     ``mamba2_scan``) in fp32 and bf16 at decode (s = 1, nonzero S0; the
     decode kernels), prefill (s = 12) and ragged (s = 37) (the stepwise
     kernels), s = 2048, 64, 65 and 200 with b 2 and exact-zero decays
     (the chunked kernels), mamba2 with g > 1, and rwkv6's decode wave
     (b 8, fp32 and bf16, S0 gathered from nonzero page states with two
     rows on one trash page, S_T scattered back), with the decays the
     models draw (down to ~1e-29 and ~1e-5): y and S_T (2e-5 in fp32;
     2e-2 on rwkv6's bf16 y), each call checked to launch the variant its
     length routes it to, and each also with S_T written over S0 in
     place, as the models call them;
  4. holds the port's models on the card against the same models on the
     CPU at the smoke size in fp32: granite serving (prefill, decode,
     engine tokens), rwkv6 and zamba2 serving (prefill and decode
     steps: logits and every state and KV leaf, 1e-4), and 2(S-1)+3
     streaming SpecTrain ticks on 4 stages (losses and every parameter,
     momentum and prediction leaf), and the pipelined ``ServeEngine``
     (granite and rwkv6, pipe 2: equal tokens, a clean request trace,
     one kernel a layer for each wave and prefill lane), each on the
     fp32 FMA attention kernels only (no tensor-core launch);
  5. drives the serving path, ``repro_torch.launch.serve.main``, on the
     full-width, full-depth rwkv6-7b (32 layers), zamba2-1.2b (38
     layers) and granite-8b (36 layers) in bf16 with random weights, one
     model at a time, and checks every admissible request got its
     tokens, the logits were finite and each kernel ran exactly as often
     as the path needs: per prefill and decode call 32 ``rwkv6_scan``;
     38 ``mamba2_scan`` and 2 ``flash_fwd`` (zamba2's shared attention);
     36 ``flash_fwd``; and nothing else; every ``flash_fwd`` on the
     bf16 tensor-core kernel, every decode step's scan on the decode
     kernel, no scan on the chunked kernels;
  6. profiles a few full-width decode steps of each of the three models
     (wall per step, device busy share, device time per kernel);
  7. drives the training path, ``repro_torch.launch.train.main``, on
     full-width granite-8b cut to 8 layers in 4 stages, bf16 compute,
     SpecTrain, 10 ticks; checks the losses are finite, the loss turns
     valid at tick S-1, stage 0's weights hold until tick 2(S-1) and
     move after it, and each tick launches exactly 2L flash forwards, L
     of each backward kernel and S+1 fused updates, every forward, dq
     and dk/dv on the tensor-core kernels; profiles one tick and checks the
     profile shows the same kernels;
  8. times every kernel at its main path's shapes beside its bound, its
     plain version and a library yardstick the port never calls
     (``scaled_dot_product_attention`` forward and backward, with the
     device kernels its backend ran; ``torch.optim.SGD(fused=True)``;
     none computes either recurrence): the flash forward at decode and
     prefill n = 12 of both serving models, causal 2048 and the training
     shape, the backward kernels at the training shape, the scans at
     decode (beside a copy of the same 1 MB state), prefill and s = 2048,
     each variant its own row, and the decode wave's paged call (R 8,
     ragged lengths) beside SDPA with a boolean key mask;
  9. (run after phase 6) drives ``repro_torch.launch.serve.main`` on
     full rwkv6-7b and zamba2-1.2b with long prompts (3 requests,
     1024-2048 tokens, generation 1-4): every request served with finite
     logits, every prefill's scans on the chunked kernels (32 or 38 per
     call) and every decode step's on the decode kernels, each request's
     time to first token, and one prefill of the longest prompt timed
     and profiled (wall, device busy, the scans' share).

The paper's evaluation adds three phases:

 10. (after phase 4) the simulator (``repro_torch.core.simulator``) on
     the card against the CPU, 10 steps of each of the four schemes for
     ``make_mlp_staged`` (4 stages, Fig. 8's RMSEs on) and for
     ``staged_from_model`` (the 4-layer smoke granite on 2 stages, fp32
     flash kernels): every metric and the final parameters within the
     CPU parity tests' rtol 1e-5 / atol 1e-6, N + 1 ``fused_update``
     launches a step; and checkpoint and exact resume through
     ``repro_torch.launch.train.main`` (4 layers, pipe 2, spectrain and
     pipedream): 6 ticks against 3, ``--resume auto`` and 3 more, the
     final checkpoints bit-equal;
 11. (after phase 7) the four schemes on the full-width, full-depth
     snn-paper (32 FC layers of 2048, input 3072, 10 classes, 4 stages,
     140,597,258 parameters, 8 versions held), batch 128 of the
     synthetic teacher task, 600 steps each at lr 0.01, then spectrain's
     first 300 steps again with Fig. 8's RMSEs at s = 1, 2, 3 (the
     same losses, step for step): ms per step (the median
     of the steady steps), device busy and idle share under
     ``torch.profiler``, final loss, held-out loss and accuracy, peak
     memory, exactly 5 ``fused_update`` launches a step (and nothing
     else), finite and falling losses, each scheme past the label
     prior (final loss below its entropy, held-out accuracy above the
     majority share), RMSE(pred) < RMSE(stale) at every s; the Table 1
     ordering printed against the JAX test's bounds; the kernel held
     against its plain version at the simulator's two groups (a stage
     tree, the outer tree) with the simulator's arguments, then timed
     beside ``torch.optim.SGD(fused=True)``;
 12. ``repro_torch.bench.rmse`` and ``.convergence`` on the card at
     their default (the JAX scripts') sizes.

The pipelined engine adds one phase:

 13. (after phase 6) ``repro_torch.launch.serve.main --engine
     pipelined`` on full-width, full-depth granite-8b and rwkv6-7b (pipe
     4, 8 slots and pages, 2 prefill lanes, bf16) over one Poisson
     trace of 24 requests (rate 2.0, prompts 2-12, generation 8-24),
     then ``SimpleEngine`` with the same weights on the same trace:
     every admissible request gets its tokens, live rows' logits
     finite, the request trace verifies, each request's first token
     equals ``SimpleEngine``'s, every round launches exactly L
     ``flash_fwd`` or ``rwkv6_scan`` for its wave and L a prefill lane
     (bf16 attention on the tensor cores, the wave's scans on the decode
     kernel); one full-width wave (8 live rows) against SimpleEngine's
     decode step taken row by row from the same page states, logits and
     each row's state after it, within ``WAVE_STEP_FACTOR`` times the
     steps' own distance from the same steps in fp32, and the engine's
     round from those states emitting the wave's argmax and leaving its
     pages; tok/s over ``run()``'s wall after warm-up for both engines
     (a second pipelined run of the trace, its tokens equal to the
     first's), p50/p99 and rounds beside ``SimpleEngine``'s, one steady
     decode round profiled (wall, busy, idle, kernels), the page writes
     and the rwkv6 state gather/scatter timed alone, peak memory.

The planner and the round schedules add two phases:

 14. (after phase 4) three IR rounds of gpipe, 1f1b, 2bw (spectrain,
     pipedream) and interleaved v2 through ``make_ir_state`` /
     ``make_ir_train_step`` on the card against the CPU (2 stages of a
     5-layer smoke granite in fp32, a ragged dp split): losses to rtol
     1e-5, every params, momentum and 2bw stash leaf to rtol 1e-4 / atol
     1e-5, on the fp32 FMA kernels only;
 15. (``ir_schedules``, after phase 7) ``fused_update`` at the IR
     update's full-width groups (a chunk tree of 1 and 2 layers, the
     outer tree; fp32 g, no ŵ), one launch each against its plain
     version; then ``repro_torch.launch.train.main`` on full-width
     granite-8b, 4 stages, batch 8 x 512, bf16, under gpipe, 1f1b, 2bw
     (spectrain, pipedream), interleaved (``--virtual-stages 2``, 8
     chunks of one layer) and 1f1b on 7 layers (the dp plan's (2, 2, 1,
     2), regrouped from the model's uniform (2, 2, 2, 1)), 4 rounds
     each: the dp plan printed and verified before the first round,
     finite losses,
     exactly 2·L·M ``flash_fwd``, L·M of each backward kernel and C + 1
     ``fused_update`` launches a round (M = 8 microbatches, C chunks),
     every attention launch on the tensor cores; a round's wall (median
     of the unprofiled steady rounds), tokens/s, one profiled round
     (busy, idle, kernels, ``fused_update`` ms), peak memory, and for
     2bw the stash copy's ms (CUDA events).

It prints the kernels' JSON line before its last line, which is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line, as does a machine without a card or a directory without the
repository's ``src/``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "granite-8b"
SSM_ARCHS = ("rwkv6-7b", "zamba2-1.2b")
# zamba2-1.2b's shared attention block: heads, KV heads, head_dim
ZAMBA2_ATTN = (32, 32, 64)
TIMEOUT_S = 60

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# fp32 FLOP/s outside the tensor cores (the kernel's fp32 path)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the backward's (atol, rtol): tests/test_kernels.py::test_flash_bwd's in
# fp32, the kernel tolerance in bf16
BWD_TOL = {"float32": (2e-5, 1e-3), "bfloat16": (2e-2, 2e-2)}
FU_TOL = {"float32": 1e-6, "bfloat16": 2e-2}

# the training path: full-width granite-8b, 8 layers in 4 stages
TRAIN_LAYERS, TRAIN_STAGES, TRAIN_STEPS = 8, 4, 10
TRAIN_BATCH, TRAIN_SEQ = 8, 512
# the IR rounds: the launcher's round-size rule splits the batch into
# IR_ROUND microbatches of IR_MB_ROWS rows
IR_ROUND = 8
IR_MB_ROWS = TRAIN_BATCH // IR_ROUND
TRAIN_ARGV = ["--arch", ARCH, "--layers", str(TRAIN_LAYERS),
              "--pipe", str(TRAIN_STAGES), "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--dtype", "bfloat16",
              "--mode", "spectrain", "--data-kind", "uniform",
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]

# tests/test_kernels.py's FLASH_CASES: b, H, KV, sq, sk, d, causal, dtype
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, True, "float32"),
    (1, 8, 2, 256, 256, 128, True, "float32"),
    (2, 4, 1, 128, 256, 64, False, "float32"),
    (1, 4, 4, 128, 128, 64, True, "bfloat16"),
    (1, 2, 2, 512, 512, 32, True, "float32"),
]


# the bf16 tensor-core kernels' packed-row edges: name, b, sq, sk, H, KV,
# d, causal, q_offset, kv_len (G = H / KV; 16- and 64-row blocks, 64-key
# tiles)
MMA_EDGES = [
    ("G1 37 rows", 2, 37, 37, 8, 8, 64, True, 0, 37),
    ("G2 42 rows offset 29", 1, 21, 50, 8, 4, 32, True, 29, 50),
    ("G4 52 rows kv_len 77", 2, 13, 100, 16, 4, 128, False, 0, 77),
    ("G8 24 rows offset 60", 1, 3, 70, 32, 4, 16, True, 60, 63),
    ("G8 16 rows one warp", 1, 2, 64, 16, 2, 64, False, 10, 12),
    ("G8 decode 3 key tiles", 1, 1, 200, 8, 1, 128, False, 130, 131),
    ("G2 200 rows offset 200", 2, 100, 300, 4, 2, 32, True, 200, 300),
    ("G1 d16 70 rows", 1, 70, 70, 2, 2, 16, True, 0, 70),
    ("G1 65 rows, row 64 opens a key tile", 1, 65, 65, 4, 4, 64, True, 0,
     65),
]

# the bf16 dk/dv kernel's own edges (64-key blocks over 64-row packed
# tiles), in the same form: a key block whose first key is the position
# of a row tile's first row; G 4 with the first row to see a block mid-
# tile; kv_len mid-block with sk > kv_len; sq 1 with G 8
DKV_EDGES = [
    ("G1 key block 1 at row tile 1", 1, 192, 192, 2, 2, 64, True, 0, 192),
    ("G4 first visible row mid-tile", 1, 40, 120, 8, 2, 128, True, 50,
     120),
    ("G2 kv_len 100 of sk 160", 2, 70, 160, 4, 2, 64, False, 0, 100),
    ("G8 sq 1", 2, 1, 90, 16, 2, 128, True, 70, 71),
]


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


_T0 = [None]       # the run's start (set by run()), for phase times


# torch.profiler keeps only the device records that fall inside its
# capture window on the host's clock; a record converted from the card's
# clock to just past the window's edge is lost.  Every profile waits this
# long after it starts and, the card synchronized, before it stops
PROFILE_SETTLE_S = 0.02


def device_profile():
    """A torch.profiler context over the card's activity alone: the host
    op events are not read, and recording them costs seconds a phase.
    It settles for ``PROFILE_SETTLE_S`` at both ends of its window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    class _Settled(profile):
        def __enter__(self):
            super().__enter__()
            time.sleep(PROFILE_SETTLE_S)
            return self

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            time.sleep(PROFILE_SETTLE_S)
            return super().__exit__(*exc)

    return _Settled(activities=[ProfilerActivity.CUDA])


@dataclasses.dataclass
class KernelSum:
    """One kernel name's device time in a profile, under the names
    ``key_averages()`` gives them (times in µs)."""
    key: str
    count: int
    self_device_time_total: float


def device_kernels(prof) -> list:
    """A :func:`device_profile`'s device events (kernels, copies, fills)
    summed by name, read from the raw kineto events: ``key_averages()``
    first builds the whole event tree, ~2.5 s for a round's 16k
    kernels."""
    from torch.autograd import DeviceType
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            n_us = by.setdefault(e.name(), [0, 0.0])
            n_us[0] += 1
            n_us[1] += e.duration_ns() / 1e3
    return [KernelSum(k, n, us) for k, (n, us) in by.items()]


class StepProfile:
    """One profiled step of a training loop, driven from its ``on_step``
    hook (called with the card synchronized): the profile starts after
    step ``first - 1`` and stops after step ``first``.  A profile short of
    the step's exact kernel counts ``want`` (records lost) is taken again
    on the next step, up to step ``last``; an excess fails at once.
    ``steps`` lists every profiled step, for the wall to leave out."""

    def __init__(self, what: str, want: dict, first: int, last: int):
        self.what, self.want, self.first, self.last = what, want, first, last
        self.prof, self.kern, self.at, self.steps = None, None, None, []

    def hook(self, s: int) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            kern, self.prof = device_kernels(self.prof), None
            self.steps.append(s)
            seen = {n: sum(e.count for e in kern
                           if KERNEL_SYMBOL[n] in e.key) for n in self.want}
            check(all(seen[n] <= self.want[n] for n in self.want),
                  f"{self.what}: the profiled step {s} shows {seen} "
                  f"kernels, expected {self.want}")
            if seen == self.want:
                self.kern, self.at = kern, s
            else:
                print(f"  profile of step {s} incomplete: {seen} kernels, "
                      f"expected {self.want} (records lost)"
                      + ("; again" if s < self.last else ""))
        if self.kern is None and self.first <= s + 1 <= self.last:
            self.prof = device_profile()
            self.prof.__enter__()

    def result(self) -> list:
        """The complete profile's kernels; fails if every try came up
        short."""
        check(self.kern is not None, f"{self.what}: every profile of "
              f"steps {self.steps} came up short of {self.want}")
        return self.kern


def phase(name: str) -> None:
    at = ("" if _T0[0] is None
          else f"  [{time.perf_counter() - _T0[0]:.1f} s]")
    print(f"\n== {name}{at}", flush=True)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device, copy=True)


# ---------------------------------------------------------------------------
# shapes: one flash call, its plain-version check, its bound


class Case:
    """One flash forward call: q [b, sq, H, d]; k, v [b, sk, KV, d] with
    the first ``kv_len`` keys visible, queries at ``q_offset + i``."""

    def __init__(self, name, b, sq, sk, H, KV, d, dtype, causal,
                 q_offset=0, kv_len=None):
        self.name, self.b, self.sq, self.sk = name, b, sq, sk
        self.H, self.KV, self.d, self.dtype = H, KV, d, dtype
        self.causal, self.q_offset = causal, q_offset
        self.kv_len = sk if kv_len is None else kv_len

    def tensors(self, torch, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dt = getattr(torch, self.dtype)
        mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dt)
        return (mk(self.b, self.sq, self.H, self.d),
                mk(self.b, self.sk, self.KV, self.d),
                mk(self.b, self.sk, self.KV, self.d))

    def kw(self):
        return dict(causal=self.causal, q_offset=self.q_offset,
                    kv_len=self.kv_len)

    def pairs(self) -> int:
        """(query, key) pairs the masks leave, i.e. the work needed."""
        if not self.causal:
            return self.sq * self.kv_len
        return sum(min(self.kv_len, self.q_offset + i + 1)
                   for i in range(self.sq))

    def bound(self):
        """(least ms, what bounds it): inputs read once, outputs written
        once, over HBM; QK^T and PV FLOPs over the peak for the type."""
        el = 2 if self.dtype == "bfloat16" else 4
        nbytes = el * (self.b * self.sq * self.H * self.d          # q
                       + 2 * self.b * self.kv_len * self.KV * self.d  # k,v
                       + self.b * self.sq * self.H * self.d)       # o
        nbytes += 4 * self.b * self.H * self.sq                    # lse
        flops = 4 * self.b * self.H * self.d * self.pairs()
        t_b = nbytes / HBM_BPS * 1e3
        t_f = flops / PEAK_FLOPS[self.dtype] * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def compare(torch, fa, ref, case: Case, seed=0):
    """Kernel against the plain version on the same card inputs; returns
    (max |d o|, max |d lse|)."""
    q, k, v = case.tensors(torch, seed)
    before = (fa.launches, fa.launches_mma)
    o, lse = fa.flash_fwd(q, k, v, **case.kw())
    torch.cuda.synchronize()
    mma = int(case.dtype == "bfloat16")
    check((fa.launches, fa.launches_mma) == (before[0] + 1, before[1] + mma),
          f"{case.name}: the {case.dtype} call did not launch the "
          f"{'tensor-core' if mma else 'FMA'} kernel once")
    o_r, lse_r = ref.flash_fwd_ref(q, k, v, **case.kw())
    tol = TOL[case.dtype]
    for got, want, nm in ((o.float(), o_r.float(), "o"),
                          (lse, lse_r, "lse")):
        check(bool(torch.isfinite(got).all()), f"{case.name}: {nm} not "
              f"finite")
        ok = torch.allclose(got, want, atol=tol, rtol=tol)
        check(ok, f"{case.name}: {nm} max |d| "
              f"{float((got - want).abs().max()):.3e} beyond {tol}")
    return (float((o.float() - o_r.float()).abs().max()),
            float((lse - lse_r).abs().max()))


def time_ms(torch, fn, iters: int):
    """(device ms, wall ms) per call.  Wall: host clock around ``iters``
    calls and a synchronise, which a small kernel's Python wrapper can
    dominate.  Device: CUDA events around ``iters`` calls queued behind
    a spin kernel that outlasts their enqueue, so the card runs them
    back to back and the events see only device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / iters
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # spin for 1.5x the enqueue time plus 5 ms, at <= 2e6 cycles per ms
    torch.cuda._sleep(int((1.5 * wall_ms * iters + 5.0) * 2e6))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters, wall_ms


def sdpa_fn(torch, case: Case, q, k, v):
    """One library call computing the same attention (layout [b, H, s, d];
    GQA through ``enable_gqa``)."""
    import torch.nn.functional as F
    qt = q.transpose(1, 2)
    kt = k[:, :case.kv_len].transpose(1, 2)
    vt = v[:, :case.kv_len].transpose(1, 2)
    # decode: one query against kv_len keys, no mask; prefill: causal
    # with queries and keys aligned at 0 (sq == kv_len, q_offset == 0)
    causal = case.causal and case.sq > 1
    if causal:
        check(case.q_offset == 0 and case.sq == case.kv_len,
              f"{case.name}: SDPA's causal mask is top-left aligned")
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def library_kernels(torch, fn) -> list:
    """Which backend one call of SDPA ran, from torch.profiler: the aten
    attention ops it dispatched to (``aten::_scaled_dot_product_
    {flash,efficient,cudnn}_attention...``) and the device kernels the
    profiler saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = {e.key for e in events if e.device_type == DeviceType.CPU
           and re.search(r"_attention|_sdpa|scaled_dot", e.key)}
    kernels = {e.key[:96] for e in events
               if e.device_type == DeviceType.CUDA}
    return sorted(ops) + sorted(kernels)


def sdpa_flags(torch) -> str:
    """The SDPA backends torch.backends.cuda leaves enabled."""
    b = torch.backends.cuda
    flags = {"flash": b.flash_sdp_enabled(),
             "mem_efficient": b.mem_efficient_sdp_enabled(),
             "math": b.math_sdp_enabled()}
    if hasattr(b, "cudnn_sdp_enabled"):
        flags["cudnn"] = b.cudnn_sdp_enabled()
    return ", ".join(k for k, v in flags.items() if v)


# ---------------------------------------------------------------------------
# phases


def card_info(torch) -> dict:
    phase("card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=TIMEOUT_S)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{name}, {count} device(s)")
    return {"smi": smi_line, "kind": name, "count": count}


def mma_ptxas(log: str) -> dict:
    """{kernel<args>: "registers, barriers (and static shared memory);
    spills"} as ptxas prints them, for the tensor-core kernels and the
    scans' decode, scores and chunked kernels in one nvcc -Xptxas -v
    log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            sym = line.split("'")[1]
            name = None
            for k in ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                      "flash_bwd_dkv_mma_kernel", "wkv_decode_kernel",
                      "wkv_scores_kernel", "wkv_chunk_kernel",
                      "ssd_decode_kernel", "ssd_scores_kernel",
                      "ssd_chunk_kernel"):
                if k in sym:      # _Z..<k>ILi128ELi4EE.. -> k<128, 4>
                    rest = sym.split(k, 1)[1]
                    args = re.findall(r"Li(\d+)E", rest)
                    if rest.startswith("I"):    # a type argument first
                        args.insert(0, "bf16" if "bfloat16" in rest
                                    else "fp32")
                    name = f"{k}<{', '.join(args)}>"
        elif name and "spill stores" in line:
            out[name] = line.strip().split(", ", 1)[1]
        elif name and "Used" in line and "registers" in line:
            out[name] = (line.split("Used", 1)[1].strip() + "; "
                         + out.get(name, ""))
            name = None
    return out


def build_kernels(build, r6, m2, *mods) -> None:
    phase("build")
    t0 = time.perf_counter()
    built = build.build_all()
    for mod in (r6, m2, *mods):
        mod.load()
    print(f"built {sorted(built) or 'nothing (libraries present)'} in "
          f"{time.perf_counter() - t0:.2f}s")
    for name, info in sorted(built.items()):
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")
    for name, info in sorted(built.items()):
        for kernel, props in mma_ptxas(str(info["log"])).items():
            print(f"  {name}: {kernel}: {props}")
    # the kernels' shared memory is dynamic, so ptxas does not print it
    import ctypes
    fwd = build.library("flash_fwd").repro_flash_fwd_smem_bytes
    bwd = build.library("flash_bwd").repro_flash_bwd_smem_bytes
    fwd.restype = bwd.restype = ctypes.c_longlong
    for d in (64, 128):
        print(f"  dynamic shared memory per block at head_dim {d}: "
              f"flash_fwd fp32 {fwd(0, d)} B, bf16 mma 4 warps {fwd(1, d)} "
              f"B, 1 warp {fwd(2, d)} B; flash_bwd_dq fp32 {bwd(0, d)} B, "
              f"bf16 mma {bwd(2, d)} B; flash_bwd_dkv fp32 {bwd(1, d)} B, "
              f"bf16 mma {bwd(3, d)} B; fused_update none")
    import torch
    for dt in (torch.bfloat16, torch.float32):
        print(f"  dynamic shared memory per block at 64 wide, {dt}: "
              f"wkv_chunk_kernel {r6.chunk_smem_bytes(dt, 64)} B, "
              f"wkv_scores_kernel {r6.chunk_smem_bytes(dt, 64, True)} B, "
              f"ssd_chunk_kernel {m2.chunk_smem_bytes(dt, 64)} B, "
              f"ssd_scores_kernel {m2.chunk_smem_bytes(dt, 64, True)} B; "
              f"the scans' decode and stepwise kernels: static only (ptxas "
              f"lines above)")


def kernel_checks(torch, fa, ref) -> dict:
    phase("flash_fwd against its plain version on the card")
    cfg = (32, 8, 128)       # granite-8b heads, KV heads, head_dim
    cases = []
    # the serving paths' calls: granite-8b's attention layers and
    # zamba2-1.2b's shared attention block (heads, KV heads, head_dim)
    for arch, heads in (("", cfg), ("zamba2 ", ZAMBA2_ATTN)):
        for kv_len in (1, 37, 64):
            cases.append(Case(f"{arch}decode kv_len={kv_len}", 1, 1, 64,
                              *heads, "bfloat16", False, kv_len - 1,
                              kv_len))
        for n in (2, 12):
            cases.append(Case(f"{arch}prefill n={n}", 1, n, n, *heads,
                              "bfloat16", True))
    for b, H, KV, sq, sk, d, causal, dt in FLASH_CASES:
        for dt_ in sorted({dt, "bfloat16"}):   # each also in bf16
            cases.append(Case(f"test_kernels b{b} H{H}/{KV} {sq}x{sk} d{d} "
                              f"{'causal' if causal else 'full'} {dt_}",
                              b, sq, sk, H, KV, d, dt_, causal))
    for name, b, sq, sk, H, KV, d, causal, off, kv_len in MMA_EDGES:
        cases.append(Case(f"edge {name} bfloat16", b, sq, sk, H, KV, d,
                          "bfloat16", causal, off, kv_len))
    cases.append(Case("causal 2048", 1, 2048, 2048, *cfg, "bfloat16",
                      True))
    for dt in ("float32", "bfloat16"):       # the training paths' calls
        cases.append(Case(f"train b8 512 causal {dt}", TRAIN_BATCH,
                          TRAIN_SEQ, TRAIN_SEQ, *cfg, dt, True))
        cases.append(Case(f"train IR microbatch b1 512 causal {dt}",
                          IR_MB_ROWS, TRAIN_SEQ, TRAIN_SEQ, *cfg, dt, True))
    errs = {}
    for i, case in enumerate(cases):
        e_o, e_l = compare(torch, fa, ref, case, seed=i)
        errs[case.name] = e_o
        print(f"  {case.name:<44} max|d o| {e_o:.3e}  max|d lse| "
              f"{e_l:.3e}  (tol {TOL[case.dtype]:g})")
    return errs


def model_check(torch) -> None:
    """The port's model on the card (flash kernel) against itself on the
    CPU (plain attention), same weights, smoke size, fp32."""
    phase("model on the card against the CPU, smoke size, fp32")
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import Model
    from repro_torch.planner import serve_plan
    from repro_torch.serve import SimpleEngine, poisson_trace
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=4, n_kv_heads=2, compute_dtype="float32")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _tree_to(p_cpu, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 16)
        l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.cuda()}, 16)
        for pos in range(9, 12):
            tok = toks[:, pos - 9:pos - 8]
            d_c, c_c = cpu.decode_step(p_cpu, c_c, tok, pos)
            d_g, c_g = gpu.decode_step(p_gpu, c_g, tok.cuda(), pos)
    err = max(float((l_g.cpu() - l_c).abs().max()),
              float((d_g.cpu() - d_c).abs().max()),
              float((c_g["layers"]["k"].cpu() - c_c["layers"]["k"])
                    .abs().max()))
    print(f"  logits and cache max |d| {err:.3e} (tol 1e-4)")
    check(err <= 1e-4, f"model on the card differs from the CPU by {err}")
    splan = serve_plan(cfg, n_stages=1, n_slots=1, prompt_budget=8,
                       page_seq=32)
    trace = poisson_trace(6, rate=1.5, seed=0, prompt_lens=(2, 8),
                          vocab=cfg.vocab_size)
    t_c = SimpleEngine(cpu, p_cpu, splan).run(trace)
    t_g = SimpleEngine(gpu, p_gpu, splan).run(trace)
    print(f"  engine tokens equal on card and CPU: {t_c == t_g}")
    check(t_c == t_g, "engine tokens differ between the card and the CPU")


def fma_only(ops) -> None:
    """The fp32 card-vs-CPU checks ran attention on the FMA kernels only:
    flash forwards and both backward kernels were launched, none a
    tensor-core one."""
    counts = ops.launch_counts()
    variants = {k: v for k, v in ops.variant_counts().items()
                if k.endswith("_mma")}
    print(f"  fp32 model checks: {counts['flash_fwd']} flash_fwd, "
          f"{counts['flash_bwd_dq']} flash_bwd_dq and "
          f"{counts['flash_bwd_dkv']} flash_bwd_dkv launches, tensor-core "
          f"variants {variants}")
    check(counts["flash_fwd"] > 0 and counts["flash_bwd_dq"] > 0
          and counts["flash_bwd_dkv"] > 0,
          "the fp32 model checks launched no attention kernel")
    check(not any(variants.values()),
          f"an fp32 model check reached a bf16 kernel: {variants}")


def per_call_launches(arch: str) -> dict:
    """Kernel launches one prefill or decode call of full ``arch`` makes:
    one flash forward per attention layer, one scan per rwkv6 / mamba2
    layer, and one flash forward per shared-block call of a hybrid model
    (after every full ``shared_attn_every`` segment of each stage)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import uniform_stage_sizes
    cfg = get_config(arch)
    if cfg.ssm is None:
        return {"flash_fwd": cfg.n_layers}
    if cfg.ssm.kind == "rwkv6":
        return {"rwkv6_scan": cfg.n_layers}
    k = cfg.ssm.shared_attn_every
    sizes = uniform_stage_sizes(cfg.n_layers, cfg.mesh_plan.pipe)
    return {"mamba2_scan": cfg.n_layers,
            "flash_fwd": sum(n // k for n in sizes)}


def main_path(torch, ops, arch: str, n_layers: int) -> dict:
    phase(f"main path: repro_torch.launch.serve.main, full {arch}, bf16")
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.planner import serve_plan
    from repro_torch.serve import admissible, poisson_trace
    cfg = get_config(arch)
    check(cfg.n_layers == n_layers, "unexpected depth")
    per_call = per_call_launches(arch)
    args = dict(requests=8, rate=1.5, prompt_lens=(2, 12),
                gen_lens=(1, 8), prompt_budget=16, page_seq=64, seed=0)
    trace = poisson_trace(args["requests"], rate=args["rate"],
                          seed=args["seed"], prompt_lens=args["prompt_lens"],
                          gen_lens=args["gen_lens"], vocab=cfg.vocab_size)
    splan = serve_plan(cfg, n_stages=1, n_slots=1,
                       prompt_budget=args["prompt_budget"],
                       page_seq=args["page_seq"])
    live = [q for q in trace if admissible(q, splan)]
    want_prefill = 1 + len(live)                 # + the warm-up's one
    want_decode = 1 + sum(q.gen_len - 1 for q in live)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "serve.jsonl"
        argv = ["--arch", arch, "--engine", "simple",
                "--requests", str(args["requests"]),
                "--rate", str(args["rate"]), "--prompt-lens", "2,12",
                "--gen-lens", "1,8", "--prompt-budget", "16",
                "--page-seq", "64", "--seed", "0",
                "--metrics-out", str(out)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rc = serve.main(argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        variants = ops.variant_counts()
        peak = torch.cuda.max_memory_allocated()
        recs = [json.loads(x) for x in out.read_text().splitlines()]
    check(rc == 0, f"serve.main returned {rc}")
    run = [r for r in recs if r["event"] == "serve_run"][-1]
    summary = [r for r in recs if r["event"] == "summary"][-1]
    gauges, counters = summary["gauges"], summary["counters"]
    n_pf, n_dec = gauges["serve/prefill_calls"], gauges["serve/decode_calls"]
    print(f"  served {run['n_served']}/{run['n_requests']} requests, "
          f"{run['n_tokens']} tokens; {n_pf:g} prefill + {n_dec:g} decode "
          f"calls (warm-up included)")
    print(f"  decode {run['tok_per_s']:.2f} tok/s   p50 "
          f"{run['token_ms_p50']:.3f} ms/tok   p99 "
          f"{run['token_ms_p99']:.3f} ms/tok   warm-up "
          f"{run['compile_s']:.2f}s")
    print(f"  peak torch.cuda.max_memory_allocated: {peak / 2**30:.2f} GiB")
    for name, n in per_call.items():
        print(f"  {name} launches {counts[name]} = {n} x "
              f"({n_pf:g} + {n_dec:g})")
    check(run["n_served"] == len(live) and run["n_rejected"] ==
          len(trace) - len(live), "not every admissible request was served")
    check(run["n_tokens"] == sum(q.gen_len for q in live),
          "a request did not get exactly gen_len tokens")
    check(counters.get("serve/nonfinite_logits", 0) == 0,
          "non-finite logits")
    check((n_pf, n_dec) == (want_prefill, want_decode),
          f"engine made {n_pf} + {n_dec} calls, expected "
          f"{want_prefill} + {want_decode}")
    want = {name: per_call.get(name, 0) * (want_prefill + want_decode)
            for name in counts}
    check(counts == want, f"the run launched {counts}, expected {want}")
    # every bf16 flash_fwd on the tensor cores; the scans: the decode
    # kernel for every decode step and the warm-up's one-token prefill,
    # the stepwise kernel for every request's prefill (prompts 2-12), the
    # chunked kernel never
    want_v = {k: 0 for k in variants}
    want_v["flash_fwd_mma"] = counts["flash_fwd"]
    for scan in ("rwkv6_scan", "mamba2_scan"):
        want_v[f"{scan}_decode"] = per_call.get(scan, 0) * (want_decode + 1)
    print(f"  variants: {variants}")
    check(variants == want_v, f"the run's variant launches {variants}, "
          f"expected {want_v}")
    check(all(math.isfinite(run[k]) for k in
              ("tok_per_s", "token_ms_p50", "token_ms_p99")),
          "non-finite serving metrics")
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts, "variants": variants, "run": run,
            "peak_bytes": peak, "per_call": per_call}


# the kernel function each wrapper launches, as the profiler names it
# (bf16 paths: the tensor-core variants of the forward and backward; a
# decode step's scans: their decode kernels)
KERNEL_SYMBOL = {"flash_fwd": "flash_fwd_mma_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_mma_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_mma_kernel",
                 "fused_update": "fused_update_kernel",
                 "rwkv6_scan": "wkv_decode_kernel",
                 "mamba2_scan": "ssd_decode_kernel"}


def decode_profile(torch, arch: str = ARCH) -> dict:
    """Where a full-width decode step spends its time: wall per step
    without the profiler, then device time per kernel under it."""
    phase(f"a full-width {arch} decode step under torch.profiler")
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg.compute_dtype)
    # 8 steps for the wall; 4 under the profiler: one window of 8 steps
    # is ~20k kernel records, about one CUPTI activity buffer, and once
    # lost ~1% of them (2,430.6 of 2,455 kernels a step)
    steps, prof_steps, attempts = 8, 4, 3
    want = {name: per_step * prof_steps
            for name, per_step in per_call_launches(arch).items()}
    with torch.inference_mode():
        prompt = torch.arange(1, 9, device="cuda")[None]
        _, cache = model.prefill(params, {"tokens": prompt}, 64)

        def step(pos):
            logits, _ = model.decode_step(params, cache, prompt[:, -1:],
                                          pos)
            return int(torch.argmax(logits[0, -1, :cfg.vocab_size]))

        step(8)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for pos in range(9, 9 + steps):
            step(pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
        # a profile short of a kernel's exact count (records dropped) is
        # taken again, at most `attempts` times; an excess fails at once
        for attempt in range(1, attempts + 1):
            with device_profile() as prof:
                for pos in range(9 + steps, 9 + steps + prof_steps):
                    step(pos)
                torch.cuda.synchronize()
            kern = device_kernels(prof)
            seen = {name: sum(e.count for e in kern
                              if KERNEL_SYMBOL[name] in e.key)
                    for name in want}
            check(all(seen[n] <= want[n] for n in want), f"the profiled "
                  f"decode steps show {seen} kernels, expected {want}")
            if seen == want or attempt == attempts:
                break
            print(f"  profile {attempt} of {attempts} incomplete: {seen} "
                  f"kernels, expected {want} (records dropped); again")
    del params, cache, model
    gc.collect()
    torch.cuda.empty_cache()
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / prof_steps
    n_kern = sum(e.count for e in kern) / prof_steps
    print(f"  wall per decode step (no profiler): {wall_ms:.3f} ms")
    print(f"  device kernels per step: {n_kern:.1f}")
    check(bool(kern), "the profiler saw no device activity in the decode "
          "steps")
    print(f"  device busy per step: {busy_ms:.3f} ms, "
          f"{100 * busy_ms / wall_ms:.1f}% of the wall "
          f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%)")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:8]:
        print(f"    {e.self_device_time_total / 1e3 / prof_steps:8.4f} ms "
              f"{e.count / prof_steps:6.1f}x  {e.key[:72]}")
    by = {}
    for name in want:
        hits = [e for e in kern if KERNEL_SYMBOL[name] in e.key]
        n_hit = sum(e.count for e in hits)
        check(n_hit == want[name], f"the profiled decode steps show "
              f"{n_hit} {name} kernels, expected {want[name]}")
        by[name] = (sum(e.self_device_time_total for e in hits) / 1e3
                    / prof_steps)
        print(f"  {name}: {by[name]:.4f} ms per step "
              f"({100 * by[name] / busy_ms:.1f}% of device busy)")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernel_ms": by,
            "idle_share": 1 - busy_ms / wall_ms, "kernels_per_step": n_kern}


def timings(torch, fa, ref, errs) -> list:
    phase("timings (CUDA events, after warm-up)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (32, 8, 128)
    cases = [(Case("decode kv_len=64", 1, 1, 64, *cfg, "bfloat16", False,
                   63, 64), 500),
             (Case("prefill n=12", 1, 12, 12, *cfg, "bfloat16", True), 500),
             (Case("zamba2 decode kv_len=64", 1, 1, 64, *ZAMBA2_ATTN,
                   "bfloat16", False, 63, 64), 500),
             (Case("zamba2 prefill n=12", 1, 12, 12, *ZAMBA2_ATTN,
                   "bfloat16", True), 500),
             (Case("causal 2048", 1, 2048, 2048, *cfg, "bfloat16", True),
              20),
             (Case("train b8 512 causal bfloat16", TRAIN_BATCH, TRAIN_SEQ,
                   TRAIN_SEQ, *cfg, "bfloat16", True), 20)]
    print(f"  SDPA backends enabled (torch.backends.cuda): "
          f"{sdpa_flags(torch)}")
    rows = []
    for case, iters in cases:
        q, k, v = case.tensors(torch, seed=7)
        kw = case.kw()
        ms, wall = time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw),
                           iters)
        plain_ms, _ = time_ms(
            torch, lambda: ref.flash_fwd_ref(q, k, v, **kw), iters)
        sdpa = sdpa_fn(torch, case, q, k, v)
        lib_ms, _ = time_ms(torch, sdpa, iters)
        lib_kernels = library_kernels(torch, sdpa)
        bound_ms, bound_by = case.bound()
        row = {"shape": case.name, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms, "library_kernels": lib_kernels,
               "max_abs_err": errs[case.name], "wall_ms_per_call": wall}
        rows.append(row)
        print(f"  {case.name:<28} kernel {ms:.4f} ms (wall {wall:.4f} ms "
              f"per call)  bound {bound_ms:.5f} ms ({bound_by})  plain "
              f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms "
              f"({ms / lib_ms:.2f}x sdpa; sdpa ran {lib_kernels})")
    return rows


# ---------------------------------------------------------------------------
# the flash backward and the fused update


class BwdCase(Case):
    """One flash backward call (dq and dk/dv) on a Case's shapes."""

    def bound(self, which: str):
        """(least ms, what bounds it) for one of the two kernels: inputs
        (q, k, v, do, lse, dl) read once and outputs (dq, or dk and dv)
        written once over HBM; 6d (dq) or 8d (dk/dv) FLOPs per unmasked
        (query, key) pair and head over the peak for the type."""
        el = 2 if self.dtype == "bfloat16" else 4
        q_el = self.b * self.sq * self.H * self.d
        kv_el = self.b * self.kv_len * self.KV * self.d
        nbytes = el * (2 * q_el + 2 * kv_el) + 8 * self.b * self.H * self.sq
        if which == "dq":
            nbytes += el * q_el
            flops = 6 * self.b * self.H * self.d * self.pairs()
        else:
            nbytes += el * 2 * kv_el
            flops = 8 * self.b * self.H * self.d * self.pairs()
        t_b = nbytes / HBM_BPS * 1e3
        t_f = flops / PEAK_FLOPS[self.dtype] * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    def all_tensors(self, torch, fa, seed=0):
        q, k, v = self.tensors(torch, seed)
        o, lse = fa.flash_fwd(q, k, v, **self.kw())
        g = torch.Generator(device="cuda").manual_seed(seed + 1000)
        do = torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
        return q, k, v, o, lse, do


def compare_bwd(torch, fa, ref, case: BwdCase, seed=0):
    """Both backward kernels against the plain version on the same card
    inputs; returns {"dq": max |d dq|, "dkv": max over dk and dv}.  Keys
    at positions >= kv_len must come back exactly zero."""
    q, k, v, o, lse, do = case.all_tensors(torch, fa, seed)
    counters = lambda: (fa.launches_dq, fa.launches_dq_mma,
                        fa.launches_dkv, fa.launches_dkv_mma)
    before = counters()
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, **case.kw())
    torch.cuda.synchronize()
    mma = int(case.dtype == "bfloat16")
    check(counters() == (before[0] + 1, before[1] + mma, before[2] + 1,
                         before[3] + mma),
          f"{case.name}: the {case.dtype} call did not launch dq and dk/dv "
          f"once each on the {'tensor-core' if mma else 'FMA'} kernels")
    # dk/dv again (uncounted) into NaN-filled outputs: a key the kernel
    # does not write stays NaN, and a second run must repeat the first
    # bit for bit (no atomics)
    _, launch_dkv, (_, dk2, dv2) = fa._bwd_launchers(q, k, v, o, lse, do,
                                                     **case.kw())
    dk2.fill_(float("nan"))
    dv2.fill_(float("nan"))
    launch_dkv()
    torch.cuda.synchronize()
    check(torch.equal(dk2, dk) and torch.equal(dv2, dv), f"{case.name}: "
          f"dk/dv into NaN-filled outputs differ from the first run")
    for nm, t in (("dk", dk), ("dv", dv)):
        check(bool((t[:, case.kv_len:] == 0).all()), f"{case.name}: {nm} "
              f"not exactly zero for keys past kv_len {case.kv_len}")
    want = ref.flash_bwd_ref(q, k, v, o, lse, do, **case.kw())
    atol, rtol = BWD_TOL[case.dtype]
    errs = {}
    for got, w, nm in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        got, w = got.float(), w.float()
        check(bool(torch.isfinite(got).all()), f"{case.name}: {nm} not "
              f"finite")
        check(torch.allclose(got, w, atol=atol, rtol=rtol),
              f"{case.name}: {nm} max |d| "
              f"{float((got - w).abs().max()):.3e} beyond atol {atol} / "
              f"rtol {rtol}")
        errs[nm] = float((got - w).abs().max())
    return {"dq": errs["dq"], "dkv": max(errs["dk"], errs["dv"])}


def bwd_checks(torch, fa, ref) -> dict:
    phase("flash_bwd (dq, dk/dv) against its plain version on the card")
    cfg = (32, 8, 128)
    cases = []
    for dt in ("float32", "bfloat16"):
        cases.append(BwdCase(f"train b8 512 causal {dt}", TRAIN_BATCH,
                             TRAIN_SEQ, TRAIN_SEQ, *cfg, dt, True))
        cases.append(BwdCase(f"train IR microbatch b1 512 causal {dt}",
                             IR_MB_ROWS, TRAIN_SEQ, TRAIN_SEQ, *cfg, dt,
                             True))
        cases.append(BwdCase(f"test_flash_bwd b1 H4/2 128 d64 {dt}", 1,
                             128, 128, 4, 2, 64, dt, True))
        cases.append(BwdCase(f"full GQA H8/2 65x130 kv_len 97 {dt}", 3,
                             65, 130, 8, 2, 64, dt, False, 0, 97))
    for name, b, sq, sk, H, KV, d, causal, off, kv_len in (MMA_EDGES +
                                                           DKV_EDGES):
        cases.append(BwdCase(f"edge {name} bfloat16", b, sq, sk, H, KV, d,
                             "bfloat16", causal, off, kv_len))
    errs = {}
    for i, case in enumerate(cases):
        e = compare_bwd(torch, fa, ref, case, seed=100 + i)
        errs[case.name] = e
        print(f"  {case.name:<40} max|d dq| {e['dq']:.3e}  max|d dk,dv| "
              f"{e['dkv']:.3e}  (tol {BWD_TOL[case.dtype]})")
    return errs


def group_specs(kind: str, n_layers: int = 0) -> list:
    """[(path, ParamSpec)] of one update group of full-width granite-8b,
    in the order the update sees its leaves: ``"stage"``, a stage tree of
    ``n_layers`` layers; ``"outer"``, the embedding and final norm."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import (embed_specs, norm_specs,
                                           stack_specs, tree_map)
    from repro_torch.models.transformer import block_specs
    cfg = get_config(ARCH)
    tree = ({"layers": stack_specs(block_specs(cfg), n_layers, "layer")}
            if kind == "stage" else
            {"embed": embed_specs(cfg), "ln_f": norm_specs(cfg)})
    out = []
    tree_map(lambda path, sp: out.append((path, sp)), tree)
    return out


def make_group(torch, specs, predicted, seed=0):
    """fp32 w, v and g of random values for ``specs``, and an fp32 ŵ for
    each path ``predicted(path)`` accepts (None for the others; None
    for the list if it accepts none), as the main path's update gets
    them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda shape, scale=1.0: torch.randn(
        shape, generator=g, device="cuda") * scale
    ws = [mk(sp.shape) for _, sp in specs]
    vs = [mk(sp.shape, 1e-2) for _, sp in specs]
    gs = [mk(sp.shape) for _, sp in specs]
    whats = [torch.empty(sp.shape, device="cuda") if predicted(path)
             else None for path, sp in specs]
    return ws, vs, gs, (whats if any(w is not None for w in whats)
                        else None)


FU_KW = dict(lr=1e-2, gamma=0.9, s=6.0)


def fu_compare(torch, ops, ref, ws, vs, gs, whats, what: str,
               kw=FU_KW) -> float:
    """One kernel launch over a group, with the update's arguments
    ``kw``, against its plain version on the same inputs (computed
    first: the kernel writes in place); returns the largest |d| over w',
    v' and ŵ."""
    whats_l = [None] * len(ws) if whats is None else whats
    want = [ref.fused_update_ref(
        w, v, g, what_dtype=None if wh is None else wh.dtype, **kw)
        for w, v, g, wh in zip(ws, vs, gs, whats_l)]
    ops.fused_update(ws, vs, gs, whats=whats, **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for i, (w2, v2, wh2) in enumerate(want):
        pairs = [(ws[i], w2, FU_TOL["float32"]),
                 (vs[i], v2, FU_TOL["float32"])]
        if whats_l[i] is not None:
            pairs.append((whats_l[i], wh2, FU_TOL[
                "bfloat16" if whats_l[i].dtype == torch.bfloat16
                else "float32"]))
        for got, w, tol in pairs:
            d = float((got.float() - w.float()).abs().max())
            check(torch.allclose(got.float(), w.float(), atol=tol,
                                 rtol=tol),
                  f"fused_update {what}: tensor {i} max |d| {d:.3e} "
                  f"beyond {tol}")
            worst = max(worst, d)
    return worst


def fused_checks(torch, ops, ref) -> None:
    """One launch over a ragged group (one count not a multiple of the
    kernel's chunk), with and without ŵ, fp32 or bf16 g and ŵ.  (The
    main path's own groups are checked where they are timed.)"""
    phase("fused_update against its plain version on the card")
    shapes = [(4096, 1024), (8192 * 3 + 17,), (7,), (3, 1000, 5)]
    for g_dt, w_dt in ((torch.float32, None), (torch.float32, torch.float32),
                       (torch.bfloat16, torch.float32),
                       (torch.float32, torch.bfloat16)):
        g = torch.Generator(device="cuda").manual_seed(7)
        mk = lambda s, dt=torch.float32: torch.randn(
            s, generator=g, device="cuda").to(dt)
        ws = [mk(s) for s in shapes]
        vs = [mk(s) for s in shapes]
        gs = [mk(s, g_dt) for s in shapes]
        whats = (None if w_dt is None else
                 [torch.empty(s, device="cuda", dtype=w_dt) for s in shapes])
        err = fu_compare(torch, ops, ref, ws, vs, gs, whats,
                         f"g {g_dt} ŵ {w_dt}")
        print(f"  g {str(g_dt):<15} ŵ {str(w_dt):<15} ragged "
              f"{len(shapes)} tensors, one launch: max |d| {err:.3e}")


# ---------------------------------------------------------------------------
# the recurrences: rwkv6_scan and mamba2_scan

# the serving archs' full widths: rwkv6-7b h 64, hd 64; zamba2-1.2b
# h 64 (d_in 4096 / 64), p 64, n 64, g 1
SCAN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


class ScanCase:
    """One scan call in the model layout, with the decays drawn as the
    models draw them: rwkv6 w = exp(-exp(logw)), logw up to 4.2 (w down
    to ~1e-29); mamba2 decay = exp(-U(0, 11.5)) (down to ~1e-5); with
    ``zeros``, that share of the decays exactly 0 (a reset).  With
    ``pages`` (one per row), S0 is gathered from a buffer of
    ``n_pages + 1`` nonzero page states, as the decode wave gathers its
    rows' states (``Model.stage_decode``); rows may share a page."""

    def __init__(self, kind, name, b, s, h, d, dtype, n=None, g=1,
                 zeros=0.0, pages=None, n_pages=8):
        self.kind, self.name, self.b, self.s, self.h = kind, name, b, s, h
        self.d, self.n, self.g, self.dtype = d, n or d, g, dtype
        self.zeros = zeros
        self.pages, self.n_pages = pages, n_pages

    def variant(self) -> str:
        """The kernel the wrapper launches for this call."""
        if self.s == 1:
            return "decode"
        return "chunk" if self.s >= 64 else "step"

    def tensors(self, torch, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dt = getattr(torch, self.dtype)
        mk = lambda *sh, sc=1.0, d=torch.float32: (torch.randn(
            *sh, generator=g, device="cuda") * sc).to(d)
        uni = lambda *sh: torch.rand(*sh, generator=g, device="cuda")
        b, s, h, d = self.b, self.s, self.h, self.d
        reset = lambda x: (x.masked_fill(uni(*x.shape) < self.zeros, 0.0)
                           if self.zeros else x)
        if self.kind == "rwkv6":
            w = reset(torch.exp(-torch.exp(-3.0 + 7.2 * uni(b, s, h, d))))
            if self.pages is None:
                S0 = mk(b, h, d, d, sc=0.1)
            else:                   # the wave's gather: buf[i][pages]
                S0 = self.page_buffer(torch, seed)[self.page_index(torch)]
            return (mk(b, s, h, d, d=dt), mk(b, s, h, d, sc=0.3, d=dt),
                    mk(b, s, h, d, d=dt), w, mk(h, d, sc=0.3), S0)
        delta = torch.nn.functional.softplus(mk(b, s, h))
        decay = reset(torch.exp(-11.5 * uni(b, s, h)))
        # B and C as the model has them: strided views of one projection
        bc = mk(b, s, 2 * self.g * self.n, sc=0.5, d=dt)
        B, C = (t.reshape(b, s, self.g, self.n) for t in bc.chunk(2, -1))
        return (mk(b, s, h, d, d=dt), delta, decay, B, C,
                mk(b, h, d, self.n, sc=0.1))

    def page_buffer(self, torch, seed=0):
        """The page states the rows' S0 is gathered from: [n_pages + 1,
        h, d, n] fp32, nonzero, the last page the trash page."""
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        return torch.randn(self.n_pages + 1, self.h, self.d, self.n,
                           generator=g, device="cuda") * 0.1

    def page_index(self, torch):
        return torch.tensor(self.pages, dtype=torch.long, device="cuda")

    def plain(self, torch, ref, args):
        """The plain version (kernel layout) on the same inputs, back in
        the model layout: (y, S_T)."""
        tr = lambda t: t.transpose(1, 2)
        if self.kind == "rwkv6":
            r, k, v, w, u, S0 = args
            y, sT = ref.rwkv6_ref(tr(r), tr(k), tr(v), tr(w), u, S0)
            return tr(y).to(r.dtype), sT
        x, delta, decay, B, C, S0 = args
        rep = self.h // self.g
        per_head = lambda t: tr(t.repeat_interleave(rep, dim=2))
        y, sT = ref.mamba2_ref(tr(x), tr(delta), tr(decay), per_head(B),
                               per_head(C), S0)
        return tr(y), sT

    def recurrence_ms(self) -> float:
        """The fp32 recurrence's operations over the fp32 peak outside the
        tensor cores: per step and state element 3 for the update (two
        products and a sum) and 2 for the read-out (a product and a sum);
        rwkv6's bonus term folds to O(hd).  The operation bound of the
        stepwise and decode kernels, which run the recurrence itself."""
        flops = 5 * self.b * self.s * self.h * self.d * self.n
        return flops / PEAK_FLOPS["float32"] * 1e3

    def bound(self):
        """(least ms, what bounds it), the larger of: bytes, every input
        read once and y, S_T written once, over HBM; and operations.  For
        the decode and stepwise kernels the operations are the fp32
        recurrence's (``recurrence_ms``).  For the chunked kernels (s >=
        64) they are the chunked form's tensor-core products over the
        TF32 peak, each counted once (not per 3xTF32 pass): rwkv6 per
        step and head 4 hd^2 (y and the state, sub-chunks of 16) + 32 hd
        (the diagonal scores times v); mamba2 per step and head 4 p n
        (C S^T, x^T B) + 128 p (the scores times x), and per step and B/C
        group 128 n (C B^T).  That form needs fewer operations than the
        recurrence, so the recurrence's count is no floor for it."""
        el = 2 if self.dtype == "bfloat16" else 4
        b, s, h, d, n = self.b, self.s, self.h, self.d, self.n
        if self.kind == "rwkv6":
            nbytes = (el * 4 * b * s * h * d        # r, k, v in; y out
                      + 4 * b * s * h * d           # w
                      + 4 * h * d                   # u
                      + 2 * 4 * b * h * d * d)      # S0 in, S_T out
            tc = b * s * h * (4 * d * d + 32 * d)
        else:
            nbytes = (el * b * s * h * d            # x
                      + 4 * b * s * h * d           # y (fp32)
                      + 2 * 4 * b * s * h           # dt, decay
                      + el * 2 * b * s * self.g * n  # B, C
                      + 2 * 4 * b * h * d * n)      # S0 in, S_T out
            tc = b * s * (h * (4 * d * n + 128 * d) + self.g * 128 * n)
        t_b = nbytes / HBM_BPS * 1e3
        t_f = (tc / PEAK_FLOPS["tf32"] * 1e3 if self.variant() == "chunk"
               else self.recurrence_ms())
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# the kernel function each scan variant launches, as the profiler names it
SCAN_SYMBOLS = {
    "rwkv6": {"decode": "wkv_decode_kernel", "step": "wkv_kernel",
              "chunk": "wkv_scores_kernel + wkv_chunk_kernel"},
    "mamba2": {"decode": "ssd_decode_kernel", "step": "ssd_kernel",
               "chunk": "ssd_scores_kernel + ssd_chunk_kernel"}}


def scan_fn(ops, case: ScanCase):
    return ops.rwkv6_scan if case.kind == "rwkv6" else ops.mamba2_scan


def scan_cases(kind: str) -> list:
    full = dict(h=64, d=64)            # both archs at full width, b 1
    cases = []
    for dt in ("float32", "bfloat16"):
        for name, s in (("decode s=1", 1), ("prefill s=12", 12),
                        ("ragged s=37", 37), ("full s=2048", 2048)):
            cases.append(ScanCase(kind, f"{name} {dt}", 1, s, dtype=dt,
                                  **full))
    # the chunked kernels' edges: one chunk, one chunk and a step, a
    # partial last chunk at b 2 with exact-zero decays; and decode at b 2
    cases += [
        ScanCase(kind, "chunk s=64 float32", 1, 64, dtype="float32", **full),
        ScanCase(kind, "chunk s=65 bfloat16", 1, 65, dtype="bfloat16",
                 **full),
        ScanCase(kind, "chunk s=200 b2 zeros float32", 2, 200,
                 dtype="float32", zeros=0.05, **full),
        ScanCase(kind, "chunk s=200 b2 zeros bfloat16", 2, 200,
                 dtype="bfloat16", zeros=0.05, **full),
        ScanCase(kind, "decode b2 zeros float32", 2, 1, dtype="float32",
                 zeros=0.05, **full)]
    if kind == "rwkv6":
        # the decode wave's call: 8 rows, their states gathered from the
        # pages, the last two rows idle on the trash page (page 8)
        cases += [ScanCase(kind, f"wave decode b8 {dt}", 8, 1, dtype=dt,
                           pages=WAVE_PAGES, **full)
                  for dt in ("float32", "bfloat16")]
    if kind == "mamba2":
        cases.append(ScanCase(kind, "g=4 b2 h16 p32 n16 s=37 float32", 2,
                              37, 16, 32, "float32", n=16, g=4))
        cases.append(ScanCase(kind, "g=2 b1 h8 p16 n64 s=37 bfloat16", 1,
                              37, 8, 16, "bfloat16", n=64, g=2))
        cases.append(ScanCase(kind, "g=4 b2 h16 p32 n16 s=130 float32", 2,
                              130, 16, 32, "float32", n=16, g=4))
    return cases


def scan_checks(torch, ops, ref) -> dict:
    """Both scans' kernels against their plain versions on the card: y
    and S_T, fp32 and bf16, decode (s = 1) from a nonzero S0, prefill,
    ragged, s = 2048 at full width, the chunked kernels' edges (s = 64,
    65, 200 with b 2 and exact-zero decays), and mamba2 with g > 1; each
    call launches the variant its length routes it to."""
    errs = {}
    for kind in ("rwkv6", "mamba2"):
        phase(f"{kind}_scan against its plain version on the card")
        for i, case in enumerate(scan_cases(kind)):
            args = case.tensors(torch, seed=200 + i)
            before = ops.variant_counts()
            y, sT = scan_fn(ops, case)(*args)
            torch.cuda.synchronize()
            after = ops.variant_counts()
            got = {v: after[f"{kind}_scan_{v}"] - before[f"{kind}_scan_{v}"]
                   for v in ("decode", "chunk")}
            want = {v: int(case.variant() == v) for v in got}
            check(got == want, f"{kind} {case.name}: launched {got} of the "
                  f"decode and chunked kernels, expected {want}")
            y_r, sT_r = case.plain(torch, ref, args)
            e = {}
            for got, want, nm, tol in (
                    (y, y_r, "y", SCAN_TOL[case.dtype if case.kind ==
                                            "rwkv6" else "float32"]),
                    (sT, sT_r, "S_T", SCAN_TOL["float32"])):
                got, want = got.float(), want.float()
                check(bool(torch.isfinite(got).all()),
                      f"{kind} {case.name}: {nm} not finite")
                e[nm] = float((got - want).abs().max())
                check(torch.allclose(got, want, atol=tol, rtol=tol),
                      f"{kind} {case.name}: {nm} max |d| {e[nm]:.3e} beyond "
                      f"{tol}")
            errs[(kind, case.name)] = max(e.values())
            # the models' call: S_T written over S0 in place, bit for bit
            S_in = args[-1].clone()
            y_in, _ = scan_fn(ops, case)(*args[:-1], S_in, out=S_in)
            torch.cuda.synchronize()
            check(torch.equal(y_in, y) and torch.equal(S_in, sT),
                  f"{kind} {case.name}: out=S0 differs from a fresh S_T")
            if case.pages is not None:
                # the wave's scatter: buf[i][pages] = S_T; each page then
                # holds its row's S_T, the shared trash page in each
                # element one of its rows' (which write lands is left
                # open, element by element)
                buf = case.page_buffer(torch, seed=200 + i)
                buf[case.page_index(torch)] = S_in
                for p in set(case.pages):
                    rows = [r for r, q in enumerate(case.pages) if q == p]
                    hit = torch.zeros_like(buf[p], dtype=torch.bool)
                    for r in rows:
                        hit |= buf[p] == sT[r]
                    check(bool(hit.all()), f"{kind} {case.name}: page {p} "
                          f"after the scatter holds values of none of its "
                          f"rows' S_T {rows}")
            decays = args[3 if kind == "rwkv6" else 2]
            w_min = float(decays[decays > 0].min())
            n_zero = int((decays == 0).sum())
            print(f"  {case.name:<34} {case.variant():<6} max|d y| "
                  f"{e['y']:.3e}  max|d S_T| {e['S_T']:.3e}  (smallest "
                  f"decay {w_min:.2e}, {n_zero} exact zeros); in place: "
                  f"equal")
    return errs


def ssm_model_check(torch) -> None:
    """The port's rwkv6 and zamba2 models on the card (scan and flash
    kernels) against themselves on the CPU (plain versions), same
    weights, smoke size, fp32: prefill and three decode steps, logits
    and every state and KV leaf."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import Model
    for arch in ("rwkv6-7b", "zamba2-1.2b"):
        phase(f"{arch} on the card against the CPU, smoke size, fp32")
        cfg = smoke_config(get_config(arch)).replace(
            n_layers=4, compute_dtype="float32")
        if arch == "zamba2-1.2b":    # stages (3, 2): both branches of the
            cfg = cfg.replace(n_layers=5, mesh_plan=dataclasses.replace(
                cfg.mesh_plan, pipe=2))               # shared-block rule
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        p_gpu = _tree_to(p_cpu, "cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 9),
                             generator=torch.Generator().manual_seed(1))
        worst = 0.0
        with torch.inference_mode():
            l_c, c_c = cpu.prefill(p_cpu, {"tokens": toks}, 16)
            l_g, c_g = gpu.prefill(p_gpu, {"tokens": toks.cuda()}, 16)
            pairs = [(l_g, l_c)]
            for pos in range(9, 12):
                tok = toks[:, pos - 9:pos - 8]
                d_c, c_c = cpu.decode_step(p_cpu, c_c, tok, pos)
                d_g, c_g = gpu.decode_step(p_gpu, c_g, tok.cuda(), pos)
                pairs.append((d_g, d_c))
                pairs += [(c_g[grp][k], c_c[grp][k]) for grp in c_c
                          for k in c_c[grp]]
        for g_, c_ in pairs:
            d = float((g_.cpu().float() - c_.float()).abs().max())
            check(torch.allclose(g_.cpu().float(), c_.float(), atol=1e-4,
                                 rtol=1e-4),
                  f"{arch}: card and CPU differ by {d:.3e} (tol 1e-4)")
            worst = max(worst, d)
        print(f"  logits and every state leaf, prefill + 3 decode steps: "
              f"max |d| {worst:.3e} (tol 1e-4)")


def scan_timings(torch, ops, ref, errs) -> dict:
    """Each scan variant at its main path's shape, bf16 inputs, full width
    (b 1, h 64, 64-wide state): decode (s = 1) beside a copy of the same 1
    MB state (the practical floor of that I/O), the stepwise kernel at s
    = 12, the chunked kernels at s = 2048; device ms, wall ms per call,
    the plain version's ms and the bound."""
    phase("timings of the scan kernels (CUDA events, after warm-up)")
    state = torch.randn(1, 64, 64, 64, device="cuda")
    dst = torch.empty_like(state)
    copy_ms, _ = time_ms(torch, lambda: dst.copy_(state), 500)
    print(f"  copy of the 1 MB fp32 state (dst.copy_(S), 1 MB read and 1 MB "
          f"written): {copy_ms:.5f} ms")
    rows = {}
    for kind in ("rwkv6", "mamba2"):
        rows[kind] = []
        for case, iters, plain_iters in (
                (ScanCase(kind, "decode s=1 bfloat16", 1, 1, 64, 64,
                          "bfloat16"), 500, 20),
                (ScanCase(kind, "prefill s=12 bfloat16", 1, 12, 64, 64,
                          "bfloat16"), 500, 10),
                (ScanCase(kind, "full s=2048 bfloat16", 1, 2048, 64, 64,
                          "bfloat16"), 20, 2)):
            args = case.tensors(torch, seed=7)
            fn = scan_fn(ops, case)
            ms, wall = time_ms(torch, lambda: fn(*args), iters)
            plain_ms, _ = time_ms(torch, lambda: case.plain(torch, ref,
                                                            args),
                                  plain_iters)
            bound_ms, bound_by = case.bound()
            width = "hd 64" if kind == "rwkv6" else "p 64, n 64, g 1"
            row = {
                "shape": f"{case.name}, b 1, h 64, {width}",
                "variant": case.variant(),
                "kernel": SCAN_SYMBOLS[kind][case.variant()],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "max_abs_err": errs[(kind, case.name)],
                "wall_ms_per_call": wall}
            extra = ""
            if case.variant() == "decode":
                row["state_copy_ms"] = copy_ms
                extra = f"  {ms / copy_ms:.2f}x the state copy"
            elif case.variant() == "chunk":
                extra = (f"  (fp32 recurrence's operations: "
                         f"{case.recurrence_ms():.4f} ms)")
            rows[kind].append(row)
            print(f"  {kind}_scan {case.name:<22} {row['kernel']}: {ms:.4f} "
                  f"ms (wall {wall:.4f} ms per call)  bound {bound_ms:.5f} "
                  f"ms ({bound_by})  plain {plain_ms:.4f} ms  library: "
                  f"none{extra}")
    print("  library: none -- no single PyTorch call computes either "
          "recurrence (a data-dependent decay per step and state element)")
    return rows


# the long-prompt phase: full-width, full-depth rwkv6-7b and zamba2-1.2b
# serving prompts of 1024-2048 tokens through the chunked scans
LONG_PROMPT = dict(requests=3, rate=1.0, prompt_lens=(1024, 2048),
                   gen_lens=(1, 4), prompt_budget=2048, page_seq=2112,
                   seed=0)


def long_prompt(torch, ops, arch: str) -> dict:
    """``repro_torch.launch.serve.main`` on full ``arch`` with long
    prompts: every request served, finite logits, every request's prefill
    scans on the chunked kernels and every decode step's on the decode
    kernels, and each request's time to first token; then
    :func:`long_prefill`."""
    lp = LONG_PROMPT
    phase(f"long prompt: repro_torch.launch.serve.main, full {arch}, bf16, "
          f"prompts {lp['prompt_lens'][0]}-{lp['prompt_lens'][1]}")
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.planner import serve_plan
    from repro_torch.serve import admissible, poisson_trace
    cfg = get_config(arch)
    per_call = per_call_launches(arch)
    scan = "rwkv6_scan" if cfg.ssm.kind == "rwkv6" else "mamba2_scan"
    trace = poisson_trace(lp["requests"], rate=lp["rate"], seed=lp["seed"],
                          prompt_lens=lp["prompt_lens"],
                          gen_lens=lp["gen_lens"], vocab=cfg.vocab_size)
    splan = serve_plan(cfg, n_stages=1, n_slots=1,
                       prompt_budget=lp["prompt_budget"],
                       page_seq=lp["page_seq"])
    live = [q for q in trace if admissible(q, splan)]
    check(len(live) == len(trace), "a long prompt was not admissible")
    want_prefill = 1 + len(live)                 # + the warm-up's one
    want_decode = 1 + sum(q.gen_len - 1 for q in live)
    pair = lambda lo_hi: f"{lo_hi[0]},{lo_hi[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "serve.jsonl"
        argv = ["--arch", arch, "--engine", "simple",
                "--requests", str(lp["requests"]),
                "--rate", str(lp["rate"]),
                "--prompt-lens", pair(lp["prompt_lens"]),
                "--gen-lens", pair(lp["gen_lens"]),
                "--prompt-budget", str(lp["prompt_budget"]),
                "--page-seq", str(lp["page_seq"]), "--seed", str(lp["seed"]),
                "--metrics-out", str(out)]
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        rc = serve.main(argv)
        torch.cuda.synchronize()
        counts, variants = ops.launch_counts(), ops.variant_counts()
        recs = [json.loads(x) for x in out.read_text().splitlines()]
    check(rc == 0, f"serve.main returned {rc}")
    run = [r for r in recs if r["event"] == "serve_run"][-1]
    summary = [r for r in recs if r["event"] == "summary"][-1]
    n_pf = summary["gauges"]["serve/prefill_calls"]
    n_dec = summary["gauges"]["serve/decode_calls"]
    check(run["n_served"] == len(live), "not every long prompt was served")
    check(summary["counters"].get("serve/nonfinite_logits", 0) == 0,
          "non-finite logits")
    check((n_pf, n_dec) == (want_prefill, want_decode),
          f"engine made {n_pf} + {n_dec} calls, expected {want_prefill} + "
          f"{want_decode}")
    want = {name: per_call.get(name, 0) * (want_prefill + want_decode)
            for name in counts}
    check(counts == want, f"the run launched {counts}, expected {want}")
    # every request's prefill on the chunked kernels; the decode steps and
    # the warm-up's one-token prefill on the decode kernel
    L = per_call[scan]
    got = (variants[f"{scan}_chunk"], variants[f"{scan}_decode"])
    exp = (L * (want_prefill - 1), L * (want_decode + 1))
    check(got == exp, f"{scan} chunked, decode launches {got}, expected "
          f"{exp}")
    print(f"  {scan}: {got[0]} chunked launches = {L} x {len(live)} "
          f"prefills, {got[1]} decode launches = {L} x ({want_decode} "
          f"decode steps + the warm-up's one-token prefill)")
    ttft = [(r["prompt_len"], r["ttft_ms"]) for r in recs
            if r["event"] == "serve_request"]
    check(len(ttft) == len(live) and all(math.isfinite(t) and t > 0
                                         for _, t in ttft),
          f"time to first token not reported for every request: {ttft}")
    for n, t in ttft:
        print(f"  request of {n} tokens: time to first token {t:.3f} ms")
    return {"ttft_ms": ttft, "launches": counts, "variants": variants,
            **long_prefill(torch, arch)}


def long_prefill(torch, arch: str) -> dict:
    """One prefill of the long-prompt trace's longest prompt on full
    ``arch``, bf16, random weights: timed (wall, the median of 3 after a
    warm-up) and profiled (device busy, the scans' share).  It calls only
    ``Model`` and the serving trace, so it also times another commit of
    the port imported in its place."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import poisson_trace
    lp = LONG_PROMPT
    cfg = get_config(arch)
    trace = poisson_trace(lp["requests"], rate=lp["rate"], seed=lp["seed"],
                          prompt_lens=lp["prompt_lens"],
                          gen_lens=lp["gen_lens"], vocab=cfg.vocab_size)
    req = max(trace, key=lambda q: len(q.prompt))
    longest = len(req.prompt)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg.compute_dtype)
    prompt = torch.tensor(list(req.prompt), device="cuda")[None]
    walls = []
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = model.prefill(params, {"tokens": prompt},
                                      lp["page_seq"])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        with device_profile() as prof:
            model.prefill(params, {"tokens": prompt}, lp["page_seq"])
            torch.cuda.synchronize()
    del params, model, logits
    gc.collect()
    torch.cuda.empty_cache()
    wall_ms = sorted(walls[1:])[1]
    kern = device_kernels(prof)
    check(bool(kern), "the profiler saw no device activity in the prefill")
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    stem = "wkv_" if cfg.ssm.kind == "rwkv6" else "ssd_"
    scan_kern = [e for e in kern if stem in e.key]
    scan_ms = sum(e.self_device_time_total for e in scan_kern) / 1e3
    print(f"  one prefill of {longest} tokens: wall {wall_ms:.3f} ms (median "
          f"of 3), device busy {busy_ms:.3f} ms, of which the scans "
          f"{scan_ms:.3f} ms ({sum(e.count for e in scan_kern)} kernels: "
          f"{sorted({e.key[:40] for e in scan_kern})})")
    return {"prefill_tokens": longest, "prefill_wall_ms": wall_ms,
            "prefill_busy_ms": busy_ms, "prefill_scan_ms": scan_ms}


# ---------------------------------------------------------------------------
# the pipelined engine: the paged decode wave and continuous batching

# the full-width pipelined run: the launcher's flags (pipe 4, 8 slots and
# pages, 2 prefill lanes, 16-token prompt budget, 64-position pages) and
# one seeded Poisson trace both engines serve
PIPE_ARCHS = ("granite-8b", "rwkv6-7b")
PIPE_PLAN = dict(n_stages=4, n_slots=8, max_prefill=2, prompt_budget=16,
                 n_pages=8, page_seq=64)
PIPE_TRACE = dict(n_requests=24, rate=2.0, seed=0, prompt_lens=(2, 12),
                  gen_lens=(8, 24))
PIPE_ARGV = ["--engine", "pipelined", "--pipe", "4", "--slots", "8",
             "--pages", "8", "--max-prefill", "2", "--prompt-budget", "16",
             "--page-seq", "64", "--requests", "24", "--rate", "2.0",
             "--prompt-lens", "2,12", "--gen-lens", "8,24", "--seed", "0"]
# the wave's attention row: granite-8b's heads, R = 8 rows at ragged
# lengths <= 64 on pages 0-7 of 9
WAVE_LENS = (64, 40, 17, 1, 64, 9, 33, 2)
# the rwkv6 wave's scan rows: pages 0-5 live, two idle rows on the trash
# page 8 of 9
WAVE_PAGES = (0, 1, 2, 3, 4, 5, 8, 8)
# the full-width wave against SimpleEngine's steps from the same page
# states: the wave may stray from the steps at most this many times as
# far as the steps stray from the same steps in fp32 (bf16 rounding)
WAVE_STEP_FACTOR = 4.0


class PagedCase:
    """One paged flash forward call (the decode wave): q [R, 1, H, d]
    against pages [n_pages + 1, page_seq, KV, d], row r at length
    ``lens[r]`` on page ``pages[r]``."""

    def __init__(self, name, H, KV, d, dtype, lens, pages, n_pages=8,
                 page_seq=64):
        self.name, self.H, self.KV, self.d = name, H, KV, d
        self.dtype, self.lens, self.pages = dtype, list(lens), list(pages)
        self.R, self.n_pages, self.page_seq = len(lens), n_pages, page_seq

    def tensors(self, torch, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        dt = getattr(torch, self.dtype)
        mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dt)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")
        return (mk(self.R, 1, self.H, self.d),
                mk(self.n_pages + 1, self.page_seq, self.KV, self.d),
                mk(self.n_pages + 1, self.page_seq, self.KV, self.d),
                i32(self.pages), i32(self.lens))

    def bound(self):
        """(least ms, what bounds it): q, each page's keys and values up
        to the longest length a row reads there (a page that rows share
        read once), o and lse; QK^T and PV over the rows' lengths."""
        el = 2 if self.dtype == "bfloat16" else 4
        keys = {}
        for p, n in zip(self.pages, self.lens):
            keys[p] = max(keys.get(p, 0), n)
        nbytes = el * (2 * self.R * self.H * self.d
                       + 2 * sum(keys.values()) * self.KV * self.d)
        nbytes += 4 * self.R * self.H
        flops = 4 * self.H * self.d * sum(self.lens)
        t_b = nbytes / HBM_BPS * 1e3
        t_f = flops / PEAK_FLOPS[self.dtype] * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def paged_cases() -> list:
    """R in {1, 3, 8} at lengths 1, 17 and 64 mixed, the last two rows
    of R >= 3 on the trash page; granite's heads (d 128) and zamba2's
    (d 64); fp32 and bf16; and the wave's row."""
    cases = []
    for heads, tag in (((32, 8, 128), "d128"), (ZAMBA2_ATTN, "d64")):
        for R in (1, 3, 8):
            pages = list(range(R))
            if R >= 3:
                pages[-2:] = [8, 8]
            lens = [(1, 17, 64)[r % 3] for r in range(R)]
            for dt in ("float32", "bfloat16"):
                cases.append(PagedCase(f"paged R={R} {tag} {dt}", *heads,
                                       dt, lens, pages))
    cases.append(PagedCase("wave R=8 ragged bfloat16", 32, 8, 128,
                           "bfloat16", WAVE_LENS, range(8)))
    return cases


def paged_checks(torch, fa, ref) -> dict:
    """The paged rows of both forward kernels against the plain version
    on the card (2e-5 fp32 on the FMA kernel, 2e-2 bf16 on the
    tensor-core kernel), one launch a call of the dtype's variant."""
    phase("flash_fwd paged rows (the decode wave) against the plain "
          "version on the card")
    errs = {}
    for i, case in enumerate(paged_cases()):
        args = case.tensors(torch, seed=300 + i)
        before = (fa.launches, fa.launches_mma)
        o, lse = fa.flash_fwd_paged(*args)
        torch.cuda.synchronize()
        mma = int(case.dtype == "bfloat16")
        check((fa.launches, fa.launches_mma) ==
              (before[0] + 1, before[1] + mma),
              f"{case.name}: not one launch of the "
              f"{'tensor-core' if mma else 'FMA'} kernel")
        o_r, lse_r = ref.flash_fwd_paged_ref(*args)
        tol = TOL[case.dtype]
        e = {}
        for got, want, nm in ((o.float(), o_r.float(), "o"),
                              (lse, lse_r, "lse")):
            check(bool(torch.isfinite(got).all()),
                  f"{case.name}: {nm} not finite")
            e[nm] = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=tol, rtol=tol),
                  f"{case.name}: {nm} max |d| {e[nm]:.3e} beyond {tol}")
        errs[case.name] = e["o"]
        print(f"  {case.name:<30} lens {case.lens} pages {case.pages}: "
              f"max|d o| {e['o']:.3e}  max|d lse| {e['lse']:.3e}  (tol "
              f"{tol:g})")
    return errs


def pipelined_check(torch) -> None:
    """The pipelined engine on the card against the CPU at the smoke
    size in fp32 (granite 4 layers, KV 2; rwkv6 4 layers; pipe 2):
    equal tokens, a clean request trace, one flash_fwd or rwkv6_scan a
    layer for each wave and each prefill lane."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.planner import serve_plan
    from repro_torch.planner import verify as pv
    from repro_torch.serve import ServeEngine, poisson_trace
    for arch in PIPE_ARCHS:
        phase(f"pipelined engine, {arch}: the card against the CPU, smoke "
              f"size, fp32, pipe 2")
        cfg = smoke_config(get_config(arch)).replace(
            n_layers=4, compute_dtype="float32")
        if cfg.ssm is None:
            cfg = cfg.replace(n_kv_heads=2)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        splan = serve_plan(cfg, n_stages=2, n_slots=4, max_prefill=2,
                           prompt_budget=8, page_seq=32)
        trace = poisson_trace(10, rate=1.5, seed=0, prompt_lens=(1, 8),
                              vocab=cfg.vocab_size)
        want = ServeEngine(cpu, p_cpu, splan).run(trace)
        eng = ServeEngine(gpu, _tree_to(p_cpu, "cuda"), splan)
        name = "flash_fwd" if cfg.ssm is None else "rwkv6_scan"
        before = ops.launch_counts()[name]
        got = eng.run(trace)
        torch.cuda.synchronize()
        n = ops.launch_counts()[name] - before
        rep = pv.verify_request_trace(eng.last_events, n_slots=4,
                                      n_pages=4, n_stages=2)
        print(f"  tokens equal on card and CPU: {got == want}; request "
              f"trace clean: {rep.ok}; {n} {name} launches = "
              f"{cfg.n_layers} x ({eng.n_waves} waves + {eng.n_lanes} "
              f"lanes)")
        check(got == want, f"{arch}: pipelined tokens differ between the "
              f"card and the CPU")
        check(rep.ok, f"{arch}: request trace: {rep.violations[:3]}")
        check(n == cfg.n_layers * (eng.n_waves + eng.n_lanes),
              f"{arch}: {n} {name} launches, expected "
              f"{cfg.n_layers} x ({eng.n_waves} + {eng.n_lanes})")


def _steady_round(eng, n_pages: int, pos: int = 40) -> dict:
    """A decode round with every slot live (page i, position ``pos``) and
    no prefill lane."""
    import numpy as np
    R = eng.splan.n_slots
    F = max(eng.splan.max_prefill, 1)
    return {"dec_tokens": np.arange(1, R + 1, dtype=np.int32),
            "dec_pos": np.full((R,), pos, np.int32),
            "dec_pages": np.arange(R, dtype=np.int32) % n_pages,
            "pf_tokens": np.zeros((F, eng.splan.prompt_budget), np.int32),
            "pf_len": np.zeros((F,), np.int32),
            "pf_pages": np.full((F,), n_pages, np.int32)}


def wave_against_steps(torch, eng, simple) -> dict:
    """One full-width decode wave (8 live rows on pages 0-7, ragged
    positions) against SimpleEngine's decode step taken row by row from
    the same page states: the logits and each row's state after the step
    (rwkv6 x_tm, x_cm, S; dense the page's keys and values).  Both are
    also held against the same steps in fp32 (the bf16 weights upcast),
    which measures bf16 rounding: the wave must stay within
    ``WAVE_STEP_FACTOR`` times the steps' own distance from fp32.  The
    engine's own round from the same states must then emit the wave's
    argmax and leave the pages bit for bit as the wave did."""
    import numpy as np
    from repro_torch.models import Model
    model, splan, dev = eng.model, eng.splan, eng.device
    cfg, vocab, C = model.cfg, model.cfg.vocab_size, len(eng._caches)
    R = splan.n_slots
    batch = _steady_round(eng, splan.n_pages)
    batch["dec_tokens"] = toks = np.random.default_rng(0).integers(
        0, vocab, R).astype(np.int32)
    batch["dec_pos"] = pos = np.array([n - 1 for n in WAVE_LENS],
                                      np.int32)[:R]
    pages = batch["dec_pages"]
    snap = [{k: a.clone() for k, a in c["layers"].items()}
            for c in eng._caches]

    def restore():
        for c, sn in zip(eng._caches, snap):
            for k, a in c["layers"].items():
                a.copy_(sn[k])

    pidx = torch.as_tensor(pages, dtype=torch.long, device=dev)

    def rows_state(layers):        # {k: [R, L, ...]} the rows' pages
        return {k: torch.cat([c[k][:, pidx] for c in layers], 0)
                .transpose(0, 1) for k in layers[0]}

    with torch.inference_mode():
        t = lambda a, dt=torch.int32: torch.tensor(a, dtype=dt,
                                                   device=dev)
        pos_t, pages_t = t(pos), t(pages)
        x = model.decode_embed(eng._outer, t(toks, torch.long)[:, None],
                               pos_t[:, None])
        for q in range(C):
            x = model.stage_decode(eng._chunks[q], eng._caches[q], x,
                                   pos_t, pages_t)
        wave = model.logits(eng._outer, x)[:, 0, :vocab].float()
        wave_st = rows_state([c["layers"] for c in eng._caches])
        restore()
        dec_next, _, _ = eng._round(batch)
        round_st = rows_state([c["layers"] for c in eng._caches])
        restore()
        m32 = Model(cfg.replace(compute_dtype="float32"), device=dev)
        steps = {"bf16": ([], []), "fp32": ([], [])}
        for r in range(R):
            p = int(pages[r])
            one = {k: torch.cat([sn[k][:, p:p + 1] for sn in snap], 0)
                   for k in snap[0]}
            for tag in steps:
                cache = {"layers": {k: (a.clone() if tag == "bf16"
                                        else a.float())
                                    for k, a in one.items()}}
                if tag == "bf16":
                    logits, cache = simple._decode(cache, int(toks[r]),
                                                   int(pos[r]))
                else:
                    logits, cache = m32.decode_step(
                        simple.params, cache, t([[toks[r]]], torch.long),
                        int(pos[r]))
                steps[tag][0].append(logits[0, -1, :vocab].float())
                steps[tag][1].append({k: a[:, 0] for k, a in
                                      cache["layers"].items()})
    lg = {tag: torch.stack(v[0]) for tag, v in steps.items()}
    st = {tag: {k: torch.stack([d[k] for d in v[1]]).float()
                for k in v[1][0]} for tag, v in steps.items()}
    wave_f = {k: a.float() for k, a in wave_st.items()}
    check(bool(torch.isfinite(wave).all()), "wave logits not finite")
    check(np.array_equal(dec_next, wave.argmax(-1).cpu().numpy()),
          "the engine's round emitted other tokens than the wave's argmax")
    check(all(torch.equal(round_st[k], wave_st[k]) for k in wave_st),
          "the engine's round left other page states than the wave")
    dist = lambda a, b: float((a - b).abs().max())
    out = {}
    for what, w, s16, s32 in (
            [("logits", wave, lg["bf16"], lg["fp32"])]
            + [(k, wave_f[k], st["bf16"][k], st["fp32"][k])
               for k in wave_f]):
        e_ws, e_sf, e_wf = dist(w, s16), dist(s16, s32), dist(w, s32)
        out[what] = {"wave_step": e_ws, "step_fp32": e_sf,
                     "wave_fp32": e_wf, "scale": float(s32.abs().max())}
        print(f"  wave vs steps, {what:<7}: max|wave - step| {e_ws:.3e}, "
              f"max|step - fp32| {e_sf:.3e}, max|wave - fp32| {e_wf:.3e} "
              f"(max|fp32| {out[what]['scale']:.3e})")
        check(e_ws <= WAVE_STEP_FACTOR * e_sf, f"wave {what}: max|wave - "
              f"step| {e_ws:.3e} beyond {WAVE_STEP_FACTOR} x the steps' "
              f"bf16 rounding {e_sf:.3e}")
    top2 = lg["fp32"].topk(2, -1).values
    am = {tag: a.argmax(-1) for tag, a in
          (("wave", wave), ("step", lg["bf16"]), ("fp32", lg["fp32"]))}
    out["argmax_equal"] = {
        "wave_step": int((am["wave"] == am["step"]).sum()),
        "step_fp32": int((am["step"] == am["fp32"]).sum()),
        "wave_fp32": int((am["wave"] == am["fp32"]).sum()), "rows": R}
    out["fp32_top2_margin"] = [float(m) for m in top2[:, 0] - top2[:, 1]]
    print(f"  argmax equal over {R} rows: wave/step "
          f"{out['argmax_equal']['wave_step']}, step/fp32 "
          f"{out['argmax_equal']['step_fp32']}, wave/fp32 "
          f"{out['argmax_equal']['wave_fp32']}; fp32 top-2 margins "
          f"{[round(m, 4) for m in out['fp32_top2_margin']]}")
    return out


def pipelined_path(torch, ops, arch: str) -> dict:
    """``repro_torch.launch.serve.main --engine pipelined`` on full
    ``arch`` (pipe 4, 8 slots and pages, bf16, random weights from seed
    0) over one Poisson trace of 24 requests, then ``SimpleEngine`` with
    the same weights on the same trace; a steady decode round profiled;
    the page writes and the rwkv6 state gather/scatter timed alone."""
    phase(f"pipelined serving: repro_torch.launch.serve.main --engine "
          f"pipelined, full {arch}, bf16")
    import gc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.obs import MetricsRegistry
    from repro_torch.planner import serve_plan
    from repro_torch.planner import verify as pv
    from repro_torch.serve import SimpleEngine, admissible, poisson_trace
    cfg = get_config(arch)
    L = cfg.n_layers
    name = "flash_fwd" if cfg.ssm is None else "rwkv6_scan"
    tr = dict(PIPE_TRACE)
    trace = poisson_trace(tr.pop("n_requests"), vocab=cfg.vocab_size, **tr)
    splan = serve_plan(cfg, **PIPE_PLAN)
    live = [q for q in trace if admissible(q, splan)]
    held = {}

    class Recording(serve.ServeEngine):
        """The launcher's engine, kept for the comparison and the
        profile, with each round's launches recorded."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rounds = []
            held["engine"] = self
            torch.cuda.synchronize()
            held["init_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()

        def _round(self, batch):
            c0, v0 = ops.launch_counts(), ops.variant_counts()
            out = super()._round(batch)
            c1, v1 = ops.launch_counts(), ops.variant_counts()
            self.rounds.append({
                "wave": bool((batch["dec_pages"] < splan.n_pages).any()),
                "lanes": [int(n) for n in batch["pf_len"] if n > 0],
                "launches": {k: c1[k] - c0[k] for k in c1},
                "variants": {k: v1[k] - v0[k] for k in v1}})
            return out

        def run(self, *a, **k):
            held["results"] = super().run(*a, **k)
            return held["results"]

    gc.collect()
    torch.cuda.empty_cache()
    orig = serve.ServeEngine
    serve.ServeEngine = Recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "serve.jsonl"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            rc = serve.main(["--arch", arch, *PIPE_ARGV,
                             "--metrics-out", str(out)])
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            variants = ops.variant_counts()
            peak = torch.cuda.max_memory_allocated()
            recs = [json.loads(x) for x in out.read_text().splitlines()]
    finally:
        serve.ServeEngine = orig
    check(rc == 0, f"serve.main returned {rc}")
    eng, results = held["engine"], held["results"]
    run = [r for r in recs if r["event"] == "serve_run"][-1]
    summary = [r for r in recs if r["event"] == "summary"][-1]
    gauges, counters = summary["gauges"], summary["counters"]
    check(run["engine"] == "pipelined", "the launcher did not serve "
          "through the pipelined engine")
    check(run["n_served"] == len(live) and all(
        len(results[q.rid]) == q.gen_len for q in live),
        "an admissible request did not get its gen_len tokens")
    check(counters.get("serve/nonfinite_logits", 0) == 0,
          "non-finite logits in a live row")
    rep = pv.verify_request_trace(eng.last_events, n_slots=splan.n_slots,
                                  n_pages=splan.n_pages,
                                  n_stages=splan.n_stages)
    check(rep.ok, f"request trace: {rep.violations[:3]}")
    # every round: L launches for the wave (when a slot is live) and L a
    # lane, nothing else; bf16 attention on the tensor cores, the wave's
    # scans (and a one-token lane's) on the decode kernel
    for i, rd in enumerate(eng.rounds):
        n_calls = int(rd["wave"]) + len(rd["lanes"])
        want = {k: 0 for k in rd["launches"]}
        want[name] = L * n_calls
        check(rd["launches"] == want, f"round {i}: launched "
              f"{rd['launches']}, expected {want}")
        want_v = {k: 0 for k in rd["variants"]}
        if name == "flash_fwd":
            want_v["flash_fwd_mma"] = L * n_calls
        else:
            want_v["rwkv6_scan_decode"] = L * (
                int(rd["wave"]) + sum(n == 1 for n in rd["lanes"]))
        check(rd["variants"] == want_v, f"round {i}: variants "
              f"{rd['variants']}, expected {want_v}")
    ev = eng.last_events
    waves = 1 + len({e["round"] for e in ev if e["ev"] == "decode"})
    lanes = 1 + sum(e["ev"] == "admit" for e in ev)
    check((eng.n_waves, eng.n_lanes) == (waves, lanes)
          == (gauges["serve/wave_calls"], gauges["serve/lane_calls"])
          == (sum(rd["wave"] for rd in eng.rounds),
              sum(len(rd["lanes"]) for rd in eng.rounds)),
          f"waves/lanes {eng.n_waves}/{eng.n_lanes}, event log "
          f"{waves}/{lanes} (warm-up included)")
    check(counts[name] == L * (waves + lanes),
          f"{counts[name]} {name} launches, expected {L} x ({waves} + "
          f"{lanes})")
    rounds_run = len(eng.rounds) - 1
    tok_per_s = gauges["serve/decode_tok_per_s"]
    print(f"  served {run['n_served']}/{run['n_requests']} requests, "
          f"{run['n_tokens']} tokens in {rounds_run} rounds ({waves - 1} "
          f"waves, {lanes - 1} prefill lanes); request trace clean")
    print(f"  {counts[name]} {name} launches = {L} x ({waves} + {lanes}) "
          f"(warm-up round included); variants {variants}")
    print(f"  pipelined: {tok_per_s:.2f} tok/s over the rounds' wall "
          f"({run['tok_per_s']:.2f} with the launcher's wall, warm-up "
          f"included), p50 {run['token_ms_p50']:.3f} ms/token, p99 "
          f"{run['token_ms_p99']:.3f}; warm-up {run['compile_s']:.2f}s; "
          f"peak {peak / 2**30:.2f} GiB serving (weights, pages, "
          f"activations), {held['init_peak'] / 2**30:.2f} GiB while the "
          f"launcher drew the weights")

    # SimpleEngine with the same weights (no copy) on the same trace
    reg = MetricsRegistry()
    simple = SimpleEngine(eng.model, {"outer": eng._outer,
                                      "stages": eng._chunks},
                          serve_plan(cfg, n_stages=1, n_slots=1,
                                     max_prefill=1, prompt_budget=16,
                                     page_seq=64, validate=False),
                          registry=reg)
    simple._warm_up()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_res = simple.run(trace)
    s_wall = time.perf_counter() - t0
    s_tokens = sum(len(t) for t in s_res.values())
    s_hist = reg.histogram("serve/token_ms")
    check(reg.counter("serve/nonfinite_logits").value == 0,
          "SimpleEngine: non-finite logits")
    first = [s_res[q.rid][0] == results[q.rid][0] for q in live]
    whole = [s_res[q.rid] == results[q.rid] for q in live]
    # where each request's two sequences part (the token index)
    parts = sorted(next((i for i, (a, b) in enumerate(zip(
        s_res[q.rid], results[q.rid])) if a != b), None)
        for q in live if s_res[q.rid] != results[q.rid])
    simple_tok_s = s_tokens / s_wall
    # the pipelined engine timed as SimpleEngine is: run(trace) after its
    # warm-up, by the wall clock around the call (bench/serve.py's window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.run(trace)
    p_wall = time.perf_counter() - t0
    p_tok_s = sum(len(t) for t in again.values()) / p_wall
    check(again == results, "a second pipelined run of the trace emitted "
          "other tokens than the first")
    print(f"  SimpleEngine, same weights and trace: {simple_tok_s:.2f} "
          f"tok/s over run()'s wall ({s_wall:.3f} s), p50 "
          f"{s_hist.percentile(50.0):.3f} ms/token, p99 "
          f"{s_hist.percentile(99.0):.3f}")
    print(f"  pipelined, the same window (run()'s wall after warm-up): "
          f"{p_tok_s:.2f} tok/s ({p_wall:.3f} s; the same tokens again); "
          f"pipelined / simple {p_tok_s / simple_tok_s:.2f}x")
    print(f"  first tokens equal to SimpleEngine's: {sum(first)}/"
          f"{len(first)}; whole sequences equal: {sum(whole)}/{len(whole)} "
          f"(not gated: bf16 GEMMs at M = 8 and M = 1 round apart); the "
          f"others part at token {parts}")
    check(all(first), "a request's first token differs from "
          "SimpleEngine's (same kernels on the same prefill shapes)")
    wave_cmp = wave_against_steps(torch, eng, simple)

    # one steady decode round: every slot live, no prefill lane
    batch = _steady_round(eng, splan.n_pages)
    with torch.inference_mode():
        for _ in range(2):
            eng._round(batch)
        steps, prof_steps = 8, 2
        t = time.perf_counter()
        for _ in range(steps):
            eng._round(batch)
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
        # a profile short of the kernel's exact count (records dropped,
        # as decode_profile has seen) is taken again, at most 3 times
        for attempt in range(3):
            with device_profile() as prof:
                for _ in range(prof_steps):
                    eng._round(batch)
                torch.cuda.synchronize()
            kern = device_kernels(prof)
            hits = [e for e in kern if KERNEL_SYMBOL[name] in e.key]
            n_hit = sum(e.count for e in hits)
            check(n_hit <= L * prof_steps, f"the profiled rounds show "
                  f"{n_hit} {KERNEL_SYMBOL[name]}, expected "
                  f"{L * prof_steps}")
            if n_hit == L * prof_steps:
                break
            print(f"  profile {attempt + 1} incomplete: {n_hit} "
                  f"{KERNEL_SYMBOL[name]}; again")
    check(bool(kern), "the profiler saw no device activity in the rounds")
    check(n_hit == L * prof_steps, f"the profiled rounds show {n_hit} "
          f"{KERNEL_SYMBOL[name]}, expected {L * prof_steps}")
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / prof_steps
    n_kern = sum(e.count for e in kern) / prof_steps
    kernel_ms = sum(e.self_device_time_total for e in hits) / 1e3 / \
        prof_steps
    index_ms = sum(e.self_device_time_total for e in kern
                   if "index" in e.key.lower()) / 1e3 / prof_steps
    idle = 100 * (1 - busy_ms / wall_ms)
    print(f"  steady decode round (8 live slots, no lane): {wall_ms:.3f} "
          f"ms wall, {busy_ms:.3f} ms busy ({idle:.1f}% idle), "
          f"{n_kern:.1f} kernels; {KERNEL_SYMBOL[name]} "
          f"{kernel_ms:.4f} ms; indexing kernels {index_ms:.4f} ms")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:8]:
        print(f"    {e.self_device_time_total / 1e3 / prof_steps:8.4f} ms "
              f"{e.count / prof_steps:6.1f}x  {e.key[:72]}")
    # the wave's page traffic alone, one layer's worth, CUDA events
    bufs = eng._caches[0]["layers"]
    rows = torch.arange(splan.n_slots, device="cuda")
    with torch.inference_mode():
        if name == "flash_fwd":
            kx = torch.randn(splan.n_slots, cfg.n_kv_heads, cfg.hd,
                             device="cuda").to(bufs["k"].dtype)
            cols = torch.full_like(rows, 40)

            def writes():
                bufs["k"][0][rows, cols] = kx
                bufs["v"][0][rows, cols] = kx
            page_ms, _ = time_ms(torch, writes, 200)
            traffic = {"page writes (k and v)": page_ms * L}
        else:
            st = {k: b[0][rows] for k, b in bufs.items()}

            def gather():
                return {k: b[0][rows] for k, b in bufs.items()}

            def scatter():
                for k, b in bufs.items():
                    b[0][rows] = st[k]
            g_ms, _ = time_ms(torch, gather, 200)
            s_ms, _ = time_ms(torch, scatter, 200)
            traffic = {"state gather": g_ms * L, "state scatter": s_ms * L}
    for what, ms in traffic.items():
        print(f"  {what}: {ms:.4f} ms of device time a wave ({L} layers, "
              f"timed alone)")
    return {"launches": counts, "variants": variants, "run": run,
              "tok_per_s": tok_per_s, "rounds": rounds_run,
              "waves": waves - 1, "lanes": lanes - 1, "peak_bytes": peak,
              "simple_tok_per_s": simple_tok_s,
              "simple_p50": s_hist.percentile(50.0),
              "simple_p99": s_hist.percentile(99.0),
              "first_equal": (sum(first), len(first)),
              "whole_equal": (sum(whole), len(whole)),
              "round_wall_ms": wall_ms, "round_busy_ms": busy_ms,
              "round_kernels": n_kern, "round_kernel_ms": kernel_ms,
              "round_index_ms": index_ms, "traffic_ms": traffic,
              "parts_at": parts, "wave_vs_steps": wave_cmp,
              "run_wall_s": p_wall, "run_tok_per_s": p_tok_s,
              "simple_wall_s": s_wall,
              "init_peak_bytes": held["init_peak"]}


def wave_timing(torch, fa, ref, errs) -> dict:
    """The wave's attention row (granite heads, R = 8, ragged lengths <=
    64, bf16): the kernel, its plain version, its bound, and SDPA on the
    gathered pages with a boolean key mask (the gather untimed)."""
    import torch.nn.functional as F
    case = paged_cases()[-1]
    q, kp, vp, pages, lens = case.tensors(torch, seed=7)
    # as the wave calls it: ranges checked on the host beforehand, so the
    # call does not read them back from the card
    ms, _ = time_ms(torch, lambda: fa.flash_fwd_paged(
        q, kp, vp, pages, lens, ranges_checked=True), 500)
    plain_ms, _ = time_ms(torch, lambda: ref.flash_fwd_paged_ref(
        q, kp, vp, pages, lens), 500)
    idx = pages.long()
    kt, vt = kp[idx].transpose(1, 2), vp[idx].transpose(1, 2)
    mask = (torch.arange(case.page_seq, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    o_lib = sdpa().transpose(1, 2)
    o_ker, _ = fa.flash_fwd_paged(q, kp, vp, pages, lens)
    check(torch.allclose(o_lib.float(), o_ker.float(), atol=2e-2,
                         rtol=2e-2), "SDPA with the key mask disagrees "
          "with the paged kernel")
    lib_ms, _ = time_ms(torch, sdpa, 500)
    bound_ms, bound_by = case.bound()
    row = {"shape": case.name, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
           "library": "SDPA on the gathered pages, boolean key mask",
           "max_abs_err": errs[case.name]}
    print(f"  {case.name:<28} kernel {ms:.4f} ms  bound "
          f"{bound_ms:.5f} ms ({bound_by})  plain {plain_ms:.4f} ms  "
          f"sdpa+mask {lib_ms:.4f} ms "
          f"({ms / lib_ms:.2f}x sdpa)")
    return row


# ---------------------------------------------------------------------------
# training


def train_check(torch) -> None:
    """The streaming SpecTrain tick on the card (kernels) against the same
    tick on the CPU (plain versions), smoke size, fp32, 4 stages."""
    S = TRAIN_STAGES
    n = 2 * (S - 1) + 3
    phase(f"training on the card against the CPU: {n} spectrain ticks, "
          f"{S} stages, smoke size, fp32")
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=4, n_kv_heads=2, compute_dtype="float32",
        mesh_plan=get_config(ARCH).mesh_plan)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    check(cpu.n_stages == S, "smoke model is not 4 stages")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _tree_to(p_cpu, "cuda")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    runs = {}
    for name, model, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        state = ps.make_state(model, params, batches[0], mode="spectrain")
        step = ps.make_train_step(model, mode="spectrain", lr=0.05)
        losses = []
        for b in batches:
            state, met = step(state, b)
            losses.append(float(met["loss"]))
        runs[name] = (state, losses)
    (s_c, l_c), (s_g, l_g) = runs["cpu"], runs["gpu"]
    l_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(l_g, l_c))
    check(l_err <= 1e-5, f"losses differ by rel {l_err:.3e} (tol 1e-5)")
    worst = 0.0
    for key in ("params", "momentum", "pred"):
        for g, c in zip(tree_leaves(s_g[key]), tree_leaves(s_c[key])):
            g = g.cpu()
            check(torch.allclose(g, c, rtol=1e-4, atol=1e-5),
                  f"{key} leaf differs by {float((g - c).abs().max())}")
            worst = max(worst, float((g - c).abs().max()))
    print(f"  losses max rel |d| {l_err:.3e} (tol 1e-5); params, momentum, "
          f"pred max |d| {worst:.3e} (rtol 1e-4 / atol 1e-5)")


def train_main_path(torch, ops) -> dict:
    S, L = TRAIN_STAGES, TRAIN_LAYERS
    phase(f"main path: repro_torch.launch.train.main, {ARCH} full width, "
          f"{L} layers in {S} stages, bf16, spectrain, {TRAIN_STEPS} ticks")
    from repro_torch.launch import train
    from repro_torch.models.layers import tree_leaves
    want_tick = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                 "fused_update": S + 1}
    # bf16: every forward, dq and dk/dv on the tensor-core kernels
    want_var = {"flash_fwd_mma": 2 * L, "flash_bwd_dq_mma": L,
                "flash_bwd_dkv_mma": L}
    # tick 7 profiled (8 or 9 if a profile comes up short)
    sp = StepProfile("train tick", want_tick, 7, TRAIN_STEPS - 1)
    rec = {"counts": [], "variants": [], "valid": [], "loss": [], "t": [],
           "t_end": [], "stage0": []}
    snap = {}

    def on_step(s, state, metrics):
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["counts"].append(dict(ops.launch_counts()))
        rec["variants"].append(dict(ops.variant_counts()))
        rec["valid"].append(metrics["loss_valid"])
        rec["loss"].append(float(metrics["loss"]))
        stage0 = tree_leaves(state["params"]["stages"][0])
        if s == 0:
            snap["stage0"] = [t.clone() for t in stage0]
        rec["stage0"].append(all(torch.equal(a, b) for a, b in
                                 zip(stage0, snap["stage0"])))
        sp.hook(s)
        rec["t_end"].append(time.perf_counter())

    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = train.main(TRAIN_ARGV, on_step=on_step)
    torch.cuda.synchronize()
    total = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"train.main returned {rc}")
    check(len(rec["loss"]) == TRAIN_STEPS, "not every tick ran")
    prev, prev_v = {k: 0 for k in want_tick}, {k: 0 for k in want_var}
    for s, (counts, var) in enumerate(zip(rec["counts"], rec["variants"])):
        got = {k: counts[k] - prev[k] for k in want_tick}
        check(got == want_tick, f"tick {s} launched {got}, expected "
              f"{want_tick}")
        got_v = {k: var[k] - prev_v[k] for k in want_var}
        check(got_v == want_var, f"tick {s} launched tensor-core "
              f"variants {got_v}, expected {want_var}")
        prev, prev_v = counts, var
    check(total == {k: want_tick.get(k, 0) * TRAIN_STEPS for k in total},
          f"the run launched {total}")
    check(all(math.isfinite(x) for x in rec["loss"]), "non-finite loss")
    check(rec["valid"] == [float(s >= S - 1) for s in range(TRAIN_STEPS)],
          f"loss_valid per tick {rec['valid']}")
    check(rec["stage0"] == [s < 2 * (S - 1) for s in range(TRAIN_STEPS)],
          f"stage 0 unchanged per tick {rec['stage0']} (expected until "
          f"tick {2 * (S - 1)})")
    # tick i: from the end of the hook after tick i-1 to the start of the
    # hook after tick i (which synchronises first)
    steady = sorted(rec["t"][i] - rec["t_end"][i - 1]
                    for i in range(1, TRAIN_STEPS) if i not in sp.steps)
    wall_ms = steady[len(steady) // 2] * 1e3
    tok_per_s = TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3)
    print(f"  {TRAIN_STEPS} ticks in {time.perf_counter() - t0:.2f}s "
          f"(init and first-tick set-up included); losses "
          f"{[round(x, 4) for x in rec['loss']]}")
    print(f"  per tick: {want_tick} launches, of which tensor-core "
          f"{want_var} (exact on every tick)")
    print(f"  loss valid from tick {S - 1}; stage 0 unchanged through tick "
          f"{2 * (S - 1) - 1}, moved from tick {2 * (S - 1)}")
    print(f"  tick wall (median of ticks 1..{TRAIN_STEPS - 1} but the "
          f"profiled one): {wall_ms:.3f} ms  ({tok_per_s:.1f} tokens/s)")
    print(f"  peak torch.cuda.max_memory_allocated: {peak / 2**30:.2f} GiB")
    kern = sp.result()
    check(bool(kern), f"the profiler saw no device activity in tick "
          f"{sp.at}")
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"  tick {sp.at} under torch.profiler: device busy "
          f"{busy_ms:.3f} ms, {100 * busy_ms / wall_ms:.1f}% of the "
          f"unprofiled tick wall (idle {100 * (1 - busy_ms / wall_ms):.1f}%)")
    print(f"  device ms by kind: {kernel_kinds(kern)}")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms "
              f"{e.count:5d}x  {e.key[:72]}")
    by = {}
    for name, want in want_tick.items():
        hits = [e for e in kern if KERNEL_SYMBOL[name] in e.key]
        n_hit = sum(e.count for e in hits)
        check(n_hit == want, f"the profiled tick shows {n_hit} {name} "
              f"kernels, expected {want}")
        by[name] = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"  {name}: {n_hit} kernels, {by[name]:.4f} ms per tick "
              f"({100 * by[name] / busy_ms:.1f}% of device busy)")
    return {"launches": total, "per_tick": want_tick,
            "variants_per_tick": want_var, "wall_ms": wall_ms,
            "tok_per_s": tok_per_s, "peak_bytes": peak,
            "losses": rec["loss"], "busy_ms": busy_ms, "kernel_ms": by}


# ---------------------------------------------------------------------------
# the round schedules through the IR interpreter (gpipe, 1f1b, 2bw,
# interleaved), planned by the port's planner

IR_ROUNDS, IR_PROF_ROUND = 4, 2
IR_BASE = ["--arch", ARCH, "--pipe", str(TRAIN_STAGES), "--batch",
           str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--dtype", "bfloat16",
           "--data-kind", "uniform", "--steps", str(IR_ROUNDS),
           "--log-every", "1"]
# (label, argv, layers, virtual stages, the dp split the plan must carry);
# 2bw's vanilla mode is held to JAX on the CPU only.  At 7 layers the dp
# split (2, 2, 1, 2) differs from the model's uniform (2, 2, 2, 1), so the
# stage trees are regrouped at full width
IR_RUNS = [
    ("gpipe spectrain", ["--schedule", "gpipe"], 8, 1, (2, 2, 2, 2)),
    ("1f1b spectrain", ["--schedule", "1f1b"], 8, 1, (2, 2, 2, 2)),
    ("2bw spectrain", ["--schedule", "2bw"], 8, 1, (2, 2, 2, 2)),
    ("2bw pipedream", ["--schedule", "2bw", "--mode", "pipedream"], 8, 1,
     (2, 2, 2, 2)),
    ("interleaved v2 spectrain", ["--schedule", "interleaved",
                                  "--virtual-stages", "2"], 8, 2, (1,) * 8),
    ("1f1b spectrain, 7 layers (dp regroups)", ["--schedule", "1f1b"], 7,
     1, (2, 2, 1, 2)),
]
# the IR update's arguments (the launcher's defaults; no ŵ, s 0)
IR_FU_KW = dict(lr=1e-2, gamma=0.9, s=0.0)
IR_CHECK_SCHEDULES = [("gpipe", "spectrain", 1), ("1f1b", "vanilla", 1),
                      ("2bw", "spectrain", 1), ("2bw", "pipedream", 1),
                      ("interleaved", "spectrain", 2)]


# a profiled kernel's kind, by its name: the first pattern it contains
KERNEL_KINDS = (("attention", ("flash_",)), ("fused_update",
                                             ("fused_update",)),
                ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
                ("copy", ("Memcpy", "direct_copy")),
                ("fill", ("FillFunctor", "Memset")),
                ("add", ("CUDAFunctor_add",)),
                ("elementwise", ("elementwise",)))


def kernel_kinds(kern) -> dict:
    """Device ms of a profile's kernels summed by :data:`KERNEL_KINDS`
    (the rest under "other"), rounded to 0.001 ms."""
    by = {}
    for e in kern:
        kind = next((k for k, pats in KERNEL_KINDS
                     if any(p in e.key for p in pats)), "other")
        by[kind] = by.get(kind, 0.0) + e.self_device_time_total / 1e3
    return {k: round(v, 3) for k, v in sorted(by.items(),
                                              key=lambda kv: -kv[1])}


def ir_check(torch) -> None:
    """Three IR rounds of each round schedule on the card against the
    same rounds on the CPU: 2 stages of a 5-layer smoke granite in fp32
    (a ragged dp split; 4 chunks of the interleaved plan), the CPU parity
    tests' tolerances."""
    phase("IR rounds on the card against the CPU: gpipe, 1f1b, 2bw "
          "(spectrain, pipedream), interleaved v2, smoke size, fp32")
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.models import Model
    from repro_torch.models.layers import tree_leaves
    from repro_torch.planner import plan
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=5, n_kv_heads=2, compute_dtype="float32",
        mesh_plan=dataclasses.replace(get_config(ARCH).mesh_plan, pipe=2))
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    for schedule, mode, v in IR_CHECK_SCHEDULES:
        pplan = plan(cfg, n_stages=2, schedule=schedule, virtual_stages=v,
                     n_microbatches=2, batch=4, seq=16, device="cpu")
        runs = {}
        # copies: a state takes its params over and updates them
        for name, model, params in (("cpu", cpu, _tree_to(p_cpu, "cpu")),
                                    ("gpu", gpu, _tree_to(p_cpu, "cuda"))):
            state = ps.make_ir_state(model, params, plan=pplan, mode=mode)
            step = ps.make_ir_train_step(model, plan=pplan, mode=mode,
                                         lr=0.05)
            runs[name] = (state, [float(step(state, b)[1]["loss"])
                                  for b in batches])
        (s_c, l_c), (s_g, l_g) = runs["cpu"], runs["gpu"]
        l_err = max(abs(a - b) / max(abs(b), 1e-12)
                    for a, b in zip(l_g, l_c))
        check(l_err <= 1e-5, f"{schedule}: losses differ by rel "
              f"{l_err:.3e} (tol 1e-5)")
        worst = 0.0
        for key in ("params", "momentum") + (("stash",) if "stash" in s_c
                                             else ()):
            for g, c in zip(tree_leaves(s_g[key]), tree_leaves(s_c[key])):
                g = g.cpu()
                check(torch.allclose(g, c, rtol=1e-4, atol=1e-5),
                      f"{schedule} {mode}: {key} leaf differs by "
                      f"{float((g - c).abs().max())}")
                worst = max(worst, float((g - c).abs().max()))
        print(f"  {schedule} {mode} ({pplan.summary()}): losses max rel "
              f"|d| {l_err:.3e} (tol 1e-5); every state leaf max |d| "
              f"{worst:.3e} (rtol 1e-4 / atol 1e-5)")


def ir_update_checks(torch, ops, ref) -> None:
    """The IR update's groups at full width, one launch each against its
    plain version: a chunk tree of every layer count the runs below
    give a chunk, and the outer tree; fp32 w, v and the round's fp32
    mean gradient, no ŵ."""
    phase("fused_update at the IR rounds' groups against its plain "
          "version on the card")
    n_layers = sorted({n for *_, sizes in IR_RUNS for n in sizes})
    for label, specs in ([(f"chunk tree of {n} layer(s)",
                           group_specs("stage", n)) for n in n_layers]
                         + [("outer tree", group_specs("outer"))]):
        ws, vs, gs, _ = make_group(torch, specs, lambda path: False)
        err = fu_compare(torch, ops, ref, ws, vs, gs, None, label,
                         IR_FU_KW)
        print(f"  {label}: {len(ws)} tensors, "
              f"{sum(w.numel() for w in ws)} elements, {IR_FU_KW}: one "
              f"launch, max |d| {err:.3e} (tol {FU_TOL['float32']:g})")
        del ws, vs, gs
        torch.cuda.empty_cache()


def ir_schedules(torch, ops, ref) -> dict:
    """Each round schedule through ``repro_torch.launch.train.main`` on
    full-width granite-8b, 4 stages, batch 8 x 512, bf16: the plan (dp,
    verified before the first round), finite losses, exact launches a
    round, one profiled round, peak memory and, for 2bw, the stash
    copy."""
    import contextlib
    import io
    from repro_torch.core import pipeline_stream as ps
    from repro_torch.launch import train
    ir_update_checks(torch, ops, ref)
    out = {}
    for label, argv, L, v, sizes in IR_RUNS:
        phase(f"ir_schedules: repro_torch.launch.train.main, {ARCH} full "
              f"width, {L} layers in {TRAIN_STAGES} stages, bf16, {label}, "
              f"{IR_ROUNDS} rounds")
        rec = {"counts": [], "variants": [], "loss": [], "t": [],
               "t_end": []}
        snap = {}
        M, C = IR_ROUND, TRAIN_STAGES * v
        want = {"flash_fwd": 2 * L * M, "flash_bwd_dq": L * M,
                "flash_bwd_dkv": L * M, "fused_update": C + 1}
        want_v = {"flash_fwd_mma": 2 * L * M, "flash_bwd_dq_mma": L * M,
                  "flash_bwd_dkv_mma": L * M}
        sp = StepProfile(label, want, IR_PROF_ROUND, IR_ROUNDS - 1)

        def on_step(s, state, metrics):
            torch.cuda.synchronize()
            rec["t"].append(time.perf_counter())
            rec["counts"].append(dict(ops.launch_counts()))
            rec["variants"].append(dict(ops.variant_counts()))
            rec["loss"].append(float(metrics["loss"]))
            sp.hook(s)
            if s == IR_ROUNDS - 1 and "stash" in state:
                # the double buffer's copy alone (after the last round:
                # it rewrites the stash), CUDA events, 3 runs
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                times = []
                for _ in range(3):
                    ev[0].record()
                    ps._stash_before_update(state)
                    ev[1].record()
                    ev[1].synchronize()
                    times.append(ev[0].elapsed_time(ev[1]))
                snap["stash_ms"] = sorted(times)[1]
                snap["stash_bytes"] = 2 * sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves(state["stash"]))
            rec["t_end"].append(time.perf_counter())

        from repro_torch.models.layers import tree_leaves
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train.main(IR_BASE + ["--layers", str(L)] + argv,
                            on_step=on_step)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        total = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        text = buf.getvalue()
        print("  " + text.strip().replace("\n", "\n  "))
        check(rc == 0, f"{label}: train.main returned {rc}")
        check(len(rec["loss"]) == IR_ROUNDS, f"{label}: not every round ran")
        plan_line = next((x for x in text.splitlines()
                          if x.startswith("# plan[")), "")
        check(f"part=dp:{sizes}" in plan_line,
              f"{label}: the plan is not the dp split {sizes}: "
              f"{plan_line!r}")
        m = re.search(r"# schedule \S+: round=(\d+) microbatches", text)
        check(m is not None, f"{label}: no round line printed")
        check(int(m.group(1)) == M, f"{label}: round of {m.group(1)} "
              f"microbatches, expected {M}")
        prev, prev_v = {k: 0 for k in want}, {k: 0 for k in want_v}
        for s, (counts, var) in enumerate(zip(rec["counts"],
                                              rec["variants"])):
            got = {k: counts[k] - prev[k] for k in want}
            check(got == want, f"{label}: round {s} launched {got}, "
                  f"expected {want}")
            got_v = {k: var[k] - prev_v[k] for k in want_v}
            check(got_v == want_v, f"{label}: round {s} launched "
                  f"tensor-core variants {got_v}, expected {want_v}")
            prev, prev_v = counts, var
        check(total == {k: want.get(k, 0) * IR_ROUNDS for k in total},
              f"{label}: the run launched {total}")
        check(all(math.isfinite(x) for x in rec["loss"]),
              f"{label}: non-finite loss {rec['loss']}")
        steady = sorted(rec["t"][i] - rec["t_end"][i - 1]
                        for i in range(1, IR_ROUNDS) if i not in sp.steps)
        wall_ms = steady[len(steady) // 2] * 1e3
        kern = sp.result()
        check(bool(kern), f"{label}: the profiler saw no device activity")
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        by = {}
        for name, n in want.items():
            hits = [e for e in kern if KERNEL_SYMBOL[name] in e.key]
            n_hit = sum(e.count for e in hits)
            check(n_hit == n, f"{label}: the profiled round shows {n_hit} "
                  f"{name} kernels, expected {n}")
            by[name] = sum(e.self_device_time_total for e in hits) / 1e3
        r = {"label": label, "layers": L, "chunks": C, "round": M,
             "plan": plan_line, "launches": total, "per_round": want,
             "wall_ms": wall_ms, "busy_ms": busy_ms,
             "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / (wall_ms / 1e3),
             "peak_bytes": peak, "losses": rec["loss"], "kernel_ms": by,
             "n_kernels": sum(e.count for e in kern), "run_s": run_s,
             "stash_ms": snap.get("stash_ms"),
             "stash_bytes": snap.get("stash_bytes")}
        print(f"  per round: {want} launches, every attention launch on "
              f"the tensor cores {want_v} (exact on every round); losses "
              f"{[round(x, 4) for x in rec['loss']]}")
        print(f"  round wall (median of rounds 1..{IR_ROUNDS - 1} but the "
              f"profiled ones {sp.steps}): {wall_ms:.3f} ms "
              f"({r['tok_per_s']:.1f} tokens/s); profiled round {sp.at}: "
              f"device busy "
              f"{busy_ms:.3f} ms (idle {100 * (1 - busy_ms / wall_ms):.1f}%"
              f" of the unprofiled wall), {r['n_kernels']} kernels; "
              f"fused_update {by['fused_update']:.3f} ms in {C + 1} "
              f"launches; attention fwd+dq+dk/dv "
              f"{by['flash_fwd'] + by['flash_bwd_dq'] + by['flash_bwd_dkv']:.3f}"
              f" ms; peak {peak / 2**30:.2f} GiB; run {run_s:.1f} s")
        if r["stash_ms"] is not None:
            print(f"  2bw stash copy (params + momentum, "
                  f"{r['stash_bytes'] / 1e9:.2f} GB moved): "
                  f"{r['stash_ms']:.3f} ms")
        r["by_kind"] = kernel_kinds(kern)
        print(f"  device ms by kind: {r['by_kind']}")
        kern.sort(key=lambda e: -e.self_device_time_total)
        for e in kern[:10]:
            print(f"    {e.self_device_time_total / 1e3:9.4f} ms "
                  f"{e.count:5d}x  {e.key[:72]}")
        out[label] = r
        del snap
    return out


def train_timings(torch, fa, ref, ops, bwd_errs) -> list:
    phase("timings of the training kernels (CUDA events, after warm-up)")
    import torch.nn.functional as F
    rows = []
    case = BwdCase("train b8 512 causal bfloat16", TRAIN_BATCH, TRAIN_SEQ,
                   TRAIN_SEQ, 32, 8, 128, "bfloat16", True)
    q, k, v, o, lse, do = case.all_tensors(torch, fa, seed=9)
    kw = case.kw()
    # each kernel alone, through the launchers flash_bwd itself uses
    launch_dq, launch_dkv, _ = fa._bwd_launchers(q, k, v, o, lse, do,
                                                 **kw)
    ms_dq, _ = time_ms(torch, launch_dq, 20)
    ms_dkv, _ = time_ms(torch, launch_dkv, 20)
    ms_wrap, wall_wrap = time_ms(
        torch, lambda: fa.flash_bwd(q, k, v, o, lse, do, **kw), 20)
    plain_ms, _ = time_ms(
        torch, lambda: ref.flash_bwd_ref(q, k, v, o, lse, do, **kw), 5)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                           retain_graph=True)
    lib_ms, _ = time_ms(torch, sdpa_bwd, 20)
    lib_kernels = library_kernels(torch, sdpa_bwd)
    print(f"  SDPA backward ran {lib_kernels}")
    for name, which, ms in (("flash_bwd_dq", "dq", ms_dq),
                            ("flash_bwd_dkv", "dkv", ms_dkv)):
        b_ms, b_by = case.bound(which)
        rows.append({"name": name, "shape": case.name, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "library_kernels": lib_kernels,
                     "max_abs_err": bwd_errs[case.name][which]})
        print(f"  {name:<14} {case.name}: kernel {ms:.4f} ms  bound "
              f"{b_ms:.5f} ms ({b_by})  plain (dq, dk, dv together) "
              f"{plain_ms:.4f} ms  SDPA backward (dq, dk, dv together) "
              f"{lib_ms:.4f} ms")
    print(f"  flash_bwd wrapper (dl + both kernels): {ms_wrap:.4f} ms "
          f"device, {wall_wrap:.4f} ms wall per call; dq + dk/dv "
          f"{ms_dq + ms_dkv:.4f} ms = {(ms_dq + ms_dkv) / lib_ms:.2f}x SDPA "
          f"backward")
    del qt, kt, vt, ot, q, k, v, o, lse, do, launch_dq, launch_dkv

    # the main path's two kinds of group, fp32 w/v/g: one stage (2
    # full-width layers, fp32 ŵ for every leaf) and the outer tree (fp32
    # ŵ for embed.tok only); each checked once against its plain version,
    # then timed
    fu_rows = []
    for label, specs, predicted in (
            (f"one stage ({TRAIN_LAYERS // TRAIN_STAGES} layers), ŵ on "
             f"every leaf", group_specs("stage", TRAIN_LAYERS // TRAIN_STAGES),
             lambda path: True),
            ("outer tree, ŵ on embed.tok", group_specs("outer"),
             lambda path: path == ("embed", "tok"))):
        ws, vs, gs, whats = make_group(torch, specs, predicted)
        n = sum(w.numel() for w in ws)
        n_pred = sum(w.numel() for w in (whats or []) if w is not None)
        err = fu_compare(torch, ops, ref, ws, vs, gs, whats, label)
        ms, _ = time_ms(torch, lambda: ops.fused_update(
            ws, vs, gs, whats=whats, **FU_KW), 10)
        plain_ms, _ = time_ms(torch, lambda: [
            ref.fused_update_ref(w, v, g, **FU_KW) for w, v, g in
            zip(ws, vs, gs)], 3)
        params = [torch.nn.Parameter(w) for w in ws]
        for p_, g in zip(params, gs):
            p_.grad = g
        # dampening = gamma gives v' = gamma v + (1 - gamma) g (the
        # paper's form); it writes w' and v' but no prediction
        opt = torch.optim.SGD(params, lr=FU_KW["lr"],
                              momentum=FU_KW["gamma"],
                              dampening=FU_KW["gamma"], fused=True)
        lib_ms, _ = time_ms(torch, opt.step, 10)
        # w, v, g read; w', v' written; ŵ written where predicted
        nbytes = 4 * (5 * n + n_pred)
        b_ms = nbytes / HBM_BPS * 1e3
        shape = (f"{label}: {len(ws)} tensors, {n} elements, fp32 "
                 f"w/v/g/ŵ")
        fu_rows.append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": "bytes",
                        "library_ms": lib_ms, "max_abs_err": err})
        print(f"  fused_update   {shape} ({nbytes / 1e9:.2f} GB): one "
              f"launch against its plain version max |d| {err:.3e} (tol "
              f"{FU_TOL['float32']:g}); kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s)  bound {b_ms:.4f} ms "
              f"(bytes)  plain {plain_ms:.4f} ms  "
              f"torch.optim.SGD(fused, no ŵ) {lib_ms:.4f} ms")
        del ws, vs, gs, whats, params, opt
    rows.append({"name": "fused_update", **fu_rows[0], "shapes": fu_rows})
    return rows


# ---------------------------------------------------------------------------
# the paper's evaluation: the four-scheme simulator (Fig. 7), Fig. 8's
# RMSE and Table 1's ordering, on the full-width snn-paper

EVAL_ARCH, EVAL_CLASSES = "snn-paper", 10       # CIFAR-10's classes
# the loss plateaus near the label prior's entropy for ~300 steps and
# then falls: at 600 every scheme is well past the prior (sync ~1.76
# against 2.30, held-out accuracy ~0.40 against a 0.11 majority share)
EVAL_BATCH, EVAL_STEPS = 128, 600
# spectrain's second run, with Fig. 8's RMSEs, follows the first 300 steps
# of the same trajectory (its learning is checked on the first run)
EVAL_RMSE_STEPS = 300
EVAL_HELD = 4096                    # held-out teacher samples a scheme
# staleness shows at 0.01: vanilla and pipedream end above sync,
# spectrain near it; at 0.02 vanilla diverges, at 0.1 sync does too
EVAL_LR = 0.01
EVAL_PROFILED = (200, 203)          # steady steps under torch.profiler
SIM_TOL = (1e-5, 1e-6)              # rtol, atol: the CPU parity tests'


def _mean(xs) -> float:
    return float(sum(xs) / len(xs))


def _sim_metrics_close(got, want, what: str) -> float:
    """Every metric of every step within ``SIM_TOL``; the largest
    relative difference."""
    rtol, atol = SIM_TOL
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.keys() == w.keys(), f"{what} step {i}: metrics differ")
        for k in w:
            d = abs(g[k] - w[k])
            check(d <= atol + rtol * abs(w[k]), f"{what} step {i} {k}: "
                  f"card {g[k]!r} CPU {w[k]!r}")
            worst = max(worst, d / max(abs(w[k]), 1e-30))
    return worst


def _trees_close(torch, got, want, what: str) -> float:
    from repro_torch.models.layers import tree_leaves
    rtol, atol = SIM_TOL
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g = g.cpu()
        check(torch.allclose(g, w, rtol=rtol, atol=atol),
              f"{what}: a leaf differs by {float((g - w).abs().max())}")
        worst = max(worst, float((g - w).abs().max()))
    return worst


def simulator_check(torch, ops) -> None:
    """The simulator on the card (cuBLAS, the fused update kernel and,
    through ``staged_from_model``, the fp32 flash kernels) against the
    same simulator on the CPU, 10 steps of each scheme at the CPU tests'
    sizes, within their tolerances."""
    phase("simulator on the card against the CPU: 10 steps of each "
          "scheme, make_mlp_staged and staged_from_model, fp32")
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.simulator import (Simulator, make_mlp_staged,
                                            staged_from_model)
    from repro_torch.models import Model
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((16, 8)).astype(np.float32)
    mlp_batches = []
    for _ in range(10):
        x = rng.standard_normal((32, 16)).astype(np.float32)
        mlp_batches.append({"x": x, "y": (x @ w_true).argmax(-1)})
    cfg = smoke_config(get_config(ARCH)).replace(
        n_layers=4, n_kv_heads=2, compute_dtype="float32",
        mesh_plan=dataclasses.replace(get_config(ARCH).mesh_plan, pipe=2))
    lm_batches = []
    for _ in range(10):
        t = rng.integers(0, cfg.vocab_size, size=(2, 9))
        lm_batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    models = {dev: Model(cfg, device=dev) for dev in ("cpu", "cuda")}
    p_lm = models["cpu"].init(torch.Generator().manual_seed(0))

    def setups(dev):
        fns, params = make_mlp_staged(
            torch.Generator().manual_seed(0), in_dim=16, width=32, depth=4,
            n_classes=8, n_stages=4, device=dev)
        yield "make_mlp_staged", fns, params, 4, mlp_batches, (1, 2, 3)
        fns, repack = staged_from_model(models[dev])
        yield ("staged_from_model", fns, repack(_tree_to(p_lm, dev)), 2,
               lm_batches, (1,))

    for scheme in Simulator.SCHEMES:
        for (name, f_c, p_c, n, bs, rs), (_, f_g, p_g, _, _, _) in zip(
                setups("cpu"), setups("cuda")):
            runs = {}
            for dev, fns, params in (("cpu", f_c, p_c), ("cuda", f_g, p_g)):
                sim = Simulator(fns, params, n_stages=n, scheme=scheme,
                                lr=0.05, rmse_s=rs)
                ops.reset_launch_counts()
                runs[dev] = ([sim.step(b) for b in bs], sim.params,
                             ops.launch_counts())
            counts = runs["cuda"][2]
            layers = cfg.n_layers if name == "staged_from_model" else 0
            want = {"fused_update": (n + 1) * len(bs),
                    "flash_fwd": 2 * layers * len(bs),
                    "flash_bwd_dq": layers * len(bs),
                    "flash_bwd_dkv": layers * len(bs)}
            check({k: counts[k] for k in want} == want,
                  f"{scheme} {name}: launches {counts}, expected {want}")
            m_err = _sim_metrics_close(runs["cuda"][0], runs["cpu"][0],
                                       f"{scheme} {name}")
            p_err = _trees_close(torch, runs["cuda"][1], runs["cpu"][1],
                                 f"{scheme} {name}")
            print(f"  {scheme:<9} {name:<17} losses and RMSEs max rel |d| "
                  f"{m_err:.3e}, params max |d| {p_err:.3e} (rtol "
                  f"{SIM_TOL[0]:g} / atol {SIM_TOL[1]:g}); launches "
                  f"{want}")


def resume_check(torch) -> None:
    """Checkpoint and exact resume through the launcher on the card:
    6 ticks in one run against 3 ticks, a save, and a second run resumed
    to 6 (``--ckpt-dir``, ``--resume auto``); every leaf of the final
    checkpoint bit for bit, for spectrain and pipedream."""
    phase("checkpoint and exact resume on the card: train.main, smoke "
          "size, 4 layers, pipe 2, 6 ticks against 3 + resume + 3")
    import numpy as np
    from repro_torch.launch import train
    argv = ["--arch", ARCH, "--smoke", "--layers", "4", "--pipe", "2",
            "--batch", "4", "--seq", "16", "--save-every", "3",
            "--log-every", "100"]
    for mode in ("spectrain", "pipedream"):
        with tempfile.TemporaryDirectory() as d:
            one, two = f"{d}/one", f"{d}/two"
            check(train.main(argv + ["--mode", mode, "--steps", "6",
                                     "--ckpt-dir", one]) == 0, "run A")
            check(train.main(argv + ["--mode", mode, "--steps", "3",
                                     "--ckpt-dir", two]) == 0, "run B")
            ran = []
            check(train.main(argv + ["--mode", mode, "--steps", "6",
                                     "--ckpt-dir", two, "--resume", "auto"],
                             on_step=lambda s, st, m: ran.append(s)) == 0,
                  "run B resumed")
            check(ran == [3, 4, 5], f"the resumed run ran steps {ran}")
            last = "step_00000005/shard_0.npz"
            with np.load(f"{one}/{last}") as a, np.load(f"{two}/{last}") as b:
                check(set(a.files) == set(b.files), "leaf sets differ")
                same = [k for k in a.files if np.array_equal(a[k], b[k])]
                n_par = sum(k.startswith(("params/", "momentum/"))
                            for k in a.files)
                check(len(same) == len(a.files), f"{mode}: leaves differ "
                      f"after resume: {sorted(set(a.files) - set(same))}")
        print(f"  {mode}: all {len(a.files)} leaves of the step-5 "
              f"checkpoint bit-equal ({n_par} params and momentum leaves)")


def paper_eval(torch, ops, fu, *, lr=EVAL_LR, steps=EVAL_STEPS,
               rmse_steps=EVAL_RMSE_STEPS, profiled=EVAL_PROFILED) -> dict:
    """The four schemes on the full-width, full-depth snn-paper (32 FC
    layers of 2048, input 3072, 10 classes, 4 stages), batch 128 of the
    synthetic teacher task, ``steps`` steps each, every update through
    the fused update kernel (N + 1 launches a step); then spectrain
    again for its first ``rmse_steps`` steps with Fig. 8's RMSEs at
    s = 1, 2, 3 (the same trajectory).
    Each scheme's final weights are scored on a held-out teacher batch;
    every scheme must have learned past the label prior (a final loss
    below the prior's entropy, a held-out accuracy above the majority
    share, each by three standard errors).  The update kernel is held against
    its plain version at the simulator's two groups, then timed."""
    from repro_torch.bench import teacher_batches
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import Simulator, make_mlp_staged
    from repro_torch.kernels import ref
    from repro_torch.models.layers import tree_leaves
    import gc
    cfg = get_config(EVAL_ARCH)
    dims = dict(in_dim=cfg.vocab_size, width=cfg.d_model,
                depth=cfg.n_layers, n_classes=EVAL_CLASSES,
                n_stages=cfg.mesh_plan.pipe)
    N, B = dims["n_stages"], EVAL_BATCH
    phase(f"main path: the paper's evaluation, {EVAL_ARCH} full width and "
          f"depth ({dims}), batch {B}, lr {lr}, {steps} steps a scheme")
    fns, params = make_mlp_staged(torch.Generator("cuda").manual_seed(0),
                                  device="cuda", **dims)
    leaves = tree_leaves(params)
    P = sum(t.numel() for t in leaves)
    P_mat = sum(t.numel() for t in leaves if t.dim() == 2)
    check(len(leaves) == 68 and P == 140_597_258,
          f"snn-paper has {len(leaves)} leaves, {P} parameters")
    data = teacher_batches(in_dim=dims["in_dim"], n_classes=EVAL_CLASSES,
                           batch=B, seed=1, device="cuda")
    batches = [next(data) for _ in range(steps)]
    held = next(teacher_batches(in_dim=dims["in_dim"],
                                n_classes=EVAL_CLASSES, batch=EVAL_HELD,
                                seed=2, device="cuda"))
    # the label prior: its entropy is the loss of a model that learned
    # only the class shares; the majority share, its accuracy
    shares = torch.bincount(torch.cat([b["y"] for b in batches]),
                            minlength=EVAL_CLASSES).double()
    shares = shares[shares > 0] / shares.sum()
    prior_loss = float(-(shares * shares.log()).sum())
    majority = float(torch.bincount(held["y"]).max()) / EVAL_HELD
    acc_se = math.sqrt(majority * (1 - majority) / EVAL_HELD)

    def sub(tree):
        return sum(x.numel() for x in tree_leaves(tree))

    P_stage = [sub(t) for t in params["stages"]]
    P_in, P_out = sub(params["outer"]["in"]), sub(params["outer"]["out"])
    # fp32 operations one step needs: forward, weight gradients, input
    # gradients of every layer but the first
    flops = 2 * B * P_mat * 3 - 2 * B * dims["in_dim"] * dims["width"]
    out = {}
    # spectrain twice: the training step alone, then with Fig. 8's RMSEs
    # (three whole-tree predictions and six whole-tree reductions a step)
    runs = [(scheme, scheme, (), steps) for scheme in Simulator.SCHEMES]
    runs.append(("spectrain+rmse", "spectrain", (1, 2, 3), rmse_steps))
    for name, scheme, rmse_s, n_steps in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = Simulator(fns, params, n_stages=N, scheme=scheme, lr=lr,
                        rmse_s=rmse_s)
        ms, walls, per_step = [], [], []
        prof = None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for i, b in enumerate(batches[:n_steps]):
            if i == profiled[0]:
                prof = device_profile()
                prof.__enter__()
            before = fu.launches
            t = time.perf_counter()
            ms.append(sim.step(b))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            per_step.append(fu.launches - before)
            if i == profiled[1] - 1:
                prof.__exit__(None, None, None)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [m["loss"] for m in ms]
        check(all(math.isfinite(x) for x in losses),
              f"{name}: a loss is not finite")
        check(per_step == [N + 1] * n_steps,
              f"{name}: fused_update launches per step {set(per_step)}")
        check(counts == {k: (N + 1) * n_steps if k == "fused_update"
                         else 0 for k in counts},
              f"{name}: launches {counts}")
        n_prof = profiled[1] - profiled[0]
        steady = sorted(w for i, w in enumerate(walls)
                        if i >= 10 and not profiled[0] <= i < profiled[1])
        wall_ms = steady[len(steady) // 2] * 1e3
        kern = device_kernels(prof)
        check(bool(kern), f"{name}: the profiler saw no device activity")
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n_prof
        fu_ms = sum(e.self_device_time_total for e in kern
                    if "fused_update" in e.key) / 1e3 / n_prof
        # bytes the step must move (fp32): the update reads w, v, g and
        # writes w', v'; each prediction reads w, v and writes ŵ; each
        # RMSE at s predicts the whole tree and reads it, the stale and
        # the new tree twice over
        pred = 0
        if scheme == "spectrain":
            pred += sum(P_stage[k] for k in range(N) if sim.s_fwd[k] > 0)
            pred += sum(P_stage[k] for k in range(N) if sim.s_bwd[k] > 0)
            pred += P_in * ((sim.s_fwd[0] > 0) + (sim.s_bwd[0] > 0))
            pred += P_out * (sim.s_bwd[N - 1] > 0)
        nbytes = 4 * (5 * P + 3 * pred + 7 * P * len(rmse_s))
        bound_ms = max(nbytes / HBM_BPS, flops / PEAK_FLOPS["float32"]) * 1e3
        upd_kw = dict(lr=sim.lr, gamma=sim.gamma, s=0.0)
        rec = {"wall_ms": wall_ms, "busy_ms": busy_ms,
               "idle": 1 - busy_ms / wall_ms, "fused_update_ms": fu_ms,
               "peak_bytes": peak,
               "launches": counts["fused_update"], "per_step": N + 1,
               "bound_ms": bound_ms, "bytes": nbytes, "flops": flops,
               "first_loss": losses[0], "losses": losses}
        head = (f"  {name:<14} {wall_ms:8.3f} ms/step wall (median of "
                f"steady steps), {busy_ms:8.3f} ms busy "
                f"({100 * rec['idle']:.1f}% idle), fused_update "
                f"{fu_ms:.3f} ms; bound {bound_ms:.3f} ms "
                f"({nbytes / 1e9:.2f} GB, {flops / 1e9:.1f} GFLOP); ")
        tail = (f"; {N + 1} fused_update a step; peak "
                f"{peak / 2**30:.2f} GiB")
        if rmse_s:
            # the learning is the first run's: the same trajectory
            rec["rmse"] = {}
            for s_ in rmse_s:
                p_ = _mean([m[f"rmse_pred_s{s_}"] for m in ms[20:]])
                st_ = _mean([m[f"rmse_stale_s{s_}"] for m in ms[20:]])
                rec["rmse"][s_] = (p_, st_)
                check(p_ < st_, f"Fig. 8 at s={s_}: RMSE(pred) {p_} is not "
                      f"below RMSE(stale) {st_}")
            print(f"{head}{n_steps} steps, the first run's losses{tail}")
        else:
            check(_mean(losses[-20:]) < _mean(losses[:20]),
                  f"{name}: the last 20 losses average "
                  f"{_mean(losses[-20:])}, the first 20 "
                  f"{_mean(losses[:20])}")
            with torch.no_grad():
                p_ = sim.params
                h = fns.embed(p_["outer"]["in"], held)
                for sp in p_["stages"]:
                    h = fns.stage(sp, h)
                held_loss = float(fns.head_loss(p_["outer"]["out"], h,
                                                held))
                logits = (h @ p_["outer"]["out"]["w"]
                          + p_["outer"]["out"]["b"])
                acc = float((logits.argmax(-1) == held["y"])
                            .double().mean())
            last = losses[-40:]
            loss_se = math.sqrt(sum((x - _mean(last)) ** 2 for x in last)
                                / (len(last) - 1) / len(last))
            check(_mean(last) < prior_loss - 3 * loss_se,
                  f"{name}: final loss {_mean(last)} is not below the "
                  f"label prior's entropy {prior_loss} by 3 standard "
                  f"errors ({loss_se})")
            check(acc > majority + 3 * acc_se,
                  f"{name}: held-out accuracy {acc} is not above the "
                  f"majority share {majority} by 3 standard errors")
            rec.update(final_loss=_mean(last), final_loss_se=loss_se,
                       held_loss=held_loss, held_acc=acc)
            print(f"{head}loss {losses[0]:.4f} -> final {_mean(last):.4f} "
                  f"(± {loss_se:.4f}); held-out loss {held_loss:.4f}, "
                  f"accuracy {acc:.4f}{tail}")
        out[name] = rec
        for s_, (p_, st_) in rec.get("rmse", {}).items():
            print(f"    Fig. 8 s={s_}: RMSE(pred) {p_:.3e}  RMSE(stale) "
                  f"{st_:.3e}  stale/pred {st_ / p_:.3f}")
        kern.sort(key=lambda e: -e.self_device_time_total)
        for e in kern[:6]:
            print(f"    {e.self_device_time_total / 1e3 / n_prof:9.4f} ms a "
                  f"step {e.count // n_prof:5d}x  {e.key[:70]}")
        del sim
    f = {k: out[k]["final_loss"] for k in Simulator.SCHEMES}
    check(out["spectrain+rmse"]["losses"]
          == out["spectrain"]["losses"][:rmse_steps],
          "the RMSEs changed spectrain's trajectory")
    table1 = {"spectrain <= vanilla * 1.05":
              f["spectrain"] <= f["vanilla"] * 1.05,
              "spectrain <= pipedream * 1.05":
              f["spectrain"] <= f["pipedream"] * 1.05,
              "spectrain <= sync * 1.25 + 0.05":
              f["spectrain"] <= f["sync"] * 1.25 + 0.05}
    print(f"  Table 1 (final loss, mean of the last 40 steps): "
          f"{ {k: round(v, 4) for k, v in f.items()} }; the JAX test's "
          f"bounds (a finding here, not a check): {table1}")
    print(f"  label prior: loss {prior_loss:.4f} (entropy of the training "
          f"labels), held-out accuracy {majority:.4f} (majority share, "
          f"± {acc_se:.4f}); held-out accuracy "
          f"{ {k: round(out[k]['held_acc'], 4) for k in f} }")
    out["table1"] = table1
    out["prior"] = {"loss": prior_loss, "majority": majority}
    # the kernel at the simulator's two groups (one stage tree, the outer
    # tree), with its arguments (no ŵ, s 0): checked, then timed
    g = torch.Generator("cuda").manual_seed(3)
    mk = lambda w, scale: torch.randn(w.shape, generator=g,
                                      device="cuda") * scale
    out["fu_rows"] = []
    for label, tree in (
            (f"snn-paper stage ({dims['depth'] // N} layers of "
             f"{dims['width']})", params["stages"][0]),
            (f"snn-paper outer tree (in {dims['in_dim']}x{dims['width']}, "
             f"out {dims['width']}x{EVAL_CLASSES})", params["outer"])):
        ws = [t.clone() for t in tree_leaves(tree)]
        vs = [mk(w, 1e-2) for w in ws]
        gs = [mk(w, 1.0) for w in ws]
        n = sum(w.numel() for w in ws)
        err = fu_compare(torch, ops, ref, ws, vs, gs, None, label, upd_kw)
        ms_, _ = time_ms(torch, lambda: ops.fused_update(
            ws, vs, gs, **upd_kw), 10)
        plain_ms, _ = time_ms(torch, lambda: [
            ref.fused_update_ref(w, v, g_, **upd_kw)
            for w, v, g_ in zip(ws, vs, gs)], 3)
        # with no ŵ, torch.optim.SGD(fused=True, dampening=gamma)
        # computes the same update (but for its first step, which sets v
        # to g)
        opt_params = [torch.nn.Parameter(w) for w in ws]
        for p_, g_ in zip(opt_params, gs):
            p_.grad = g_
        opt = torch.optim.SGD(opt_params, lr=upd_kw["lr"],
                              momentum=upd_kw["gamma"],
                              dampening=upd_kw["gamma"], fused=True)
        lib_ms, _ = time_ms(torch, opt.step, 10)
        b_ms = 4 * 5 * n / HBM_BPS * 1e3
        row = {"shape": f"{label}: {len(ws)} tensors, {n} elements, fp32 "
                        f"w/v/g, no ŵ, lr {upd_kw['lr']:g}, gamma "
                        f"{upd_kw['gamma']:g}",
               "ms": ms_, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": "bytes", "library_ms": lib_ms,
               "max_abs_err": err}
        out["fu_rows"].append(row)
        print(f"  fused_update at {row['shape']}: one launch against its "
              f"plain version max |d| {err:.3e} (tol "
              f"{FU_TOL['float32']:g}); {ms_:.4f} ms, bound {b_ms:.4f} ms "
              f"(bytes), plain {plain_ms:.4f} ms, torch.optim.SGD(fused) "
              f"{lib_ms:.4f} ms")
        del ws, vs, gs, opt_params, opt
    del params, batches
    return out


def bench_scripts(torch) -> None:
    """The evaluation scripts' own runs on the card at their default
    (the JAX scripts') sizes."""
    phase("python -m repro_torch.bench.rmse / .convergence on the card, "
          "their default sizes")
    from repro_torch.bench import convergence, rmse
    for mod in (rmse, convergence):
        t0 = time.perf_counter()
        lines = mod.main(device="cuda")
        for line in lines:
            print(f"  {line}")
        check(not any(re.search(r"nan|inf", line) for line in lines),
              f"{mod.__name__}: a non-finite number")
        print(f"  ({mod.__name__}: {time.perf_counter() - t0:.1f} s)")


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {src}/repro_torch not found; run from the root "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import mamba2_scan as m2
    from repro_torch.kernels import rwkv6_scan as r6

    t_start = _T0[0] = time.perf_counter()
    try:
        info = card_info(torch)
        build_kernels(build, r6, m2, fa, fu)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        errs = kernel_checks(torch, fa, ref)
        paged_errs = paged_checks(torch, fa, ref)
        bwd_errs = bwd_checks(torch, fa, ref)
        fused_checks(torch, ops, ref)
        scan_errs = scan_checks(torch, ops, ref)
        ops.reset_launch_counts()
        model_check(torch)
        ssm_model_check(torch)
        pipelined_check(torch)
        train_check(torch)
        ir_check(torch)
        fma_only(ops)
        simulator_check(torch, ops)
        resume_check(torch)
        ssm = {}
        for arch in SSM_ARCHS:
            ssm[arch] = main_path(torch, ops, arch,
                                  get_config(arch).n_layers)
            ssm[arch]["profile"] = decode_profile(torch, arch)
        for arch in SSM_ARCHS:
            ssm[arch]["long_prompt"] = long_prompt(torch, ops, arch)
        main = main_path(torch, ops, ARCH, get_config(ARCH).n_layers)
        decode_profile(torch)
        pipelined = {}
        for arch in PIPE_ARCHS:
            pipelined[arch] = pipelined_path(torch, ops, arch)
            gc.collect()
            torch.cuda.empty_cache()
        train = train_main_path(torch, ops)
        ir_runs = ir_schedules(torch, ops, ref)
        evaluation = paper_eval(torch, ops, fu)
        bench_scripts(torch)
        rows = timings(torch, fa, ref, errs)
        rows.append(wave_timing(torch, fa, ref, paged_errs))
        train_rows = train_timings(torch, fa, ref, ops, bwd_errs)
        scan_rows = scan_timings(torch, ops, ref, scan_errs)
    except Exception:   # every phase's failure ends the run non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    top = rows[0]        # the decode step: the serving path's common call
    design = "mma.sync bf16, packed GQA rows, cp.async 2-stage"
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:39",
        "launches": main["launches"]["flash_fwd"],
        "launches_by_path": {
            "serve": main["launches"]["flash_fwd"],
            "serve zamba2-1.2b": ssm["zamba2-1.2b"]["launches"]["flash_fwd"],
            "serve pipelined granite-8b":
                pipelined["granite-8b"]["launches"]["flash_fwd"],
            "train": train["launches"]["flash_fwd"]},
        "variant_by_path": {
            "serve": f"flash_fwd_mma_kernel x "
                     f"{main['variants']['flash_fwd_mma']}",
            "serve zamba2-1.2b": f"flash_fwd_mma_kernel x "
                     f"{ssm['zamba2-1.2b']['variants']['flash_fwd_mma']}",
            "serve pipelined granite-8b": f"flash_fwd_mma_kernel x "
                     f"{pipelined['granite-8b']['variants']['flash_fwd_mma']}"
                     f" (paged rows in the wave)",
            "train": f"flash_fwd_mma_kernel x "
                     f"{train['variants_per_tick']['flash_fwd_mma']} a tick",
            "fp32 checks": "flash_fwd_kernel (FMA)"},
        "design": design,
        "max_abs_err": top["max_abs_err"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "shapes": rows,
    }]
    sources = {"flash_bwd_dq": ("flash_bwd.cu", "flash_attention.py:136"),
               "flash_bwd_dkv": ("flash_bwd.cu", "flash_attention.py:177"),
               "fused_update": ("fused_update.cu", "fused_update.py:22")}
    eval_launches = sum(evaluation[k]["launches"]
                        for k in ("sync", "vanilla", "pipedream",
                                  "spectrain", "spectrain+rmse"))
    for row in train_rows:
        if row["name"] == "fused_update":
            row["shapes"].extend(evaluation["fu_rows"])
        src_file, tpu = sources[row["name"]]
        kernels.append({
            "name": row["name"], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src_file}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": train["launches"][row["name"]],
            "launches_per_tick": train["per_tick"][row["name"]],
            **({"launches_by_path": {
                "train": train["launches"]["fused_update"],
                "paper evaluation (snn-paper, 4 schemes + spectrain with "
                "RMSEs)": eval_launches},
                "launches_per_simulator_step": evaluation["sync"][
                    "per_step"]} if row["name"] == "fused_update" else {}),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], **({"shapes": row["shapes"]}
                                      if "shapes" in row else {}),
            **({"variant_by_path": {
                "train": f"{row['name']}_mma_kernel x "
                         f"{train['variants_per_tick'][row['name'] + '_mma']}"
                         f" a tick",
                "fp32 checks": f"{row['name']}_kernel (FMA)"},
                "design": design} if row["name"].startswith("flash_bwd")
               else {})})
    # the IR rounds' launches (each run counted from 0 to its end)
    for k in kernels:
        if k["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "fused_update"):
            k.setdefault("launches_by_path", {
                "train": train["launches"][k["name"]]})
            k["launches_by_path"]["train IR rounds (all runs)"] = sum(
                r["launches"][k["name"]] for r in ir_runs.values())
            k["launches_per_ir_round"] = {
                label: r["per_round"][k["name"]]
                for label, r in ir_runs.items()}
    for kind, arch in (("rwkv6", "rwkv6-7b"), ("mamba2", "zamba2-1.2b")):
        name = f"{kind}_scan"
        top = scan_rows[kind][0]        # the decode step: the common call
        v_serve = ssm[arch]["variants"]
        v_long = ssm[arch]["long_prompt"]["variants"]
        launches = {
            "decode": v_serve[f"{name}_decode"],
            "step": ssm[arch]["launches"][name] - v_serve[f"{name}_decode"]
            - v_serve[f"{name}_chunk"],
            "chunk": v_long[f"{name}_chunk"]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}.py:"
                        f"{36 if kind == 'rwkv6' else 29}",
            "launches": ssm[arch]["launches"][name],
            **({"launches_by_path": {
                "serve": ssm[arch]["launches"][name],
                "serve pipelined rwkv6-7b":
                    pipelined["rwkv6-7b"]["launches"][name]}}
               if kind == "rwkv6" else {}),
            "launches_per_call": ssm[arch]["per_call"][name],
            "launches_long_prompt": ssm[arch]["long_prompt"]["launches"][name],
            "max_abs_err": max(v for (k, _), v in scan_errs.items()
                               if k == kind),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
            "library": "none: no single PyTorch call computes the "
                       "recurrence",
            "shape": top["shape"], "shapes": scan_rows[kind],
            "variants": [dict(row, launches=launches[row["variant"]],
                              launches_on=("long-prompt serving"
                                           if row["variant"] == "chunk"
                                           else "serving"))
                         for row in scan_rows[kind]]})
    for arch, rec in ssm.items():
        lp = rec["long_prompt"]
        print(f"{arch} long prompts: time to first token "
              f"{[round(t, 3) for _, t in lp['ttft_ms']]} ms at "
              f"{[n for n, _ in lp['ttft_ms']]} tokens; one "
              f"{lp['prefill_tokens']}-token prefill "
              f"{lp['prefill_wall_ms']:.3f} ms wall, "
              f"{lp['prefill_busy_ms']:.3f} ms busy, scans "
              f"{lp['prefill_scan_ms']:.3f} ms")
    for arch, rec in ssm.items():
        run, prof = rec["run"], rec["profile"]
        print(f"{arch} serving: {run['tok_per_s']:.2f} tok/s, p50 "
              f"{run['token_ms_p50']:.3f} ms/token, p99 "
              f"{run['token_ms_p99']:.3f}; decode step {prof['wall_ms']:.3f} "
              f"ms wall, {prof['busy_ms']:.3f} ms busy, "
              f"{100 * prof['idle_share']:.1f}% idle, "
              f"{prof['kernels_per_step']:.0f} kernels; peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB")
    for arch, rec in pipelined.items():
        run = rec["run"]
        wv = rec["wave_vs_steps"]["logits"]
        print(f"{arch} pipelined serving (pipe 4, 8 slots, 24 requests): "
              f"{rec['run_tok_per_s']:.2f} tok/s against SimpleEngine's "
              f"{rec['simple_tok_per_s']:.2f}, both over run()'s wall "
              f"after warm-up "
              f"({rec['run_tok_per_s'] / rec['simple_tok_per_s']:.2f}x; "
              f"{rec['tok_per_s']:.2f} tok/s inside the rounds); p50 "
              f"{run['token_ms_p50']:.3f} / {rec['simple_p50']:.3f} ms/token, "
              f"p99 {run['token_ms_p99']:.3f} / {rec['simple_p99']:.3f}; "
              f"{rec['rounds']} rounds; steady round "
              f"{rec['round_wall_ms']:.3f} ms wall, "
              f"{rec['round_busy_ms']:.3f} ms busy "
              f"({100 * (1 - rec['round_busy_ms'] / rec['round_wall_ms']):.1f}"
              f"% idle), {rec['round_kernels']:.0f} kernels; "
              f"{rec['traffic_ms']}; peak {rec['peak_bytes'] / 2**30:.2f} "
              f"GiB; first tokens equal {rec['first_equal']}, whole "
              f"{rec['whole_equal']}; one wave's logits vs the steps "
              f"{wv['wave_step']:.3e}, the steps vs fp32 "
              f"{wv['step_fp32']:.3e}")
    print(f"\nchip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f}s on {info['smi']}")
    for scheme in ("sync", "vanilla", "pipedream", "spectrain",
                   "spectrain+rmse"):
        rec = evaluation[scheme]
        rmse = "".join(f"; s={k} stale/pred {st / pr:.3f}"
                       for k, (pr, st) in rec.get("rmse", {}).items())
        learned = (f"; final loss {rec['final_loss']:.4f}, held-out "
                   f"accuracy {rec['held_acc']:.4f}" if "held_acc" in rec
                   else f"; {len(rec['losses'])} steps")
        print(f"snn-paper {scheme}: {rec['wall_ms']:.3f} ms/step wall, "
              f"{rec['busy_ms']:.3f} ms busy ({100 * rec['idle']:.1f}% "
              f"idle), bound {rec['bound_ms']:.3f} ms{learned}; peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB{rmse}")
    print(f"snn-paper label prior: loss {evaluation['prior']['loss']:.4f}, "
          f"majority share {evaluation['prior']['majority']:.4f}; Table 1 "
          f"bounds: {evaluation['table1']}")
    for label, r in ir_runs.items():
        stash = (f", stash copy {r['stash_ms']:.3f} ms"
                 if r["stash_ms"] is not None else "")
        print(f"IR round {label} ({r['layers']} layers, {r['chunks']} "
              f"chunks, {r['round']} microbatches): "
              f"{r['wall_ms']:.3f} ms wall, {r['busy_ms']:.3f} ms busy "
              f"({100 * (1 - r['busy_ms'] / r['wall_ms']):.1f}% idle), "
              f"{r['tok_per_s']:.1f} tokens/s, fused_update "
              f"{r['kernel_ms']['fused_update']:.3f} ms in "
              f"{r['per_round']['fused_update']} launches, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB{stash}")
    print(f"training tick: {train['wall_ms']:.3f} ms wall, "
          f"{train['tok_per_s']:.1f} tokens/s, device busy "
          f"{train['busy_ms']:.3f} ms, peak {train['peak_bytes'] / 2**30:.2f} "
          f"GiB")
    print(info["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
