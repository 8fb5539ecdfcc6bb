#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds and serves on the card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with one NVIDIA card
(an H100 is what the numbers are for).  It imports nothing of JAX or of
the JAX package, and in phases:

  1. prints the card (nvidia-smi's name and power limit, torch's name
     and device count);
  2. builds every CUDA kernel of the port from ``src/repro_torch/kernels/
     csrc`` (one nvcc per source, all at once), with ptxas's registers
     and shared memory;
  3. holds the flash forward kernel against its plain PyTorch version on
     the card: the serving path's decode and prefill shapes, the
     repository's kernel test cases and a long causal case (2e-5 in
     fp32, 2e-2 in bf16, TF32 off for the plain version);
  4. holds the port's model on the card against the same model on the
     CPU (plain attention) at the smoke size in fp32;
  5. drives the main path, ``repro_torch.launch.serve.main``, on the
     full-width, full-depth granite-8b in bf16 with random weights, and
     checks every admissible request got its tokens, the logits were
     finite and the kernel ran 36 times per prefill and decode call;
  6. profiles a few full-width decode steps (wall per step, device
     busy share, device time per kernel);
  7. times the kernel on the card beside its bound, its plain version
     and ``torch.nn.functional.scaled_dot_product_attention`` (the
     library yardstick; the port never calls it).

It prints the kernels' JSON line before its last line, which is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line, as does a machine without a card or a directory without the
repository's ``src/``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "granite-8b"
TIMEOUT_S = 60

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# fp32 FLOP/s outside the tensor cores (the kernel's fp32 path)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# tests/test_kernels.py's FLASH_CASES: b, H, KV, sq, sk, d, causal, dtype
FLASH_CASES = [
    (2, 4, 4, 256, 256, 64, True, "float32"),
    (1, 8, 2, 256, 256, 128, True, "float32"),
    (2, 4, 1, 128, 256, 64, False, "float32"),
    (1, 4, 4, 128, 128, 64, True, "bfloat16"),
    (1, 2, 2, 512, 512, 32, True, "float32"),
]


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


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
    o, lse = fa.flash_fwd(q, k, v, **case.kw())
    torch.cuda.synchronize()
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


def build_kernels(build, fa) -> None:
    phase("build")
    t0 = time.perf_counter()
    built = build.build_all()
    fa.load()
    print(f"built {sorted(built) or 'nothing (libraries present)'} in "
          f"{time.perf_counter() - t0:.2f}s")
    for name, info in sorted(built.items()):
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")


def kernel_checks(torch, fa, ref) -> dict:
    phase("flash_fwd against its plain version on the card")
    cfg = (32, 8, 128)       # granite-8b heads, KV heads, head_dim
    cases = []
    for kv_len in (1, 37, 64):
        cases.append(Case(f"decode kv_len={kv_len}", 1, 1, 64, *cfg,
                          "bfloat16", False, kv_len - 1, kv_len))
    for n in (2, 12):
        cases.append(Case(f"prefill n={n}", 1, n, n, *cfg, "bfloat16",
                          True))
    for b, H, KV, sq, sk, d, causal, dt in FLASH_CASES:
        cases.append(Case(f"test_kernels b{b} H{H}/{KV} {sq}x{sk} d{d} "
                          f"{'causal' if causal else 'full'} {dt}",
                          b, sq, sk, H, KV, d, dt, causal))
    cases.append(Case("causal 2048", 1, 2048, 2048, *cfg, "bfloat16",
                      True))
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
    move = lambda t: {k: move(v) if isinstance(v, dict) else v.cuda()
                      for k, v in t.items()}
    p_gpu = {"outer": move(p_cpu["outer"]),
             "stages": tuple(move(s) for s in p_cpu["stages"])}
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


def main_path(torch, ops, n_layers: int) -> dict:
    phase(f"main path: repro_torch.launch.serve.main, full {ARCH}, bf16")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.planner import serve_plan
    from repro_torch.serve import admissible, poisson_trace
    cfg = get_config(ARCH)
    check(cfg.n_layers == n_layers, "unexpected depth")
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
        argv = ["--arch", ARCH, "--requests", str(args["requests"]),
                "--rate", str(args["rate"]), "--prompt-lens", "2,12",
                "--gen-lens", "1,8", "--prompt-budget", "16",
                "--page-seq", "64", "--seed", "0",
                "--metrics-out", str(out)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rc = serve.main(argv)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["flash_fwd"]
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
    print(f"  flash_fwd launches {launches} = {n_layers} x "
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
    check(launches == n_layers * (want_prefill + want_decode),
          f"flash_fwd ran {launches} times, expected "
          f"{n_layers * (want_prefill + want_decode)}")
    check(all(math.isfinite(run[k]) for k in
              ("tok_per_s", "token_ms_p50", "token_ms_p99")),
          "non-finite serving metrics")
    return {"launches": launches, "run": run, "peak_bytes": peak}


def decode_profile(torch) -> dict:
    """Where a full-width decode step spends its time: wall per step
    without the profiler, then device time per kernel under it."""
    phase(f"a full-width {ARCH} decode step under torch.profiler")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        dtype=cfg.compute_dtype)
    steps = 8
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for pos in range(9 + steps, 9 + 2 * steps):
                step(pos)
            torch.cuda.synchronize()
    del params, cache
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    print(f"  wall per decode step (no profiler): {wall_ms:.3f} ms")
    if not kern:
        print("  device time per kernel: not measured (the profiler saw "
              "no device activity)")
        return {"wall_ms": wall_ms, "busy_ms": None}
    print(f"  device busy per step: {busy_ms:.3f} ms, "
          f"{100 * busy_ms / wall_ms:.1f}% of the wall "
          f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%)")
    kern.sort(key=lambda e: -e.self_device_time_total)
    for e in kern[:8]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.4f} ms "
              f"{e.count / steps:6.1f}x  {e.key[:72]}")
    flash = sum(e.self_device_time_total for e in kern
                if "flash_fwd" in e.key) / 1e3 / steps
    print(f"  flash_fwd: {flash:.4f} ms per step "
          f"({100 * flash / busy_ms:.1f}% of device busy)")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "flash_ms": flash}


def timings(torch, fa, ref, errs) -> list:
    phase("timings (CUDA events, after warm-up)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (32, 8, 128)
    cases = [(Case("decode kv_len=64", 1, 1, 64, *cfg, "bfloat16", False,
                   63, 64), 500),
             (Case("prefill n=12", 1, 12, 12, *cfg, "bfloat16", True), 500),
             (Case("causal 2048", 1, 2048, 2048, *cfg, "bfloat16", True),
              20)]
    rows = []
    for case, iters in cases:
        q, k, v = case.tensors(torch, seed=7)
        kw = case.kw()
        ms, wall = time_ms(torch, lambda: fa.flash_fwd(q, k, v, **kw),
                           iters)
        plain_ms, _ = time_ms(
            torch, lambda: ref.flash_fwd_ref(q, k, v, **kw), iters)
        lib_ms, _ = time_ms(torch, sdpa_fn(torch, case, q, k, v), iters)
        bound_ms, bound_by = case.bound()
        row = {"shape": case.name, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms, "max_abs_err": errs[case.name],
               "wall_ms_per_call": wall}
        rows.append(row)
        print(f"  {case.name:<18} kernel {ms:.4f} ms (wall {wall:.4f} ms "
              f"per call)  bound {bound_ms:.5f} ms ({bound_by})  plain "
              f"{plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms")
    return rows


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

    t_start = time.perf_counter()
    try:
        info = card_info(torch)
        build_kernels(build, fa)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        errs = kernel_checks(torch, fa, ref)
        model_check(torch)
        n_layers = get_config(ARCH).n_layers
        main = main_path(torch, ops, n_layers)
        decode_profile(torch)
        rows = timings(torch, fa, ref, errs)
    except Exception:   # every phase's failure ends the run non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    top = rows[0]        # the decode step: the main path's common call
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": main["launches"], "max_abs_err": top["max_abs_err"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "shapes": rows,
    }]
    print(f"\nchip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f}s on {info['smi']}")
    print(info["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
