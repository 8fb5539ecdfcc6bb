"""Where the chunked scan backward spends its time, phase by phase (card
only).

There is no ``ncu`` on the card's machine, so this measures inside the
kernels: it copies ``csrc/rwkv6_scan_bwd.cu`` and ``csrc/mamba2_scan_bwd.cu``
under ``build/scan_bwd_phases/``, adds after every ``__syncthreads()`` of
the walk and gradient kernels a mark where thread 0 adds the cycles since
its last mark (``clock64``) to a counter of that phase, builds the copies
with the port's nvcc flags, runs each backward once at the training
tick's shape (b 8, s 512, 64 heads of 64, bf16) and at b 1, and prints the
cycles a block by phase, each phase named by the source comment above its
barrier.  Thread 0's cycles between two barriers are the phase's length
for the whole block (every warp waits at the barrier).  The marks cost a
few cycles each; the shipped kernels carry none.

    python -m repro_torch.bench.scan_bwd_phases [--batch 8 1]
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import rwkv6_scan as r6

KERNELS = {
    "rwkv6_scan_bwd": ("wkv_bwd_chunk_kernel", "wkv_bwd_states_kernel"),
    "mamba2_scan_bwd": ("ssd_bwd_chunk_kernel", "ssd_bwd_states_kernel")}
SLOTS = 40          # phases a kernel


def _body(text: str, name: str) -> Tuple[int, int]:
    """The span of kernel ``name``'s body, its braces included."""
    start = re.search(rf"\b{name}\(Params p\)", text).start()
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return i, j
    raise ValueError(f"{name}: unbalanced braces")


def instrument(text: str, names) -> Tuple[str, Dict[Tuple[str, int], str]]:
    """The source with a mark after each barrier of the named kernels and
    a ``repro_phase_read`` entry point; the phases' labels."""
    labels = {}
    for slot, name in enumerate(names):
        i, j = _body(text, name)
        out, n = [], 0
        for line in text[i + 1:j].split("\n"):
            out.append(line)
            code = line.split("//")[0]
            if "__syncthreads();" in code:
                notes = [x.strip() for x in out[-60:-1]
                         if x.strip().startswith("//")]
                labels[(name, n)] = (notes[-1] if notes else code.strip())
                out.append(f"    if (threadIdx.x == 0) {{ long long _n = "
                           f"clock64(); _acc[{n}] += _n - _last; _last = "
                           f"_n; }}")
                n += 1
        labels[(name, n)] = "(to the end)"
        pre = (f"\n    long long _last = clock64(); "
               f"long long _acc[{SLOTS}] = {{0}};")
        post = (f"\n    if (threadIdx.x == 0) {{ _acc[{n}] += clock64() - "
                f"_last; for (int _i = 0; _i <= {n}; ++_i) atomicAdd("
                f"&g_phase[{slot * SLOTS} + _i], (unsigned long long)"
                f"_acc[_i]); }}\n")
        text = text[:i + 1] + pre + "\n".join(out) + post + text[j:]
    text = text.replace(
        "namespace {", f"__device__ unsigned long long g_phase[2 * {SLOTS}];"
        "\nnamespace {", 1)
    text += ('\nextern "C" int repro_phase_read(unsigned long long* out) {\n'
             f'    static unsigned long long zero[2 * {SLOTS}];\n'
             '    int e = cudaMemcpyFromSymbol(out, g_phase,\n'
             '                                 sizeof(g_phase));\n'
             '    cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));\n'
             '    return e;\n}\n')
    return text, labels


def build_copies(out_dir: Path) -> Tuple[Dict[str, ctypes.CDLL], Dict]:
    """Instrumented copies of both sources, built at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, labels = {}, {}
    for src, names in KERNELS.items():
        text, labels[src] = instrument((build.CSRC / f"{src}.cu").read_text(),
                                       names)
        text = text.replace('#include "scan_mma.cuh"',
                            f'#include "{build.CSRC}/scan_mma.cuh"')
        path = out_dir / f"{src}.cu"
        path.write_text(text)
        so = out_dir / f"{src}.so"
        procs[src] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the copy of {src}:\n{log}")
        libs[src] = ctypes.CDLL(str(so))
    return libs, labels


def _inputs(kind: str, b: int, s: int = 512, h: int = 64, d: int = 64):
    gen = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda *sh, sc=1.0, dt=torch.float32: (torch.randn(
        *sh, generator=gen, device="cuda") * sc).to(dt)
    bf = torch.bfloat16
    if kind == "rwkv6_scan_bwd":
        return (mk(b, s, h, d, dt=bf), mk(b, s, h, d, sc=0.3, dt=bf),
                mk(b, s, h, d, dt=bf),
                torch.rand(b, s, h, d, generator=gen, device="cuda"),
                mk(h, d, sc=0.3), mk(b, h, d, d, sc=0.3),
                mk(b, s, h, d, dt=bf), mk(b, h, d, d, sc=0.3))
    bc = mk(b, s, 2 * d, sc=0.5, dt=bf)
    B, C = (t.reshape(b, s, 1, d) for t in bc.chunk(2, -1))
    return (mk(b, s, h, d, dt=bf), torch.nn.functional.softplus(mk(b, s, h)),
            torch.rand(b, s, h, generator=gen, device="cuda"), B, C,
            mk(b, h, d, d, sc=0.3), mk(b, s, h, d), mk(b, h, d, d, sc=0.3))


def profile(libs, labels, b: int) -> List[dict]:
    """One call of each backward at [b, 512, 64, 64] bf16 through the
    wrappers' launch path on the instrumented copies: per kernel, the
    cycles a block by phase (thread 0's, summed over blocks / blocks)."""
    rows = []
    for src, mod in (("rwkv6_scan_bwd", r6), ("mamba2_scan_bwd", m2)):
        lib = libs[src]
        fn = getattr(lib, f"repro_{src}")
        fn.argtypes = mod._BWD_ARGTYPES
        fn.restype = ctypes.c_int
        read = lib.repro_phase_read
        read.argtypes = [ctypes.c_void_p]
        buf = (ctypes.c_ulonglong * (2 * SLOTS))()
        args = _inputs(src, b)
        orig = build.library
        build.library = lambda name, lib=lib: lib
        try:
            mod._launch_bwd(*args)              # warm-up, then read anew
            torch.cuda.synchronize()
            read(buf)
            mod._launch_bwd(*args)
            torch.cuda.synchronize()
            read(buf)
        finally:
            build.library = orig
        for slot, name in enumerate(KERNELS[src]):
            blocks = (-(-512 // 64) if "chunk" in name else 2) * 64 * b
            phases = [(labels[src][(name, i)], buf[slot * SLOTS + i] / blocks)
                      for i in range(SLOTS) if (name, i) in labels[src]]
            rows.append({"kernel": name, "batch": b, "blocks": blocks,
                         "cycles": sum(c for _, c in phases),
                         "phases": phases})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_bwd_phases measures on the card: no CUDA "
                         "device here")
    out = Path(build.BUILD_DIR).parent / "scan_bwd_phases"
    libs, labels = build_copies(out)
    print(f"# {torch.cuda.get_device_name(0)}; cycles a block by phase "
          f"(thread 0's clock64 between barriers)")
    for b in args.batch:
        for row in profile(libs, labels, b):
            print(f"{row['kernel']} [{b}, 512, 64, 64] bf16: "
                  f"{row['cycles']:.0f} cycles a block, {row['blocks']} "
                  f"blocks")
            for i, (label, c) in enumerate(row["phases"]):
                print(f"  [{i:2d}] {c:9.0f} {100 * c / row['cycles']:5.1f}%  "
                      f"{label[:70]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
