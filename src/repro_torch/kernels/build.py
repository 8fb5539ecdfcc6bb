"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own into ``build/kernels/<name>-<hash>.so`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \\
        csrc/<name>.cu

The hash covers the sources under ``csrc/`` and the flags, so an edit
rebuilds and an unchanged tree reuses the library.  Nothing builds when
this module is imported: :func:`library` builds at first use, and
:func:`build_all` starts one ``nvcc`` per source at once.  A failed
build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): "
        "the CUDA kernels are built on the machine with the card")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Dict]:
    """Compile every named source (default: all of ``csrc/``) whose
    library is missing, one ``nvcc`` process each, all started together.
    Returns ``{name: {"seconds": build time, "log": nvcc's output with
    the ptxas -v lines}}`` for the names built now; raises if any build
    fails, with its compiler output."""
    names = list(sources() if names is None else names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    t0 = time.perf_counter()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failed = []
    built = {}
    for n, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (exit {proc.returncode})\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)     # atomic: concurrent builders agree
        built[n] = {"seconds": time.perf_counter() - t0,
                    "log": stdout + stderr}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib
