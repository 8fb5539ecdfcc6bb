"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Mirrors ``repro``'s subpackages (``configs``, ``core``, ``data``,
``kernels``, ``models``, ``optim``, ``serve``, ``planner``, ``obs``,
``launch``) so every module has an obvious twin there.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Entry
points run on ``cuda`` unless the caller asks for ``device="cpu"``;
asking for ``cuda`` where no card is present raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` (the default) or
    ``cpu``; or ``meta``, which carries shapes and no data, for the
    dry-run's cost accounting (``launch/dryrun.py``).  Raises if
    ``cuda`` is asked for and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"the port runs on cuda or cpu (meta: shapes "
                         f"only), not {dev}")
    return dev
