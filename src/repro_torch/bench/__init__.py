"""The paper's evaluation on the port (twins of the JAX package's
``benchmarks/rmse.py``, ``benchmarks/convergence.py`` and
``examples/spectrain_ablation.py``), each run as
``python -m repro_torch.bench.<name>``: on the card unless given
``--device cpu``, printing lines in the JAX scripts' format.

The data is the JAX scripts' synthetic teacher task, x ~ N(0, 1) and
y = argmax(x · W_true) (:func:`teacher_batches`), drawn from explicit
generators: the same task, not the same numbers as the JAX PRNG's.
"""
from __future__ import annotations

import argparse
from typing import Dict, Iterator

import torch

from repro_torch import resolve_device


def teacher_batches(*, in_dim: int, n_classes: int, batch: int, seed: int,
                    device="cuda", w_seed: int = 99
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless batches {"x": [batch, in_dim] fp32, "y": [batch] int64}:
    x ~ N(0, 1) from a generator seeded ``seed``, y = argmax(x · W_true)
    with W_true ~ N(0, 1) [in_dim, n_classes] from one seeded ``w_seed``
    (the JAX scripts' PRNGKey(99)), both generators on ``device``."""
    dev = resolve_device(device)
    w_true = torch.randn((in_dim, n_classes), device=dev,
                         generator=torch.Generator(dev).manual_seed(w_seed))
    gen = torch.Generator(dev).manual_seed(seed)
    while True:
        x = torch.randn((batch, in_dim), generator=gen, device=dev)
        yield {"x": x, "y": (x @ w_true).argmax(-1)}


def cli(description: str) -> argparse.Namespace:
    """The scripts' shared command line: ``--device`` and ``--full``
    (the JAX scripts' ``fast=False`` step counts)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true",
                    help="the long runs (the JAX scripts' fast=False)")
    return ap.parse_args()
