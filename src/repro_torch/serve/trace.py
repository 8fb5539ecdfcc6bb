"""Seeded request traces for serving benchmarks and tests.

The port's own copy of ``repro/serve/trace.py``: numpy's
``default_rng`` draws the same trace from the same seed in both
packages.

Arrivals are Poisson in *round* units: inter-arrival gaps are drawn
from an exponential with mean ``1/rate`` and accumulated, so the same
``(n_requests, rate, seed)`` triple always produces the same trace —
the determinism tests and the CI serve-smoke job depend on that.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    """One inference request: ``prompt`` token ids arrive at round
    ``arrival``; the engine emits exactly ``gen_len`` tokens (greedy),
    the first from the prefill itself."""
    rid: int
    arrival: int
    prompt: Tuple[int, ...]
    gen_len: int


def poisson_trace(n_requests: int = 32, *, rate: float = 1.0,
                  seed: int = 0, prompt_lens: Tuple[int, int] = (2, 12),
                  gen_lens: Tuple[int, int] = (1, 8),
                  vocab: int = 256) -> List[Request]:
    """A seeded Poisson arrival trace with mixed prompt/gen lengths.

    ``rate`` is requests per round; ``prompt_lens`` / ``gen_lens`` are
    inclusive ranges.  Token ids are uniform over ``[0, vocab)``."""
    if n_requests < 1:
        raise ValueError(f"need n_requests >= 1, got {n_requests}")
    if rate <= 0:
        raise ValueError(f"need rate > 0, got {rate}")
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    t = 0.0
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        g = int(rng.integers(gen_lens[0], gen_lens[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(0, vocab, p))
        out.append(Request(rid=rid, arrival=int(t), prompt=prompt,
                           gen_len=g))
    return out
