"""Serving for the port.

  ``trace``      seeded Poisson arrival traces (:func:`poisson_trace`)
                 and the :class:`Request` record.
  ``scheduler``  :class:`ContinuousBatcher` (admission and eviction over
                 request slots and KV pages) and :func:`admissible`, the
                 static budget check.
  ``engine``     :class:`ServeEngine`: the pipelined engine, serving
                 rounds of the schedule IR over paged KV; and
                 :class:`SimpleEngine`: whole-model greedy serving, one
                 request at a time, prefill in one causal call.
"""
from repro_torch.serve.engine import (ServeEngine, SimpleEngine,
                                      chunk_page_caches)
from repro_torch.serve.scheduler import ContinuousBatcher, admissible
from repro_torch.serve.trace import Request, poisson_trace

__all__ = ["ServeEngine", "SimpleEngine", "chunk_page_caches",
           "ContinuousBatcher", "admissible", "Request", "poisson_trace"]
