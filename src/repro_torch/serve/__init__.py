"""Serving for the port.

  ``trace``      seeded Poisson arrival traces (:func:`poisson_trace`)
                 and the :class:`Request` record.
  ``scheduler``  :func:`admissible`, the static budget check.
  ``engine``     :class:`SimpleEngine`: whole-model greedy serving, one
                 request at a time, prefill in one causal call.

The pipelined ``ServeEngine`` with its schedule IR and continuous
batcher is a later slice of the port.
"""
from repro_torch.serve.engine import SimpleEngine
from repro_torch.serve.scheduler import admissible
from repro_torch.serve.trace import Request, poisson_trace

__all__ = ["SimpleEngine", "admissible", "Request", "poisson_trace"]
