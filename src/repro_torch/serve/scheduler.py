"""Request admission (twin of ``repro/serve/scheduler.py``).

Only :func:`admissible`, the static budget check that ``SimpleEngine``
applies.  The continuous batcher comes with the pipelined engine in a
later slice of the port.
"""
from __future__ import annotations

from repro_torch.serve.trace import Request


def admissible(req: Request, splan) -> bool:
    """Whether a request fits the plan's static budgets: a non-empty
    prompt within ``prompt_budget``, at least one generated token, and
    prompt + generation within one ``page_seq`` KV page."""
    p = len(req.prompt)
    return (1 <= p <= splan.prompt_budget and req.gen_len >= 1
            and p + req.gen_len <= splan.page_seq)
