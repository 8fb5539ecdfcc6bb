"""Serving plan (twin of ``ServePlan`` / ``serve_plan`` in
``repro/planner/api.py``).

Only the geometry that the whole-model ``SimpleEngine`` and the serve
launcher's summary line read.  The serve table, device streams and the
static verifier come with the pipelined engine in a later slice, as does
the profile-guided (``dp``) partitioner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.models.model import uniform_stage_sizes


@dataclass(frozen=True)
class ServePlan:
    """One serving layout: the stage split plus the round geometry —
    live decode slots (``n_slots``), prompts admitted per round
    (``max_prefill``), the per-lane prompt budget (``prompt_budget``)
    and the KV paging (``n_pages`` pages of ``page_seq`` positions; a
    request's prompt + generation is capped at ``page_seq``)."""
    n_stages: int
    stage_sizes: Tuple[int, ...]
    n_slots: int
    max_prefill: int
    prompt_budget: int
    n_pages: int
    page_seq: int
    partitioner: str = "uniform"

    def summary(self) -> str:
        return (f"serve_plan[x{self.n_stages} "
                f"part={self.partitioner}:{self.stage_sizes} "
                f"slots={self.n_slots} prefill={self.max_prefill} "
                f"P={self.prompt_budget} pages={self.n_pages}"
                f"x{self.page_seq}]")


def serve_plan(config=None, n_stages: int = 2, *, n_slots: int = 4,
               max_prefill: int = 1, prompt_budget: int = 16,
               n_pages: Optional[int] = None, page_seq: int = 64,
               n_layers: Optional[int] = None,
               partitioner: str = "uniform") -> ServePlan:
    """Build a :class:`ServePlan` with the JAX twin's validation.

    ``config`` is an ``ArchConfig`` or None with bare ``n_layers``.
    ``n_pages`` defaults to ``n_slots``; ``page_seq`` must cover
    ``prompt_budget``."""
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    if max_prefill < 0:
        raise ValueError(f"max_prefill must be >= 0, got {max_prefill}")
    if prompt_budget < 1:
        raise ValueError(f"prompt_budget must be >= 1, got {prompt_budget}")
    if page_seq < prompt_budget:
        raise ValueError(f"page_seq={page_seq} cannot hold a "
                         f"prompt_budget={prompt_budget} prompt")
    if n_pages is None:
        n_pages = n_slots
    if n_pages < n_slots:
        raise ValueError(f"n_pages={n_pages} < n_slots={n_slots}: a live "
                         f"request needs a page on every stage")
    if partitioner != "uniform":
        raise NotImplementedError(
            f"partitioner {partitioner!r} is not ported yet (it needs the "
            f"profiler); the port plans the uniform split")
    if n_layers is None:
        n_layers = config.n_layers if config is not None else n_stages
    if n_layers < n_stages:
        raise ValueError(f"{n_layers} layers cannot fill "
                         f"{n_stages} stages")
    return ServePlan(
        n_stages=n_stages,
        stage_sizes=uniform_stage_sizes(n_layers, n_stages),
        n_slots=n_slots, max_prefill=max_prefill,
        prompt_budget=prompt_budget, n_pages=n_pages, page_seq=page_seq,
        partitioner=partitioner)
