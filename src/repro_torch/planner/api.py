"""Serving plan (twin of ``ServePlan`` / ``serve_plan`` in
``repro/planner/api.py``).

The round geometry both engines read, and the serving round's compiled
artifacts (``planner/schedule_ir``) with their static verifier
(``planner/verify``).  The profile-guided (``dp``) partitioner comes
with the planner slice; the port plans the uniform split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.models.model import uniform_stage_sizes
from repro_torch.planner import schedule_ir as ir


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

    @property
    def n_chunks(self) -> int:
        return self.n_stages

    @property
    def n_devices(self) -> int:
        return self.n_stages

    def serve_events(self):
        """The round's staircase events ``(kind, lane, chunk, t)``."""
        return ir.serve_round_events(self.n_chunks, self.max_prefill)

    def serve_table(self) -> ir.ServeTable:
        """Dense int32 lowering of one serving round: what
        ``ServeEngine`` interprets row by row."""
        return ir.compile_serve_table(self.serve_events(), self.n_chunks,
                                      self.max_prefill)

    def serve_streams(self) -> ir.ServeStreams:
        """Per-device tick streams of one serving round (the JAX
        package's MPMD backend runs them; compiled and verified here)."""
        return ir.compile_serve_streams(
            self.serve_events(), self.n_chunks, self.max_prefill,
            self.n_devices)

    def verify(self, *, device_streams: bool = True) -> None:
        """Statically verify the serving round's compiled artifacts
        (``planner/verify.py``).  Raises
        :class:`~repro_torch.planner.verify.VerificationError`."""
        from repro_torch.planner import verify as pv
        pv.check_serve_plan(self, device_streams=device_streams)

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
               partitioner: str = "uniform",
               validate: bool = True) -> ServePlan:
    """Build a :class:`ServePlan` with the JAX twin's validation.

    ``config`` is an ``ArchConfig`` or None with bare ``n_layers``.
    ``n_pages`` defaults to ``n_slots``; ``page_seq`` must cover
    ``prompt_budget``.  With ``validate`` the round's compiled artifacts
    are verified (:meth:`ServePlan.verify`), as the JAX twin does."""
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
    splan = ServePlan(
        n_stages=n_stages,
        stage_sizes=uniform_stage_sizes(n_layers, n_stages),
        n_slots=n_slots, max_prefill=max_prefill,
        prompt_budget=prompt_budget, n_pages=n_pages, page_seq=page_seq,
        partitioner=partitioner)
    if validate:
        splan.verify()
    return splan
