"""Continuous-batching scheduler: request admission and eviction over
request slots and per-stage KV pages (twin of
``repro/serve/scheduler.py``, copied: it is pure host-side numpy).

Its decisions depend only on the arrival trace and the tokens the rounds
emit, never on device timing, so the same trace and the same emitted
tokens give the same admissions on every device.  Every decision is
appended to ``events``, the log ``planner.verify.verify_request_trace``
checks against the serving invariants (page lifetime == request
lifetime, one decode per live request per round, no slot sharing).

KV pages are allocated as one index per request, valid on *every*
stage: stage ``q`` holds a page buffer for its own layer slice, and a
request's state lives at the same page index in all of them, which is
what makes an elastic repartition a concat-and-resplit along the layer
axis.  :func:`admissible` is the static budget check both engines apply.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serve.trace import Request


def admissible(req: Request, splan) -> bool:
    """Whether a request fits the plan's static budgets: a non-empty
    prompt within ``prompt_budget``, at least one generated token, and
    prompt + generation within one ``page_seq`` KV page."""
    p = len(req.prompt)
    return (1 <= p <= splan.prompt_budget and req.gen_len >= 1
            and p + req.gen_len <= splan.page_seq)


class ContinuousBatcher:
    """FIFO continuous batching over ``n_slots`` request slots.

    Per round ``r``, :meth:`poll` builds the dense arrays one serving
    round consumes — every live slot decodes one token; up to
    ``max_prefill`` queued requests whose ``arrival <= r`` are admitted
    into free slots/pages as prefill lanes (head-of-line blocking: a
    request that cannot be admitted blocks the queue, preserving FIFO
    order) — and :meth:`commit` folds the round's emitted tokens back
    in, evicting requests that reached ``gen_len``.

    Inadmissible requests (see :func:`admissible`) are rejected
    permanently at the head of the queue with an empty result.
    """

    def __init__(self, splan, requests, *, registry=None):
        self.splan = splan
        self.n_slots = splan.n_slots
        self.max_prefill = splan.max_prefill
        self.prompt_budget = splan.prompt_budget
        self.n_pages = splan.n_pages
        self.n_stages = splan.n_stages
        self.queue = deque(sorted(requests,
                                  key=lambda q: (q.arrival, q.rid)))
        self.free_slots = list(range(self.n_slots))
        self.free_pages = list(range(self.n_pages))
        heapq.heapify(self.free_slots)
        heapq.heapify(self.free_pages)
        self.live: Dict[int, Dict[str, Any]] = {}      # slot -> record
        self.results: Dict[int, tuple] = {}
        self.events: List[Dict[str, Any]] = []
        self.registry = registry
        self._dec_slots: List[int] = []
        self._pf_lanes: List[tuple] = []               # (lane, slot)

    # ------------------------------------------------------------------ state
    @property
    def active(self) -> bool:
        return bool(self.live) or bool(self.queue)

    def next_arrival(self) -> Optional[int]:
        return self.queue[0].arrival if self.queue else None

    def _log(self, **ev) -> None:
        self.events.append(ev)
        if self.registry is not None:
            self.registry.emit("serve_sched", **ev)

    # ------------------------------------------------------------------ round
    def poll(self, r: int) -> Dict[str, np.ndarray]:
        """Arrays for round ``r``: the decode wave over live slots
        (dead slots point at the trash page ``n_pages``) plus newly
        admitted prefill lanes (``pf_len == 0`` marks an idle lane)."""
        R, F, P = self.n_slots, max(self.max_prefill, 1), \
            self.prompt_budget
        dec_tokens = np.zeros((R,), np.int32)
        dec_pos = np.zeros((R,), np.int32)
        dec_pages = np.full((R,), self.n_pages, np.int32)
        pf_tokens = np.zeros((F, P), np.int32)
        pf_len = np.zeros((F,), np.int32)
        pf_pages = np.full((F,), self.n_pages, np.int32)

        self._dec_slots = sorted(self.live)
        for slot in self._dec_slots:
            rec = self.live[slot]
            dec_tokens[slot] = rec["tokens"][-1]
            dec_pos[slot] = rec["prompt_len"] + len(rec["tokens"]) - 1
            dec_pages[slot] = rec["page"]
            self._log(ev="decode", round=r, rid=rec["rid"], slot=slot)

        self._pf_lanes = []
        lane = 0
        while self.queue and lane < self.max_prefill:
            req = self.queue[0]
            if req.arrival > r:
                break
            if not admissible(req, self.splan):
                self.queue.popleft()
                self.results[req.rid] = ()
                self._log(ev="reject", round=r, rid=req.rid,
                          prompt_len=len(req.prompt),
                          gen_len=req.gen_len)
                continue
            if not self.free_slots or not self.free_pages:
                break                      # head-of-line blocking (FIFO)
            self.queue.popleft()
            slot = heapq.heappop(self.free_slots)
            page = heapq.heappop(self.free_pages)
            self.live[slot] = {"rid": req.rid, "page": page,
                               "prompt_len": len(req.prompt),
                               "gen": req.gen_len, "tokens": []}
            p = len(req.prompt)
            pf_tokens[lane, :p] = req.prompt
            pf_len[lane] = p
            pf_pages[lane] = page
            self._pf_lanes.append((lane, slot))
            self._log(ev="admit", round=r, rid=req.rid, slot=slot,
                      pages=[page] * self.n_stages, prompt_len=p,
                      gen_len=req.gen_len)
            lane += 1
        return {"dec_tokens": dec_tokens, "dec_pos": dec_pos,
                "dec_pages": dec_pages, "pf_tokens": pf_tokens,
                "pf_len": pf_len, "pf_pages": pf_pages}

    def n_round_tokens(self) -> int:
        """Tokens the polled round will emit (one per live slot, one
        per admitted lane)."""
        return len(self._dec_slots) + len(self._pf_lanes)

    def commit(self, r: int, dec_next, pf_next) -> None:
        """Fold round ``r``'s emitted tokens back in: live slots append
        their decode token, admitted lanes their first (prefill) token;
        requests reaching ``gen_len`` are evicted and their slot and
        page return to the free heaps."""
        dec_next = np.asarray(dec_next)
        pf_next = np.asarray(pf_next)
        for slot in self._dec_slots:
            self.live[slot]["tokens"].append(int(dec_next[slot]))
            if len(self.live[slot]["tokens"]) == self.live[slot]["gen"]:
                self._evict(slot, r)
        for lane, slot in self._pf_lanes:
            self.live[slot]["tokens"].append(int(pf_next[lane]))
            if len(self.live[slot]["tokens"]) == self.live[slot]["gen"]:
                self._evict(slot, r)
        self._dec_slots, self._pf_lanes = [], []

    def _evict(self, slot: int, r: int) -> None:
        rec = self.live.pop(slot)
        self.results[rec["rid"]] = tuple(rec["tokens"])
        heapq.heappush(self.free_slots, slot)
        heapq.heappush(self.free_pages, rec["page"])
        self._log(ev="evict", round=r, rid=rec["rid"], slot=slot)
