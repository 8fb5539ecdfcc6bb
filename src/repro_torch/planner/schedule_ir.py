"""Serving-round IR (twin of the serve half of
``repro/planner/schedule_ir.py``).

A serving round, one decode wave plus up to ``max_prefill`` prefill
lanes, lowered to the dense :class:`ServeTable` that
``serve/engine.py``'s ``ServeEngine`` interprets row by row, and to the
per-device :class:`ServeStreams` that the JAX package's MPMD backend
runs (here they are compiled and verified only: stage-local execution is
a later slice of the port).  Pure numpy, copied from the JAX package;
the training half (``Schedule``, ``EventTable``) comes with the planner
slice.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


# ===========================================================================
# serving round lowering: prefill/decode opcodes -> a dense serve table
# (SPMD scan backend) and per-device serve streams (MPMD backend)
# ===========================================================================
#
# A serving round is forward-only: one batched **decode wave** (every
# live request slot advances one token, its per-stage KV pages updated
# in place) plus up to ``F = max_prefill`` **prefill lanes** (each lane
# runs one freshly admitted prompt through every stage, writing that
# request's KV pages from scratch).  The round is a pure staircase —
# the decode wave occupies device q at tick q, prefill lane j at tick
# 1 + j + q — so exactly one event runs per (device, tick) and every
# cut transfer crosses to device q+1 on the producing tick, the same
# one-event-per-(device, tick) invariant the training streams hold.
# Serving folds one chunk per device (C == S, no virtual stages):
# decode state is the KV pages themselves, which live where their
# chunk's weights live.

PREFILL, DECODE = "prefill", "decode"
OP_DECODE, OP_PREFILL = 2, 3          # extends OP_FWD/OP_BWD's numbering

# row columns (SCOL_* indices into ServeTable.rows[i])
SCOL_BRANCH = 0  # index into ServeTable.branches (the engine's arm)
SCOL_OP = 1      # OP_DECODE / OP_PREFILL (informational: branch implies it)
SCOL_CHUNK = 2   # chunk-stage q (informational: branch implies it)
SCOL_MB = 3      # prefill lane j, 0..F-1; 0 for the decode wave
SCOL_A = 4       # q>0: read slot of the lane's incoming hidden; -1 at q==0
SCOL_B = 5       # q<C-1: write slot of the outgoing hidden; -1 at q==C-1
SCOL_T = 6       # staircase tick (q + lane offset; verifier-checked)
SN_COLS = 7


@dataclass(frozen=True, eq=False)
class ServeTable:
    """Dense array encoding of one serving round.

    ``branches[b] = (kind, chunk_stage)`` with ``kind`` in
    {``decode``, ``prefill``} — the static facts a branch arm
    closes over (chunk picks the weights and KV-page buffer; kind picks
    the single-token wave vs. the masked whole-prompt scan).  ``rows``
    is ``[(1+F)·C, SN_COLS]`` int32.  Hidden-state slots are
    register-allocated over the round exactly like the training
    table's activation slots: the decode wave's [R, 1, d] hiddens and
    the prefill lanes' [1, P, d] hiddens live in two separate pools
    (different shapes), so ``n_dec_slots`` / ``n_pf_slots`` are each
    pool's true peak — 1 and min(F, C-1) for the staircase, but
    derived, not assumed.
    """
    n_chunks: int
    max_prefill: int
    branches: Tuple[Tuple[str, int], ...]
    rows: np.ndarray
    n_dec_slots: int
    n_pf_slots: int

    def __post_init__(self):
        self.rows.setflags(write=False)


def serve_round_events(n_chunks: int, max_prefill: int
                       ) -> List[Tuple[str, int, int, int]]:
    """One serving round's compute events ``(kind, lane, chunk, t)`` in
    timeline order: the decode wave (lane 0) enters at tick 0, prefill
    lane ``j`` at tick ``1 + j``, each advancing one chunk per tick.
    The resulting staircase runs exactly one event per (device, tick)
    with every stage cut crossed on the producing tick."""
    C, F = n_chunks, max_prefill
    if C < 1:
        raise ValueError(f"serving needs n_chunks >= 1, got {C}")
    if F < 0:
        raise ValueError(f"max_prefill must be >= 0, got {F}")
    ev = [(DECODE, 0, q, q) for q in range(C)]
    for j in range(F):
        ev.extend((PREFILL, j, q, 1 + j + q) for q in range(C))
    return sorted(ev, key=lambda e: (e[3], e[2]))


def compile_serve_table(events: List[Tuple[str, int, int, int]],
                        n_chunks: int, max_prefill: int) -> ServeTable:
    """Lower a serving round (:func:`serve_round_events`) to a
    :class:`ServeTable`.

    Walks the events once, allocating hidden-state slots over value
    lifetimes: a lane's hidden is born at chunk q's event and dies at
    chunk q+1's (the last chunk emits the token in-branch; the first
    chunk embeds in-branch) — the same greedy lowest-free-slot
    allocator the training table uses, one pool per opcode because the
    decode wave's and the prefill lanes' hiddens have different shapes.
    """
    C, F = n_chunks, max_prefill
    if len(events) != (1 + F) * C:
        raise ValueError(f"program has {len(events)} events, expected "
                         f"{(1 + F) * C} (= (1+{F})·{C})")
    specs: List[Tuple[str, int]] = []
    spec_ix: Dict[Tuple[str, int], int] = {}
    rows = []
    slot: Dict[Tuple[str, int], int] = {}      # (kind, lane) -> live slot
    free: Dict[str, List[int]] = {DECODE: [], PREFILL: []}
    hwm: Dict[str, int] = {DECODE: 0, PREFILL: 0}

    def alloc(kind: str) -> int:
        if free[kind]:
            return heapq.heappop(free[kind])
        hwm[kind] += 1
        return hwm[kind] - 1

    for kind, j, q, t in events:
        if kind not in (DECODE, PREFILL):
            raise ValueError(f"unknown serve opcode {kind!r}")
        if not (0 <= q < C) or (kind == PREFILL and not 0 <= j < F) \
                or (kind == DECODE and j != 0):
            raise ValueError(f"event ({kind},{j},{q}) out of range for "
                             f"F={F}, C={C}")
        key = (kind, q)
        if key not in spec_ix:
            spec_ix[key] = len(specs)
            specs.append(key)
        if q == 0:
            if (kind, j) in slot:
                raise ValueError(f"{kind}({j},0) emitted twice")
            a = -1
        else:
            if (kind, j) not in slot:
                raise ValueError(
                    f"{kind}({j},{q}) before {kind}({j},{q - 1})")
            a = slot.pop((kind, j))
            heapq.heappush(free[kind], a)
        if q < C - 1:
            b = alloc(kind)
            slot[(kind, j)] = b
        else:
            b = -1
        op = OP_DECODE if kind == DECODE else OP_PREFILL
        rows.append((spec_ix[key], op, q, j, a, b, t))
    if slot:
        raise ValueError(
            f"serving round leaves in-flight values: {sorted(slot)}")
    return ServeTable(
        n_chunks=C, max_prefill=F, branches=tuple(specs),
        rows=np.asarray(rows, np.int32).reshape(-1, SN_COLS),
        n_dec_slots=hwm[DECODE], n_pf_slots=hwm[PREFILL])


# per-device serve stream columns (SDCOL_* indices into
# ServeStreams.rows[t, d]).  Both payload rings (decode [R,1,d] and
# prefill [1,P,d] hiddens) run every tick; a row's RECV column says
# which local slot parks the incoming payload (-1 -> the trash slot).
SDCOL_BRANCH = 0  # branch arm; -1 rewritten to the NOP arm
SDCOL_MB = 1      # prefill lane j; 0 for the decode wave
SDCOL_A = 2       # q>0: read slot of the incoming hidden; -1 at q==0
SDCOL_RECV_D = 3  # local decode-pool slot for this tick's payload
SDCOL_RECV_P = 4  # local prefill-pool slot for this tick's payload
SDN_COLS = 5


@dataclass(frozen=True, eq=False)
class ServeStreams:
    """Per-device tick streams of one serving round.

    ``rows`` is ``[T, S, SDN_COLS]`` int32, ``T = C + F`` staircase
    ticks — slicing column ``d`` with ``PartitionSpec(None, 'pipe')``
    hands each device exactly its own stream, as in the training
    :class:`DeviceStreams`.  Hidden-state slots are register-allocated
    per device and per pool; pool sizes are the max over devices so the
    pools stay SPMD-uniform.  Arm ``len(branches)`` is the NOP.
    """
    n_chunks: int
    max_prefill: int
    n_devices: int
    branches: Tuple[Tuple[str, int], ...]
    rows: np.ndarray
    n_dec_slots: int
    n_pf_slots: int

    def __post_init__(self):
        self.rows.setflags(write=False)


def compile_serve_streams(events: List[Tuple[str, int, int, int]],
                          n_chunks: int, max_prefill: int,
                          n_devices: int) -> ServeStreams:
    """Lower a serving round (:func:`serve_round_events`) to per-device
    tick streams (:class:`ServeStreams`).

    Serving folds one chunk per device: the decode wave's state is the
    per-stage KV pages, which live with their chunk's weights, so
    ``n_chunks == n_devices`` is required (no Megatron chunk folding —
    two chunks of one device would interleave page updates within one
    tick).  A hidden crossing a stage cut is born on the consumer's
    device at the producer's tick and dies when the consumer reads it.
    """
    C, F, S = n_chunks, max_prefill, n_devices
    if C != S:
        raise ValueError(
            f"serving folds one chunk per device: {C} chunks need "
            f"{C} devices, got {S}")
    if len(events) != (1 + F) * C:
        raise ValueError(f"program has {len(events)} events, expected "
                         f"{(1 + F) * C} (= (1+{F})·{C})")
    T = max(t for _k, _j, _q, t in events) + 1
    by_tick: Dict[int, List[Tuple[str, int, int]]] = {}
    seen_dev: set = set()
    for kind, j, q, t in events:
        if kind not in (DECODE, PREFILL) or not 0 <= q < C:
            raise ValueError(f"event ({kind},{j},{q}) out of range for "
                             f"F={F}, C={C}")
        d = q                     # one chunk per device
        if (t, d) in seen_dev:
            raise ValueError(
                f"device {d} has two serve events at tick {t} — the "
                f"round is not one-event-per-(device, tick)")
        seen_dev.add((t, d))
        by_tick.setdefault(t, []).append((kind, j, q))

    specs: List[Tuple[str, int]] = []
    spec_ix: Dict[Tuple[str, int], int] = {}
    rows = np.full((T, S, SDN_COLS), -1, np.int32)
    rows[:, :, SDCOL_MB] = 0

    # per-device register allocators: [device][kind] min-heap + hwm
    free = [{DECODE: [], PREFILL: []} for _ in range(S)]
    hwm = [{DECODE: 0, PREFILL: 0} for _ in range(S)]

    def alloc(d: int, kind: str) -> int:
        if free[d][kind]:
            return heapq.heappop(free[d][kind])
        hwm[d][kind] += 1
        return hwm[d][kind] - 1

    pending: Dict[Tuple[str, int], int] = {}   # in-flight (kind, lane)
    done: set = set()                          # lanes that left the pipe
    for t in range(T):
        evs = sorted(by_tick.get(t, ()), key=lambda e: e[2])
        # phase 1: frees from this tick's reads (before any allocation)
        for kind, j, q in evs:
            if q == 0:
                if (kind, j) in pending or (kind, j) in done:
                    raise ValueError(f"{kind}({j},0) emitted twice")
                continue
            if (kind, j) not in pending:
                raise ValueError(
                    f"{kind}({j},{q}) before {kind}({j},{q - 1})")
            heapq.heappush(free[q][kind], pending[(kind, j)])
        # phase 2: the events' own rows
        for kind, j, q in evs:
            key = (kind, q)
            if key not in spec_ix:
                spec_ix[key] = len(specs)
                specs.append(key)
            row = rows[t, q]
            row[SDCOL_BRANCH] = spec_ix[key]
            row[SDCOL_MB] = j
            if q > 0:
                row[SDCOL_A] = pending.pop((kind, j))
            if q == C - 1:
                done.add((kind, j))
        # phase 3: payload receives on the next device (land after the
        # neighbor's branch ran, so freed slots are reusable)
        for kind, j, q in evs:
            if q == C - 1:
                continue
            nd = q + 1
            s = alloc(nd, kind)
            pending[(kind, j)] = s
            rows[t, nd, SDCOL_RECV_D if kind == DECODE
                 else SDCOL_RECV_P] = s

    if pending:
        raise ValueError(
            f"serving round leaves in-flight values: {sorted(pending)}")
    # un-filled branch column -> the NOP arm (a valid switch index)
    br = rows[:, :, SDCOL_BRANCH]
    br[br < 0] = len(specs)
    return ServeStreams(
        n_chunks=C, max_prefill=F, n_devices=S, branches=tuple(specs),
        rows=rows,
        n_dec_slots=max(h[DECODE] for h in hwm) if S else 0,
        n_pf_slots=max(h[PREFILL] for h in hwm) if S else 0)
