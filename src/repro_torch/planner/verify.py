"""Static schedule verifier (twin of ``repro/planner/verify.py``; pure
numpy, copied from the JAX package): dataflow, race and staleness
analysis over the compiled pipeline IR.

The IR interpreter's ``"scan"`` backend (``core/pipeline_stream.py``)
and the serving engine run artifacts produced by greedy register
allocators (``planner/schedule_ir.py``).  This module proves each one
before it runs: it re-simulates the artifact row by row with symbolic
value ids — ``v(m, q)`` (microbatch m's input to chunk q; ``v(m, C)``
the head input) and ``c(m, q)`` (the cotangent w.r.t. ``v(m, q)``) —
against an independent model of what each event must read, write, free
and send, and collects every violation, grouped into classes (the
``check`` field of each :class:`Violation`):

``slot-hazard``
    every slot read is dominated by a write of the matching value, no
    write clobbers a live value (WAR/WAW), and no slot reference escapes
    its pool — for the global pools *and* the per-device pools.
``comm-mismatch``
    every tick's ring sends pair up with an armed receive slot on the
    right neighbour, armed receives have a sender, and no real payload
    is parked in the trash slot.
``wv-lag``
    each event's weight-version lag equals the closed form for its
    schedule, the row's ``wv`` column agrees with its branch spec, and
    stash reads stay within the IR-derived weight-stash depth.
``double-contribution``
    first-contribution markers (per-chunk grad, head outer grad, embed
    outer grad) fire exactly once per round, on the owner's first
    backward.
``completeness``
    every microbatch gets exactly one fwd and one bwd per chunk, in
    topological order, and the round ends with no value in flight.
``resource-bound``
    the verified peak slot liveness equals the allocator's pool sizes
    and the per-chunk activation-stash peak equals ``plan.act_stash``.
``placement``
    chunk q's events run on device q mod S; head/embed markers land on
    their pinned devices.
``encoding``
    row columns agree with their branch spec.
``decode-once``
    serving: the decode wave visits every chunk exactly once per round,
    and every live request decodes exactly once per round over its
    lifetime.
``page-lifetime``
    serving: a request's KV pages come from the free set at admission,
    are held for its whole lifetime and return exactly at eviction.

It cannot prove what the branch bodies compute, only which values flow.

Entry points: :func:`verify_event_table`, :func:`verify_device_streams`,
:func:`verify_serve_table`, :func:`verify_serve_streams`,
:func:`verify_request_trace` (each returns a :class:`VerifyReport`),
:func:`verify_plan` / :func:`check_plan` and :func:`verify_serve_plan` /
:func:`check_serve_plan` (plan-level, the ``check_`` ones raising), the
mutation harnesses (:func:`mutation_catalog`, :func:`self_test`,
:func:`serve_mutation_catalog`, :func:`serve_self_test`) proving the
checks have power, and a CLI::

    python -m repro_torch.planner.verify --schedule 1f1b --stages 3
    python -m repro_torch.planner.verify --grid        # the verify grid
    python -m repro_torch.planner.verify --self-test   # mutation harness
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.planner import schedule_ir as sir

CHECKS = ("slot-hazard", "comm-mismatch", "wv-lag", "double-contribution",
          "completeness", "resource-bound", "placement", "encoding",
          "decode-once", "page-lifetime")


@dataclass(frozen=True)
class Violation:
    """One failed invariant: ``check`` is the class (one of
    :data:`CHECKS`), ``site`` locates the row/tick, ``message`` names
    the expected-vs-found facts."""
    check: str
    site: str
    message: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.site}: {self.message}"


class VerificationError(ValueError):
    """A compiled schedule artifact failed static verification."""

    def __init__(self, artifact: str, violations: Tuple[Violation, ...]):
        self.artifact = artifact
        self.violations = tuple(violations)
        lines = "\n".join(f"  {v}" for v in self.violations[:20])
        more = ("" if len(self.violations) <= 20
                else f"\n  ... and {len(self.violations) - 20} more")
        super().__init__(
            f"{artifact}: {len(self.violations)} verification "
            f"violation(s):\n{lines}{more}")


@dataclass(frozen=True)
class VerifyReport:
    """Outcome of verifying one artifact: all violations (the verifier
    never stops at the first) plus the measured stats the resource
    checks compared against."""
    artifact: str
    schedule: str
    n_events: int
    violations: Tuple[Violation, ...]
    stats: Dict[str, object]

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_on_violation(self) -> "VerifyReport":
        if self.violations:
            raise VerificationError(
                f"{self.schedule}/{self.artifact}", self.violations)
        return self


def expected_lag(schedule: str, chunk: int, n_chunks: int,
                 phase: str) -> int:
    """The closed-form weight-version lag of a (schedule, chunk, phase)
    read — PipeDream-flush/GPipe/interleaved are staleness-free by
    construction, 2BW pins every read one version back (the paper's
    double-buffer semantics, ``core/spectrain.py``)."""
    from repro_torch.core import spectrain as st
    if schedule == "gpipe":
        return 0
    if schedule in ("1f1b", "interleaved"):
        return st.version_difference_1f1b(chunk, n_chunks, phase)
    if schedule == "2bw":
        return st.version_difference_2bw(chunk, n_chunks, phase)
    raise KeyError(f"no closed-form lag for schedule {schedule!r}; "
                   f"round schedules are {sir.ROUND_SCHEDULES}")


# ===========================================================================
# slot-pool simulation
# ===========================================================================


def _fmt(value: Tuple[str, int, int]) -> str:
    kind, m, q = value
    return f"{kind}({m},{q})"


class _Pool:
    """Symbolic slot pool: tracks which value id lives in which slot,
    flags reads of dead/mismatched slots and writes over live values,
    and records the peak liveness the resource checks compare against.

    On a mismatched read the pool frees the slot where the expected
    value *actually* lives (if anywhere), so one corruption yields a
    precise violation instead of a cascade."""

    def __init__(self, name: str, n_slots: int,
                 add: Callable[[str, str, str], None]):
        self.name = name
        self.n = n_slots
        self.add = add
        self.slots: Dict[int, Tuple[str, int, int]] = {}
        self.peak = 0

    def _in_range(self, slot: int, what: str, site: str) -> bool:
        if 0 <= slot < self.n:
            return True
        self.add("slot-hazard", site,
                 f"{what} targets {self.name} slot {slot} outside the "
                 f"pool [0, {self.n}) — a dynamic index there clamps "
                 f"onto a live slot")
        return False

    def write(self, slot: int, value: Tuple[str, int, int],
              site: str) -> None:
        if not self._in_range(slot, f"write of {_fmt(value)}", site):
            return
        held = self.slots.get(slot)
        if held is not None:
            self.add("slot-hazard", site,
                     f"write of {_fmt(value)} clobbers live "
                     f"{_fmt(held)} in {self.name} slot {slot} "
                     f"(WAW/WAR hazard)")
        self.slots[slot] = value
        self.peak = max(self.peak, len(self.slots))

    def read(self, slot: int, value: Tuple[str, int, int], site: str,
             *, free: bool) -> None:
        if self._in_range(slot, f"read of {_fmt(value)}", site):
            held = self.slots.get(slot)
            if held != value:
                found = "a dead slot" if held is None else _fmt(held)
                self.add("slot-hazard", site,
                         f"read of {_fmt(value)} from {self.name} slot "
                         f"{slot} finds {found}")
        if free:
            for s, v in list(self.slots.items()):
                if v == value:
                    del self.slots[s]
                    break

    def leftovers(self) -> List[str]:
        return [f"{_fmt(v)} in {self.name} slot {s}"
                for s, v in sorted(self.slots.items())]


class _Round:
    """Shared per-round bookkeeping: fwd/bwd completion and ordering,
    first-contribution markers, per-chunk activation-stash peaks."""

    def __init__(self, n_chunks: int, n_microbatches: int,
                 add: Callable[[str, str, str], None]):
        self.C, self.M, self.add = n_chunks, n_microbatches, add
        self.fwd_done: Dict[Tuple[int, int], str] = {}
        self.bwd_done: Dict[Tuple[int, int], str] = {}
        self.stash = [0] * n_chunks
        self.stash_peak = [0] * n_chunks
        self.first_bwd_site: Dict[int, str] = {}
        self.marks_g: Dict[int, List[str]] = {q: [] for q in range(n_chunks)}
        self.marks_o: List[str] = []
        self.marks_e: List[str] = []

    def fwd(self, m: int, q: int, site: str) -> None:
        if (m, q) in self.fwd_done:
            self.add("completeness", site,
                     f"fwd({m},{q}) emitted twice (first at "
                     f"{self.fwd_done[(m, q)]})")
            return
        if q > 0 and (m, q - 1) not in self.fwd_done:
            self.add("completeness", site,
                     f"fwd({m},{q}) before fwd({m},{q - 1})")
        self.fwd_done[(m, q)] = site
        self.stash[q] += 1
        self.stash_peak[q] = max(self.stash_peak[q], self.stash[q])

    def bwd(self, m: int, q: int, site: str) -> None:
        if (m, q) in self.bwd_done:
            self.add("completeness", site,
                     f"bwd({m},{q}) emitted twice (first at "
                     f"{self.bwd_done[(m, q)]})")
            return
        if (m, q) not in self.fwd_done:
            self.add("completeness", site,
                     f"bwd({m},{q}) before fwd({m},{q})")
        if q < self.C - 1 and (m, q + 1) not in self.bwd_done:
            self.add("completeness", site,
                     f"bwd({m},{q}) before bwd({m},{q + 1})")
        self.bwd_done[(m, q)] = site
        self.first_bwd_site.setdefault(q, site)
        self.stash[q] -= 1

    def marks(self, kind: str, q: int, fg: int, fo: int, fe: int,
              site: str) -> None:
        if kind != sir.BWD:
            if fg or fo or fe:
                self.add("double-contribution", site,
                         "first-contribution marker on a non-backward "
                         "event")
            return
        if fg:
            self.marks_g[q].append(site)
        if fo:
            if q != self.C - 1:
                self.add("double-contribution", site,
                         f"head first-marker on chunk {q}; the head "
                         f"grad is produced only at chunk {self.C - 1}")
            self.marks_o.append(site)
        if fe:
            if q != 0:
                self.add("double-contribution", site,
                         f"embed first-marker on chunk {q}; the embed "
                         f"grad is produced only at chunk 0")
            self.marks_e.append(site)

    def finish(self) -> None:
        for m in range(self.M):
            for q in range(self.C):
                if (m, q) not in self.fwd_done:
                    self.add("completeness", "round end",
                             f"fwd({m},{q}) never emitted")
                if (m, q) not in self.bwd_done:
                    self.add("completeness", "round end",
                             f"bwd({m},{q}) never emitted")
        head_first = self.first_bwd_site.get(self.C - 1, "<none>")
        embed_first = self.first_bwd_site.get(0, "<none>")
        for q in range(self.C):
            marks = self.marks_g[q]
            want = self.first_bwd_site.get(q, "<none>")
            if len(marks) != 1:
                self.add("double-contribution", "round end",
                         f"chunk {q} first-grad marker fires "
                         f"{len(marks)}x at {marks or '<never>'}, "
                         f"expected exactly once at {want}")
            elif marks[0] != want:
                self.add("double-contribution", marks[0],
                         f"chunk {q} first-grad marker not on its "
                         f"first backward ({want})")
        for name, marks, want in (("head", self.marks_o, head_first),
                                  ("embed", self.marks_e, embed_first)):
            if len(marks) != 1:
                self.add("double-contribution", "round end",
                         f"{name} outer-grad first-marker fires "
                         f"{len(marks)}x at {marks or '<never>'}, "
                         f"expected exactly once at {want}")
            elif marks[0] != want:
                self.add("double-contribution", marks[0],
                         f"{name} outer-grad first-marker not on the "
                         f"{name} owner's first backward ({want})")


def _check_branches(branches, C: int, add) -> None:
    for b, (kind, q, s) in enumerate(branches):
        if kind not in (sir.FWD, sir.BWD):
            add("encoding", f"branch {b}", f"unknown opcode {kind!r}")
        if not 0 <= q < C:
            add("encoding", f"branch {b}",
                f"chunk {q} out of range for {C} chunks")
        if s < 0:
            add("encoding", f"branch {b}", f"negative wv lag {s}")


def _check_lag(schedule: str, kind: str, q: int, s: int, C: int,
               w_stash_depth, site: str, add) -> None:
    phase = "forward" if kind == sir.FWD else "backward"
    try:
        want = expected_lag(schedule, q, C, phase)
    except KeyError:
        return
    if s != want:
        add("wv-lag", site,
            f"{kind}({q}) reads at lag {s}; the {schedule!r} closed "
            f"form is {want}")
    if w_stash_depth is not None and s + 1 > w_stash_depth[q]:
        add("wv-lag", site,
            f"lag {s} needs {s + 1} stashed weight versions on chunk "
            f"{q}; the IR derives depth {w_stash_depth[q]}")


# ===========================================================================
# event-table verification (the IR interpreter's scan backend's artifact)
# ===========================================================================


def verify_event_table(table: sir.EventTable, *, schedule: str,
                       act_stash: Optional[Tuple[int, ...]] = None,
                       w_stash_depth: Optional[Tuple[int, ...]] = None
                       ) -> VerifyReport:
    """Statically verify an :class:`~repro_torch.planner.schedule_ir.EventTable`
    by re-simulating its rows against the global value/cotangent slot
    pools.  Collects every violation; never raises."""
    viols: List[Violation] = []

    def add(check: str, site: str, msg: str) -> None:
        viols.append(Violation(check, site, msg))

    C, M = table.n_chunks, table.n_microbatches
    rows = np.asarray(table.rows)
    nb = len(table.branches)
    _check_branches(table.branches, C, add)
    if rows.shape != (2 * M * C, sir.N_COLS):
        add("completeness", "table",
            f"rows shape {rows.shape} != ({2 * M * C}, {sir.N_COLS}) "
            f"for M={M}, C={C}")
    val = _Pool("value", table.n_val_slots, add)
    cot = _Pool("cotangent", table.n_cot_slots, add)
    rnd = _Round(C, M, add)

    for i, r in enumerate(map(tuple, rows.tolist())):
        br = r[sir.COL_BRANCH]
        if not 0 <= br < nb:
            add("encoding", f"row {i}",
                f"branch id {br} outside [0, {nb})")
            continue
        kind, q, s = table.branches[br]
        m = r[sir.COL_MB]
        site = f"row {i} ({kind} m={m} q={q})"
        if r[sir.COL_OP] != (sir.OP_FWD if kind == sir.FWD else sir.OP_BWD):
            add("encoding", site,
                f"op column {r[sir.COL_OP]} contradicts branch "
                f"opcode {kind!r}")
        if r[sir.COL_CHUNK] != q:
            add("encoding", site,
                f"chunk column {r[sir.COL_CHUNK]} contradicts branch "
                f"chunk {q}")
        if not 0 <= m < M:
            add("completeness", site,
                f"microbatch {m} outside [0, {M})")
            continue
        if r[sir.COL_WV] != s:
            add("wv-lag", site,
                f"wv column {r[sir.COL_WV]} contradicts the branch's "
                f"lag {s} — the interpreter predicts by the branch")
        _check_lag(schedule, kind, q, s, C, w_stash_depth, site, add)
        a, b, c = r[sir.COL_A], r[sir.COL_B], r[sir.COL_C]
        rnd.marks(kind, q, r[sir.COL_FIRST_G], r[sir.COL_FIRST_O],
                  r[sir.COL_FIRST_E], site)
        if kind == sir.FWD:
            rnd.fwd(m, q, site)
            if q == 0:
                val.write(a, ("v", m, 0), site)
            else:
                val.read(a, ("v", m, q), site, free=False)
            val.write(b, ("v", m, q + 1), site)
            if c != -1:
                add("encoding", site,
                    f"forward row carries a cotangent write slot {c}")
        else:
            rnd.bwd(m, q, site)
            val.read(a, ("v", m, q), site, free=True)
            if q == C - 1:
                val.read(b, ("v", m, C), site, free=True)
            else:
                cot.read(b, ("c", m, q + 1), site, free=True)
            if q > 0:
                cot.write(c, ("c", m, q), site)
            elif c != -1:
                add("encoding", site,
                    f"chunk-0 backward carries a cotangent write "
                    f"slot {c} (the embed backward consumes c(m,0) "
                    f"in-branch)")
    rnd.finish()
    for leak in val.leftovers() + cot.leftovers():
        add("completeness", "round end", f"round leaves live {leak}")
    if val.peak != table.n_val_slots:
        add("resource-bound", "round end",
            f"verified peak value liveness {val.peak} != allocated "
            f"n_val_slots {table.n_val_slots}")
    if cot.peak != table.n_cot_slots:
        add("resource-bound", "round end",
            f"verified peak cotangent liveness {cot.peak} != allocated "
            f"n_cot_slots {table.n_cot_slots}")
    if act_stash is not None and tuple(rnd.stash_peak) != tuple(act_stash):
        add("resource-bound", "round end",
            f"verified per-chunk activation-stash peaks "
            f"{tuple(rnd.stash_peak)} != plan.act_stash "
            f"{tuple(act_stash)}")
    return VerifyReport(
        artifact="event_table", schedule=schedule,
        n_events=int(rows.shape[0]), violations=tuple(viols),
        stats={"peak_val": val.peak, "peak_cot": cot.peak,
               "stash_peak": tuple(rnd.stash_peak)})


# ===========================================================================
# device-stream verification (the MPMD backend's artifact)
# ===========================================================================


def verify_device_streams(streams: sir.DeviceStreams, *, schedule: str,
                          act_stash: Optional[Tuple[int, ...]] = None,
                          w_stash_depth: Optional[Tuple[int, ...]] = None
                          ) -> VerifyReport:
    """Statically verify a
    :class:`~repro_torch.planner.schedule_ir.DeviceStreams` artifact: per-tick
    re-simulation of every device's compute against its *private* slot
    pools, plus the ring matching — each tick's sends must
    land in an armed receive slot on the right neighbor, each armed slot
    must have a sender, head/embed markers must sit on their pinned
    devices.  Collects every violation; never raises."""
    viols: List[Violation] = []

    def add(check: str, site: str, msg: str) -> None:
        viols.append(Violation(check, site, msg))

    C, M, S = streams.n_chunks, streams.n_microbatches, streams.n_devices
    rows = np.asarray(streams.rows)
    T = rows.shape[0]
    nb = len(streams.branches)          # arm nb is the NOP
    nv, nc = streams.n_val_slots, streams.n_cot_slots
    d_head = (C - 1) % S
    _check_branches(streams.branches, C, add)
    if rows.shape[1:] != (S, sir.DN_COLS):
        add("encoding", "streams",
            f"rows shape {rows.shape} != (T, {S}, {sir.DN_COLS})")
    vals = [_Pool(f"dev{d} value", nv, add) for d in range(S)]
    cots = [_Pool(f"dev{d} cotangent", nc, add) for d in range(S)]
    rnd = _Round(C, M, add)
    n_events = 0

    for t in range(T):
        # -- phase 1: this tick's compute events, per device ------------
        sends_f: Dict[int, Tuple[str, Tuple[str, int, int]]] = {}
        sends_b: Dict[int, Tuple[str, Tuple[str, int, int]]] = {}
        for d in range(S):
            r = tuple(int(x) for x in rows[t, d])
            br = r[sir.DCOL_BRANCH]
            site = f"tick {t}/dev {d}"
            if not 0 <= br <= nb:
                add("encoding", site,
                    f"branch id {br} outside [0, {nb}]")
                continue
            if br == nb:                # NOP arm
                for col, name in ((sir.DCOL_A, "A"), (sir.DCOL_B, "B"),
                                  (sir.DCOL_C, "C")):
                    if r[col] != -1:
                        add("encoding", site,
                            f"idle row carries slot column {name}="
                            f"{r[col]}")
                if (r[sir.DCOL_FIRST_G] or r[sir.DCOL_FIRST_O]
                        or r[sir.DCOL_FIRST_E]):
                    add("double-contribution", site,
                        "first-contribution marker on an idle row")
                continue
            n_events += 1
            kind, q, s = streams.branches[br]
            m = r[sir.DCOL_MB]
            site = f"tick {t}/dev {d} ({kind} m={m} q={q})"
            if q % S != d:
                add("placement", site,
                    f"chunk {q} lives on device {q % S} "
                    f"(Megatron round-robin), scheduled on device {d}")
            if not 0 <= m < M:
                add("completeness", site,
                    f"microbatch {m} outside [0, {M})")
                continue
            _check_lag(schedule, kind, q, s, C, w_stash_depth, site, add)
            a, b, c = r[sir.DCOL_A], r[sir.DCOL_B], r[sir.DCOL_C]
            if r[sir.DCOL_FIRST_O] and d != d_head:
                add("placement", site,
                    f"head first-marker on device {d}; the head is "
                    f"statically pinned to device {d_head}")
            if r[sir.DCOL_FIRST_E] and d != 0:
                add("placement", site,
                    f"embed first-marker on device {d}; the embed is "
                    f"statically pinned to device 0")
            rnd.marks(kind, q, r[sir.DCOL_FIRST_G], r[sir.DCOL_FIRST_O],
                      r[sir.DCOL_FIRST_E], site)
            if kind == sir.FWD:
                rnd.fwd(m, q, site)
                if q == 0:
                    vals[d].write(a, ("v", m, 0), site)
                else:
                    vals[d].read(a, ("v", m, q), site, free=False)
                if q == C - 1:
                    vals[d].write(b, ("v", m, C), site)
                elif b != -1:
                    add("encoding", site,
                        f"non-head forward carries a local output "
                        f"slot B={b} (outputs ship on the ring)")
                if c != -1:
                    add("encoding", site,
                        f"forward row carries cotangent slot C={c}")
                if q < C - 1:
                    sends_f[(d + 1) % S] = (site, ("v", m, q + 1))
            else:
                rnd.bwd(m, q, site)
                vals[d].read(a, ("v", m, q), site, free=True)
                if q == C - 1:
                    vals[d].read(b, ("v", m, C), site, free=True)
                else:
                    if b != -1:
                        add("encoding", site,
                            f"non-head backward carries head slot "
                            f"B={b}")
                    cots[d].read(c, ("c", m, q + 1), site, free=True)
                if q == C - 1 and c != -1:
                    add("encoding", site,
                        f"head backward carries cotangent slot C={c}")
                if q > 0:
                    sends_b[(d - 1) % S] = (site, ("c", m, q))
        # -- phase 2: ring transfers land after every branch ran --------
        for d in range(S):
            r = tuple(int(x) for x in rows[t, d])
            site = f"tick {t}/dev {d}"
            for recv_col, sends, pool, ring in (
                    (sir.DCOL_RECV_F, sends_f, vals[d], "forward"),
                    (sir.DCOL_RECV_B, sends_b, cots[d], "backward")):
                slot = r[recv_col]
                sent = sends.pop(d, None)
                if slot < 0:
                    if sent is not None:
                        add("comm-mismatch", site,
                            f"{ring}-ring payload {_fmt(sent[1])} from "
                            f"{sent[0]} lands in the trash slot — its "
                            f"consumer will read a dead slot")
                    continue
                if sent is None:
                    add("comm-mismatch", site,
                        f"{ring}-ring receive armed into slot {slot} "
                        f"with no sender this tick — the slot is "
                        f"filled with ring garbage")
                    continue
                if slot >= pool.n:
                    add("comm-mismatch", site,
                        f"{ring}-ring payload {_fmt(sent[1])} parked "
                        f"in slot {slot} outside the live pool "
                        f"[0, {pool.n}) (the trash)")
                    continue
                pool.write(slot, sent[1], site)
        for sends, ring in ((sends_f, "forward"), (sends_b, "backward")):
            for nd, (src, value) in sends.items():
                add("comm-mismatch", f"tick {t}/dev {nd}",
                    f"{ring}-ring payload {_fmt(value)} from {src} has "
                    f"no matching receive")
    rnd.finish()
    for pool in vals + cots:
        for leak in pool.leftovers():
            add("completeness", "round end", f"round leaves live {leak}")
    peak_v = max(p.peak for p in vals)
    peak_c = max(p.peak for p in cots)
    if peak_v != nv:
        add("resource-bound", "round end",
            f"verified per-device peak value liveness {peak_v} != "
            f"allocated n_val_slots {nv}")
    if peak_c != nc:
        add("resource-bound", "round end",
            f"verified per-device peak cotangent liveness {peak_c} != "
            f"allocated n_cot_slots {nc}")
    if act_stash is not None and tuple(rnd.stash_peak) != tuple(act_stash):
        add("resource-bound", "round end",
            f"verified per-chunk activation-stash peaks "
            f"{tuple(rnd.stash_peak)} != plan.act_stash "
            f"{tuple(act_stash)}")
    return VerifyReport(
        artifact="device_streams", schedule=schedule, n_events=n_events,
        violations=tuple(viols),
        stats={"peak_val": peak_v, "peak_cot": peak_c,
               "stash_peak": tuple(rnd.stash_peak), "n_ticks": T})


# ===========================================================================
# plan-level entry points
# ===========================================================================


def verify_plan(plan, *, device_streams: bool = True
                ) -> Tuple[VerifyReport, ...]:
    """Verify every compiled artifact of a
    :class:`~repro_torch.planner.api.PipelinePlan`.  Round schedules verify
    the event table and (by default) the device streams; non-round
    schedules re-validate the event timeline.  Returns the reports
    without raising — :func:`check_plan` is the raising wrapper."""
    if plan.schedule not in sir.ROUND_SCHEDULES:
        plan.round_ir().validate()
        return (VerifyReport(artifact="schedule", schedule=plan.schedule,
                             n_events=len(plan.round_ir().events),
                             violations=(), stats={}),)
    kw = dict(schedule=plan.schedule, act_stash=plan.act_stash,
              w_stash_depth=plan.w_stash_depth)
    reports = [verify_event_table(plan.event_table(), **kw)]
    if device_streams:
        reports.append(verify_device_streams(plan.device_streams(), **kw))
    return tuple(reports)


def check_plan(plan, *, device_streams: bool = True) -> None:
    """Raise :class:`VerificationError` if any of the plan's compiled
    artifacts fails static verification."""
    for report in verify_plan(plan, device_streams=device_streams):
        report.raise_on_violation()


# ===========================================================================
# serving-round verification (ServeTable / ServeStreams / request traces)
# ===========================================================================


def _serve_tick(kind: str, j: int, q: int) -> int:
    """The staircase tick of serve event ``(kind, lane, chunk)`` — the
    decode wave enters at tick 0, prefill lane j at tick 1 + j, one
    chunk per tick."""
    return q if kind == sir.DECODE else 1 + j + q


def _check_serve_branches(branches, C: int, add) -> None:
    for b, (kind, q) in enumerate(branches):
        if kind not in (sir.DECODE, sir.PREFILL):
            add("encoding", f"branch {b}", f"unknown serve opcode {kind!r}")
        if not 0 <= q < C:
            add("encoding", f"branch {b}",
                f"chunk {q} out of range for {C} chunks")


class _ServeRound:
    """Per-round serving bookkeeping: chain ordering per lane, the
    decode wave's exactly-once-per-chunk invariant, completeness."""

    def __init__(self, n_chunks: int, max_prefill: int, add):
        self.C, self.F, self.add = n_chunks, max_prefill, add
        self.done: Dict[Tuple[str, int, int], str] = {}

    def event(self, kind: str, j: int, q: int, site: str) -> bool:
        key = (kind, j, q)
        if key in self.done:
            check = ("decode-once" if kind == sir.DECODE
                     else "completeness")
            self.add(check, site,
                     f"{kind}({j},{q}) emitted twice (first at "
                     f"{self.done[key]}) — a re-decoded chunk advances "
                     f"its KV pages twice in one round")
            return False
        if q > 0 and (kind, j, q - 1) not in self.done:
            self.add("completeness", site,
                     f"{kind}({j},{q}) before {kind}({j},{q - 1})")
        self.done[key] = site
        return True

    def finish(self) -> None:
        lanes = [(sir.DECODE, 0)] + [(sir.PREFILL, j)
                                     for j in range(self.F)]
        for kind, j in lanes:
            for q in range(self.C):
                if (kind, j, q) not in self.done:
                    check = ("decode-once" if kind == sir.DECODE
                             else "completeness")
                    self.add(check, "round end",
                             f"{kind}({j},{q}) never emitted")


def verify_serve_table(table: sir.ServeTable) -> VerifyReport:
    """Statically verify a
    :class:`~repro_torch.planner.schedule_ir.ServeTable` by re-simulating its
    rows against the decode/prefill hidden-state slot pools and the
    staircase encoding.  Collects every violation; never raises."""
    viols: List[Violation] = []

    def add(check: str, site: str, msg: str) -> None:
        viols.append(Violation(check, site, msg))

    C, F = table.n_chunks, table.max_prefill
    rows = np.asarray(table.rows)
    nb = len(table.branches)
    _check_serve_branches(table.branches, C, add)
    if rows.shape != ((1 + F) * C, sir.SN_COLS):
        add("completeness", "table",
            f"rows shape {rows.shape} != ({(1 + F) * C}, {sir.SN_COLS}) "
            f"for F={F}, C={C}")
    dec = _Pool("decode-hidden", table.n_dec_slots, add)
    pf = _Pool("prefill-hidden", table.n_pf_slots, add)
    rnd = _ServeRound(C, F, add)

    for i, r in enumerate(map(tuple, rows.tolist())):
        br = r[sir.SCOL_BRANCH]
        if not 0 <= br < nb:
            add("encoding", f"row {i}",
                f"branch id {br} outside [0, {nb})")
            continue
        kind, q = table.branches[br]
        j = r[sir.SCOL_MB]
        site = f"row {i} ({kind} j={j} q={q})"
        want_op = sir.OP_DECODE if kind == sir.DECODE else sir.OP_PREFILL
        if r[sir.SCOL_OP] != want_op:
            add("encoding", site,
                f"op column {r[sir.SCOL_OP]} contradicts branch "
                f"opcode {kind!r}")
        if r[sir.SCOL_CHUNK] != q:
            add("encoding", site,
                f"chunk column {r[sir.SCOL_CHUNK]} contradicts branch "
                f"chunk {q}")
        if kind == sir.DECODE and j != 0:
            add("encoding", site,
                f"decode wave carries prefill lane {j}")
            continue
        if kind == sir.PREFILL and not 0 <= j < F:
            add("completeness", site,
                f"prefill lane {j} outside [0, {F})")
            continue
        if r[sir.SCOL_T] != _serve_tick(kind, j, q):
            add("encoding", site,
                f"tick {r[sir.SCOL_T]} off the staircase (expected "
                f"{_serve_tick(kind, j, q)})")
        if not rnd.event(kind, j, q, site):
            continue
        pool = dec if kind == sir.DECODE else pf
        a, b = r[sir.SCOL_A], r[sir.SCOL_B]
        if q == 0:
            if a != -1:
                add("encoding", site,
                    f"chunk-0 row carries a read slot A={a} (the first "
                    f"chunk embeds in-branch)")
        else:
            pool.read(a, (kind, j, q), site, free=True)
        if q < C - 1:
            pool.write(b, (kind, j, q + 1), site)
        elif b != -1:
            add("encoding", site,
                f"last-chunk row carries a write slot B={b} (the head "
                f"emits the token in-branch)")
    rnd.finish()
    for leak in dec.leftovers() + pf.leftovers():
        add("completeness", "round end", f"round leaves live {leak}")
    if dec.peak != table.n_dec_slots:
        add("resource-bound", "round end",
            f"verified peak decode-hidden liveness {dec.peak} != "
            f"allocated n_dec_slots {table.n_dec_slots}")
    if pf.peak != table.n_pf_slots:
        add("resource-bound", "round end",
            f"verified peak prefill-hidden liveness {pf.peak} != "
            f"allocated n_pf_slots {table.n_pf_slots}")
    return VerifyReport(
        artifact="serve_table", schedule="serve",
        n_events=int(rows.shape[0]), violations=tuple(viols),
        stats={"peak_dec": dec.peak, "peak_pf": pf.peak})


def verify_serve_streams(streams: sir.ServeStreams) -> VerifyReport:
    """Statically verify a
    :class:`~repro_torch.planner.schedule_ir.ServeStreams` artifact: per-tick
    re-simulation of every device's serve event against its *private*
    decode/prefill hidden pools, the two payload rings' send/receive
    matching, and the one-chunk-per-device placement.  Collects every
    violation; never raises."""
    viols: List[Violation] = []

    def add(check: str, site: str, msg: str) -> None:
        viols.append(Violation(check, site, msg))

    C, F, S = streams.n_chunks, streams.max_prefill, streams.n_devices
    rows = np.asarray(streams.rows)
    T = rows.shape[0]
    nb = len(streams.branches)          # arm nb is the NOP
    _check_serve_branches(streams.branches, C, add)
    if C != S:
        add("placement", "streams",
            f"serving folds one chunk per device; {C} chunks on "
            f"{S} devices")
    if rows.shape[1:] != (S, sir.SDN_COLS):
        add("encoding", "streams",
            f"rows shape {rows.shape} != (T, {S}, {sir.SDN_COLS})")
    if T != C + F:
        add("encoding", "streams",
            f"{T} ticks != the staircase's C + F = {C + F}")
    decs = [_Pool(f"dev{d} decode-hidden", streams.n_dec_slots, add)
            for d in range(S)]
    pfs = [_Pool(f"dev{d} prefill-hidden", streams.n_pf_slots, add)
           for d in range(S)]
    rnd = _ServeRound(C, F, add)
    n_events = 0

    for t in range(T):
        # -- phase 1: this tick's compute events, per device ------------
        sends_d: Dict[int, Tuple[str, Tuple[str, int, int]]] = {}
        sends_p: Dict[int, Tuple[str, Tuple[str, int, int]]] = {}
        for d in range(S):
            r = tuple(int(x) for x in rows[t, d])
            br = r[sir.SDCOL_BRANCH]
            site = f"tick {t}/dev {d}"
            if not 0 <= br <= nb:
                add("encoding", site,
                    f"branch id {br} outside [0, {nb}]")
                continue
            if br == nb:                # NOP arm
                if r[sir.SDCOL_A] != -1:
                    add("encoding", site,
                        f"idle row carries read slot A={r[sir.SDCOL_A]}")
                continue
            n_events += 1
            kind, q = streams.branches[br]
            j = r[sir.SDCOL_MB]
            site = f"tick {t}/dev {d} ({kind} j={j} q={q})"
            if q != d:
                add("placement", site,
                    f"chunk {q} lives on device {q} (serving is one "
                    f"chunk per device), scheduled on device {d}")
            if kind == sir.PREFILL and not 0 <= j < F:
                add("completeness", site,
                    f"prefill lane {j} outside [0, {F})")
                continue
            if kind == sir.DECODE and j != 0:
                add("encoding", site,
                    f"decode wave carries prefill lane {j}")
                continue
            if t != _serve_tick(kind, j, q):
                add("encoding", site,
                    f"tick {t} off the staircase (expected "
                    f"{_serve_tick(kind, j, q)})")
            if not rnd.event(kind, j, q, site):
                continue
            pool = decs[d] if kind == sir.DECODE else pfs[d]
            a = r[sir.SDCOL_A]
            if q == 0:
                if a != -1:
                    add("encoding", site,
                        f"chunk-0 row carries a read slot A={a} (the "
                        f"first chunk embeds in-branch)")
            else:
                pool.read(a, (kind, j, q), site, free=True)
            if q < C - 1:
                sends = sends_d if kind == sir.DECODE else sends_p
                sends[(d + 1) % S] = (site, (kind, j, q + 1))
        # -- phase 2: ring transfers land after every branch ran --------
        for d in range(S):
            r = tuple(int(x) for x in rows[t, d])
            site = f"tick {t}/dev {d}"
            for recv_col, sends, pool, ring in (
                    (sir.SDCOL_RECV_D, sends_d, decs[d], "decode"),
                    (sir.SDCOL_RECV_P, sends_p, pfs[d], "prefill")):
                slot = r[recv_col]
                sent = sends.pop(d, None)
                if slot < 0:
                    if sent is not None:
                        add("comm-mismatch", site,
                            f"{ring}-ring payload {_fmt(sent[1])} from "
                            f"{sent[0]} lands in the trash slot — its "
                            f"consumer will read a dead slot")
                    continue
                if sent is None:
                    add("comm-mismatch", site,
                        f"{ring}-ring receive armed into slot {slot} "
                        f"with no sender this tick — the slot is "
                        f"filled with ring garbage")
                    continue
                if slot >= pool.n:
                    add("comm-mismatch", site,
                        f"{ring}-ring payload {_fmt(sent[1])} parked "
                        f"in slot {slot} outside the live pool "
                        f"[0, {pool.n}) (the trash)")
                    continue
                pool.write(slot, sent[1], site)
        for sends, ring in ((sends_d, "decode"), (sends_p, "prefill")):
            for nd, (src, value) in sends.items():
                add("comm-mismatch", f"tick {t}/dev {nd}",
                    f"{ring}-ring payload {_fmt(value)} from {src} has "
                    f"no matching receive")
    rnd.finish()
    for pool in decs + pfs:
        for leak in pool.leftovers():
            add("completeness", "round end", f"round leaves live {leak}")
    peak_d = max((p.peak for p in decs), default=0)
    peak_p = max((p.peak for p in pfs), default=0)
    if peak_d != streams.n_dec_slots:
        add("resource-bound", "round end",
            f"verified per-device peak decode-hidden liveness {peak_d} "
            f"!= allocated n_dec_slots {streams.n_dec_slots}")
    if peak_p != streams.n_pf_slots:
        add("resource-bound", "round end",
            f"verified per-device peak prefill-hidden liveness {peak_p} "
            f"!= allocated n_pf_slots {streams.n_pf_slots}")
    return VerifyReport(
        artifact="serve_streams", schedule="serve", n_events=n_events,
        violations=tuple(viols),
        stats={"peak_dec": peak_d, "peak_pf": peak_p, "n_ticks": T})


def verify_request_trace(entries, *, n_slots: int, n_pages: int,
                         n_stages: Optional[int] = None,
                         complete: bool = True) -> VerifyReport:
    """Verify a continuous-batching scheduler's emitted event log
    (dicts with ``ev`` in {admit, decode, evict, reject}) against the
    serving invariants: page lifetime == request lifetime (pages come
    from the free set at admission and return exactly at eviction),
    one decode per live request per round over exactly the rounds
    ``admit+1 .. evict``, and no two live requests sharing a slot.
    With ``complete=True`` (a drained run) a still-live request at
    trace end is itself a page leak.  Never raises."""
    viols: List[Violation] = []

    def add(check: str, site: str, msg: str) -> None:
        viols.append(Violation(check, site, msg))

    live: Dict[object, Dict[str, object]] = {}
    slot_of: Dict[int, object] = {}
    held: Dict[int, Dict[int, object]] = {}   # stage -> page -> rid
    n_ev = 0
    for i, e in enumerate(entries):
        ev, r, rid = e.get("ev"), e.get("round"), e.get("rid")
        site = f"entry {i} ({ev} rid={rid} round={r})"
        if ev == "reject":
            continue
        n_ev += 1
        if ev == "admit":
            if rid in live:
                add("page-lifetime", site,
                    f"rid {rid} admitted twice (still live since round "
                    f"{live[rid]['admit']})")
                continue
            slot = e.get("slot")
            if not 0 <= slot < n_slots:
                add("slot-hazard", site,
                    f"slot {slot} outside [0, {n_slots})")
            elif slot in slot_of:
                add("slot-hazard", site,
                    f"slot {slot} already held by live rid "
                    f"{slot_of[slot]}")
            else:
                slot_of[slot] = rid
            pages = tuple(e.get("pages", ()))
            if n_stages is not None and len(pages) != n_stages:
                add("encoding", site,
                    f"{len(pages)} pages for {n_stages} stages")
            for st, p in enumerate(pages):
                if not 0 <= p < n_pages:
                    add("page-lifetime", site,
                        f"stage {st} page {p} outside [0, {n_pages})")
                    continue
                owner = held.setdefault(st, {}).get(p)
                if owner is not None:
                    add("page-lifetime", site,
                        f"stage {st} page {p} still held by live rid "
                        f"{owner} — an admission must draw from the "
                        f"free set")
                held[st][p] = rid
            live[rid] = {"slot": slot, "pages": pages,
                         "gen": e.get("gen_len"), "admit": r,
                         "decodes": []}
        elif ev == "decode":
            st = live.get(rid)
            if st is None:
                add("decode-once", site,
                    f"decode for rid {rid}, which is not live")
                continue
            if r in st["decodes"]:
                add("decode-once", site,
                    f"rid {rid} decodes twice in round {r}")
            st["decodes"].append(r)
            if e.get("slot") is not None and e["slot"] != st["slot"]:
                add("slot-hazard", site,
                    f"decode in slot {e['slot']} but rid {rid} was "
                    f"admitted into slot {st['slot']}")
        elif ev == "evict":
            st = live.pop(rid, None)
            if st is None:
                add("page-lifetime", site,
                    f"evict of rid {rid}, which is not live")
                continue
            slot_of.pop(st["slot"], None)
            for stg, p in enumerate(st["pages"]):
                if held.get(stg, {}).get(p) == rid:
                    del held[stg][p]
            want = list(range(st["admit"] + 1, r + 1))
            if st["decodes"] != want:
                want_s = (str(want) if want else
                          "(none: admitted and evicted in one round)")
                add("decode-once", site,
                    f"rid {rid} decoded in rounds {st['decodes']}, "
                    f"expected exactly once per live round: {want_s}")
            if st["gen"] is not None \
                    and len(st["decodes"]) != st["gen"] - 1:
                add("decode-once", site,
                    f"rid {rid} ran {len(st['decodes'])} decodes for "
                    f"gen_len {st['gen']} (the prefill emits the first "
                    f"token; decodes must be gen_len - 1)")
        else:
            add("encoding", site, f"unknown trace event {ev!r}")
    if complete:
        for rid, st in sorted(live.items(), key=lambda kv: str(kv[0])):
            add("page-lifetime", "trace end",
                f"rid {rid} still live (admitted round {st['admit']}, "
                f"never evicted) — its pages and slot leak")
    return VerifyReport(
        artifact="request_trace", schedule="serve", n_events=n_ev,
        violations=tuple(viols),
        stats={"live_at_end": len(live)})


def verify_serve_plan(plan, *, device_streams: bool = True
                      ) -> Tuple[VerifyReport, ...]:
    """Verify every compiled artifact of a
    :class:`~repro_torch.planner.api.ServePlan`.  Returns the reports without
    raising — :func:`check_serve_plan` is the raising wrapper."""
    reports = [verify_serve_table(plan.serve_table())]
    if device_streams:
        reports.append(verify_serve_streams(plan.serve_streams()))
    return tuple(reports)


def check_serve_plan(plan, *, device_streams: bool = True) -> None:
    """Raise :class:`VerificationError` if any of the serve plan's
    compiled artifacts fails static verification."""
    for report in verify_serve_plan(plan, device_streams=device_streams):
        report.raise_on_violation()


# ===========================================================================
# mutation harness: prove the checks have power
# ===========================================================================


def _replace_rows(artifact, rows: np.ndarray):
    return dataclasses.replace(artifact, rows=np.array(rows, np.int32))


def _table_rows(table) -> np.ndarray:
    return np.array(table.rows, np.int32)


def _find_row(table, pred) -> int:
    for i, r in enumerate(np.asarray(table.rows)):
        kind, q, s = table.branches[int(r[sir.COL_BRANCH])]
        if pred(i, kind, q, s, r):
            return i
    raise LookupError("no row matches the mutation predicate")


def mutation_catalog(table: sir.EventTable,
                     streams: sir.DeviceStreams
                     ) -> Iterator[Tuple[str, str, object]]:
    """Yield ``(name, check, corrupted_artifact)`` single-row
    corruptions of valid artifacts.  Each corruption models a concrete
    allocator/lowering bug; the verifier MUST flag every one with a
    violation of the named check class — the mutation tests and
    ``--self-test`` assert exactly that."""
    C, M = table.n_chunks, table.n_microbatches
    S = streams.n_devices
    nop = len(streams.branches)

    # ---- slot-hazard ----------------------------------------------------
    rows = _table_rows(table)
    i = _find_row(table, lambda i, k, q, s, r: k == sir.FWD and q > 0)
    rows[i, sir.COL_B] = rows[i, sir.COL_A]   # output overwrites stash
    yield "table/fwd-write-clobbers-stash", "slot-hazard", \
        _replace_rows(table, rows)

    bwd_of = {}
    for i, r in enumerate(np.asarray(table.rows)):
        kind, q, _s = table.branches[int(r[sir.COL_BRANCH])]
        if kind == sir.BWD:
            bwd_of.setdefault(q, []).append(i)
    q_two = next(q for q, ix in bwd_of.items() if len(ix) >= 2)
    i, j = bwd_of[q_two][0], bwd_of[q_two][1]
    rows = _table_rows(table)
    rows[i, sir.COL_A] = rows[j, sir.COL_A]   # reads another mb's stash
    yield "table/bwd-reads-other-mb-stash", "slot-hazard", \
        _replace_rows(table, rows)

    rows = _table_rows(table)
    i = _find_row(table, lambda i, k, q, s, r: k == sir.BWD and q > 0)
    rows[i, sir.COL_C] = table.n_cot_slots    # write escapes the pool
    yield "table/cot-write-outside-pool", "slot-hazard", \
        _replace_rows(table, rows)

    rows = _table_rows(table)
    i = _find_row(table, lambda i, k, q, s, r: k == sir.BWD
                  and q == C - 1)
    rows[i, sir.COL_B] = rows[i, sir.COL_A]   # head reads stash twice
    yield "table/head-reads-wrong-slot", "slot-hazard", \
        _replace_rows(table, rows)

    # ---- comm-mismatch (device streams) ---------------------------------
    def _find_cell(pred):
        arr = np.asarray(streams.rows)
        for t in range(arr.shape[0]):
            for d in range(S):
                if pred(t, d, arr[t, d]):
                    return t, d
        raise LookupError("no stream cell matches the mutation predicate")

    srows = np.array(streams.rows, np.int32)
    t, d = _find_cell(lambda t, d, r: r[sir.DCOL_RECV_F] >= 0)
    srows[t, d, sir.DCOL_RECV_F] = -1         # payload dropped to trash
    yield "streams/fwd-payload-to-trash", "comm-mismatch", \
        _replace_rows(streams, srows)

    srows = np.array(streams.rows, np.int32)
    t, d = _find_cell(lambda t, d, r: r[sir.DCOL_RECV_B] >= 0)
    srows[t, d, sir.DCOL_RECV_B] = -1
    yield "streams/bwd-payload-to-trash", "comm-mismatch", \
        _replace_rows(streams, srows)

    def _no_fwd_sender(t, d, _r):
        if _r[sir.DCOL_RECV_F] >= 0:
            return False
        src = np.asarray(streams.rows)[t, (d - 1) % S]
        br = int(src[sir.DCOL_BRANCH])
        if br >= nop:
            return True
        kind, q, _s = streams.branches[br]
        return not (kind == sir.FWD and q < C - 1)

    srows = np.array(streams.rows, np.int32)
    t, d = _find_cell(_no_fwd_sender)
    srows[t, d, sir.DCOL_RECV_F] = 0          # armed recv, no sender
    yield "streams/recv-armed-no-sender", "comm-mismatch", \
        _replace_rows(streams, srows)

    srows = np.array(streams.rows, np.int32)
    t, d = _find_cell(lambda t, d, r: r[sir.DCOL_RECV_F] >= 0)
    srows[t, d, sir.DCOL_RECV_F] = streams.n_val_slots  # park in trash
    yield "streams/payload-parked-in-trash", "comm-mismatch", \
        _replace_rows(streams, srows)

    # ---- wv-lag ---------------------------------------------------------
    for delta, tag, which in ((1, "plus-one", sir.FWD),
                              (-1, "minus-one", sir.BWD),
                              (7, "plus-seven", sir.BWD)):
        rows = _table_rows(table)
        i = _find_row(table, lambda i, k, q, s, r: k == which)
        rows[i, sir.COL_WV] += delta          # row lag contradicts branch
        yield f"table/wv-{tag}", "wv-lag", _replace_rows(table, rows)

    # ---- double-contribution --------------------------------------------
    rows = _table_rows(table)
    i = bwd_of[q_two][1]
    rows[i, sir.COL_FIRST_G] = 1              # marker fires twice
    yield "table/first-grad-twice", "double-contribution", \
        _replace_rows(table, rows)

    rows = _table_rows(table)
    i = bwd_of[q_two][0]
    rows[i, sir.COL_FIRST_G] = 0              # marker never fires
    yield "table/first-grad-missing", "double-contribution", \
        _replace_rows(table, rows)

    rows = _table_rows(table)
    i = bwd_of[C - 1][1]
    rows[i, sir.COL_FIRST_O] = 1              # head accumulator reset
    yield "table/head-first-twice", "double-contribution", \
        _replace_rows(table, rows)

    rows = _table_rows(table)
    i = bwd_of[0][0]
    rows[i, sir.COL_FIRST_E] = 0              # embed adds into garbage
    yield "table/embed-first-missing", "double-contribution", \
        _replace_rows(table, rows)

    # ---- completeness ---------------------------------------------------
    rows = _table_rows(table)
    i = _find_row(table, lambda i, k, q, s, r: k == sir.BWD)
    rows[i, sir.COL_MB] = (int(rows[i, sir.COL_MB]) + 1) % M
    yield "table/bwd-wrong-microbatch", "completeness", \
        _replace_rows(table, rows)

    rows = _table_rows(table)
    rows[1] = rows[0]                         # duplicated event row
    yield "table/duplicated-row", "completeness", \
        _replace_rows(table, rows)

    srows = np.array(streams.rows, np.int32)
    t, d = _find_cell(lambda t, d, r: r[sir.DCOL_BRANCH] < nop)
    srows[t, d, :] = -1                       # event dropped to a NOP
    srows[t, d, sir.DCOL_BRANCH] = nop
    srows[t, d, sir.DCOL_MB] = 0
    srows[t, d, sir.DCOL_FIRST_G] = 0
    srows[t, d, sir.DCOL_FIRST_O] = 0
    srows[t, d, sir.DCOL_FIRST_E] = 0
    yield "streams/event-dropped", "completeness", \
        _replace_rows(streams, srows)

    # ---- placement (device streams) -------------------------------------
    if S > 1:
        arr = np.asarray(streams.rows)
        wrong = next(
            (t, d, b) for t in range(arr.shape[0]) for d in range(S)
            for b, (k, q, s) in enumerate(streams.branches)
            if arr[t, d, sir.DCOL_BRANCH] == nop and q % S != d)
        t, d, b = wrong
        srows = np.array(streams.rows, np.int32)
        srows[t, d, sir.DCOL_BRANCH] = b      # chunk on a foreign device
        srows[t, d, sir.DCOL_MB] = 0
        srows[t, d, sir.DCOL_A] = 0
        yield "streams/chunk-on-wrong-device", "placement", \
            _replace_rows(streams, srows)


def self_test(plan) -> Tuple[int, List[str]]:
    """Run the mutation harness over a plan's artifacts: every
    catalogued corruption must be flagged with its named check class.
    Returns ``(n_mutations, failures)``."""
    table, streams = plan.event_table(), plan.device_streams()
    kw = dict(schedule=plan.schedule, act_stash=plan.act_stash,
              w_stash_depth=plan.w_stash_depth)
    failures: List[str] = []
    n = 0
    for name, check, bad in mutation_catalog(table, streams):
        n += 1
        if isinstance(bad, sir.EventTable):
            report = verify_event_table(bad, **kw)
        else:
            report = verify_device_streams(bad, **kw)
        got = {v.check for v in report.violations}
        if check not in got:
            failures.append(
                f"{name}: expected a {check!r} violation, got "
                f"{sorted(got) or 'a clean report'}")
    return n, failures


def serve_mutation_catalog(table: sir.ServeTable,
                           streams: sir.ServeStreams
                           ) -> Iterator[Tuple[str, str, object]]:
    """Single-row corruptions of valid serving artifacts, mirroring
    :func:`mutation_catalog` — each models a concrete serve-lowering
    bug the verifier MUST flag with the named check class.  Needs
    ``max_prefill >= 2`` and ``n_chunks >= 3`` so both pools and the
    ring have room for the interesting corruptions."""
    C, F, S = table.n_chunks, table.max_prefill, streams.n_devices
    nop = len(streams.branches)

    def _find_srow(pred) -> int:
        for i, r in enumerate(np.asarray(table.rows)):
            kind, q = table.branches[int(r[sir.SCOL_BRANCH])]
            if pred(i, kind, q, r):
                return i
        raise LookupError("no serve row matches the mutation predicate")

    # ---- slot-hazard ----------------------------------------------------
    rows = _table_rows(table)
    i = _find_srow(lambda i, k, q, r: k == sir.PREFILL and q > 0)
    rows[i, sir.SCOL_A] = (int(rows[i, sir.SCOL_A]) + 1) \
        % max(table.n_pf_slots, 2)            # reads another lane's slot
    yield "serve-table/pf-reads-wrong-slot", "slot-hazard", \
        _replace_rows(table, rows)

    rows = _table_rows(table)
    i = _find_srow(lambda i, k, q, r: k == sir.PREFILL and q < C - 1)
    rows[i, sir.SCOL_B] = table.n_pf_slots    # write escapes the pool
    yield "serve-table/pf-write-outside-pool", "slot-hazard", \
        _replace_rows(table, rows)

    # ---- decode-once ----------------------------------------------------
    rows = _table_rows(table)
    dec_ix = [i for i, r in enumerate(np.asarray(table.rows))
              if table.branches[int(r[sir.SCOL_BRANCH])][0] == sir.DECODE]
    rows[dec_ix[1]] = rows[dec_ix[0]]         # chunk decoded twice
    yield "serve-table/decode-twice", "decode-once", \
        _replace_rows(table, rows)

    # ---- encoding -------------------------------------------------------
    rows = _table_rows(table)
    rows[0, sir.SCOL_T] += 1                  # off the staircase
    yield "serve-table/tick-off-staircase", "encoding", \
        _replace_rows(table, rows)

    # ---- comm-mismatch (serve streams) ----------------------------------
    def _find_cell(pred):
        arr = np.asarray(streams.rows)
        for t in range(arr.shape[0]):
            for d in range(S):
                if pred(t, d, arr[t, d]):
                    return t, d
        raise LookupError("no serve cell matches the mutation predicate")

    srows = np.array(streams.rows, np.int32)
    t, d = _find_cell(lambda t, d, r: r[sir.SDCOL_RECV_D] >= 0)
    srows[t, d, sir.SDCOL_RECV_D] = -1        # payload dropped to trash
    yield "serve-streams/decode-payload-to-trash", "comm-mismatch", \
        _replace_rows(streams, srows)

    srows = np.array(streams.rows, np.int32)
    t, d = _find_cell(
        lambda t, d, r: d > 0 and r[sir.SDCOL_RECV_P] < 0
        and np.asarray(streams.rows)[t, d - 1, sir.SDCOL_BRANCH] == nop)
    srows[t, d, sir.SDCOL_RECV_P] = 0         # armed recv, no sender
    yield "serve-streams/recv-armed-no-sender", "comm-mismatch", \
        _replace_rows(streams, srows)

    # ---- completeness ---------------------------------------------------
    srows = np.array(streams.rows, np.int32)
    t, d = _find_cell(lambda t, d, r: r[sir.SDCOL_BRANCH] < nop)
    srows[t, d, sir.SDCOL_BRANCH] = nop       # event dropped to a NOP
    srows[t, d, sir.SDCOL_MB] = 0
    srows[t, d, sir.SDCOL_A] = -1
    yield "serve-streams/event-dropped", "completeness", \
        _replace_rows(streams, srows)

    # ---- placement (serve streams) --------------------------------------
    if S > 1:
        arr = np.asarray(streams.rows)
        t, d, b = next(
            (t, d, b) for t in range(arr.shape[0]) for d in range(S)
            for b, (k, q) in enumerate(streams.branches)
            if arr[t, d, sir.SDCOL_BRANCH] == nop and q != d)
        srows = np.array(streams.rows, np.int32)
        srows[t, d, sir.SDCOL_BRANCH] = b     # chunk on a foreign device
        srows[t, d, sir.SDCOL_MB] = 0
        srows[t, d, sir.SDCOL_A] = -1
        yield "serve-streams/chunk-on-wrong-device", "placement", \
            _replace_rows(streams, srows)


def serve_self_test(plan) -> Tuple[int, List[str]]:
    """Run the serve mutation harness over a
    :class:`~repro_torch.planner.api.ServePlan`'s artifacts.  Returns
    ``(n_mutations, failures)``; see :func:`self_test`."""
    table, streams = plan.serve_table(), plan.serve_streams()
    failures: List[str] = []
    n = 0
    for name, check, bad in serve_mutation_catalog(table, streams):
        n += 1
        if isinstance(bad, sir.ServeTable):
            report = verify_serve_table(bad)
        else:
            report = verify_serve_streams(bad)
        got = {v.check for v in report.violations}
        if check not in got:
            failures.append(
                f"{name}: expected a {check!r} violation, got "
                f"{sorted(got) or 'a clean report'}")
    return n, failures


# ===========================================================================
# CLI
# ===========================================================================

GRID_SCHEDULES = ("1f1b", "2bw", "interleaved", "gpipe")
GRID_STAGES = (2, 3, 4)
GRID_PARTITIONS = ("uniform", "ragged")
GRID_POLICIES = ("spectrain", "pipedream")


def _grid_plan(schedule: str, n_stages: int, partition: str):
    """One grid cell's plan: ragged cells use a skewed synthetic layer
    profile so the DP partitioner emits genuinely non-uniform stage
    sizes (the partition is carried by the plan and validated by the
    runtimes; the compiled round artifacts depend on schedule/S/v/M)."""
    from repro_torch.planner import api, profiler
    v = 2 if schedule == "interleaved" else 1
    n_chunks = n_stages * v
    n_layers = 2 * n_chunks
    if partition == "ragged":
        costs = [1.0 + 0.5 * (i % 3) for i in range(n_layers)]
        prof = profiler.synthetic_profile(costs)
        return api.plan(None, n_stages=n_stages, schedule=schedule,
                        virtual_stages=v, partitioner="dp", profile=prof)
    return api.plan(None, n_stages=n_stages, schedule=schedule,
                    virtual_stages=v, n_layers=n_layers)


def iter_grid():
    """Yield ``(label, plan)`` over the CI verify grid:
    {1f1b, 2bw, interleaved, gpipe} x S in {2, 3, 4} x
    {uniform, ragged DP} x {spectrain, pipedream}.  The policy axis
    does not change the compiled artifacts (the wv lag is
    schedule-derived; the policy decides whether the runtime predicts
    across it) but keeps the verified surface aligned with what the
    runtimes execute."""
    for schedule in GRID_SCHEDULES:
        for n_stages in GRID_STAGES:
            for partition in GRID_PARTITIONS:
                plan = _grid_plan(schedule, n_stages, partition)
                for policy in GRID_POLICIES:
                    yield (f"{schedule}/S{n_stages}/{partition}/{policy}",
                           plan)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.planner.verify",
        description="statically verify compiled pipeline schedules")
    ap.add_argument("--schedule", default="1f1b",
                    choices=sir.ROUND_SCHEDULES)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--virtual-stages", type=int, default=1,
                    dest="virtual_stages")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--ragged", action="store_true",
                    help="skewed synthetic profile + DP partitioner")
    ap.add_argument("--serve", action="store_true",
                    help="verify a serving round (ServeTable + "
                         "ServeStreams) instead of a training plan")
    ap.add_argument("--prefill", type=int, default=2,
                    help="serving: prefill lanes per round")
    ap.add_argument("--grid", action="store_true",
                    help="verify the full CI grid instead of one plan")
    ap.add_argument("--self-test", action="store_true", dest="self_test",
                    help="run the mutation harness (every catalogued "
                         "single-row corruption must be flagged)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.planner import api, profiler

    def one(label, plan) -> int:
        reports = verify_plan(plan)
        bad = [v for r in reports for v in r.violations]
        n_ev = sum(r.n_events for r in reports)
        if not args.quiet or bad:
            status = "FAIL" if bad else "ok"
            print(f"{label}: {status} ({len(reports)} artifacts, "
                  f"{n_ev} events)")
        for v in bad:
            print(f"  {v}")
        return len(bad)

    failures = 0
    if args.serve:
        splan = api.serve_plan(
            None, n_stages=args.stages, max_prefill=args.prefill,
            n_layers=args.layers or 2 * args.stages, validate=False)
        reports = verify_serve_plan(splan)
        bad = [v for r in reports for v in r.violations]
        n_ev = sum(r.n_events for r in reports)
        status = "FAIL" if bad else "ok"
        print(f"serve/S{args.stages}F{args.prefill}: {status} "
              f"({len(reports)} artifacts, {n_ev} events)")
        for v in bad:
            print(f"  {v}")
        failures += len(bad)
        if args.self_test:
            n, fails = serve_self_test(splan)
            print(f"serve mutation self-test: {n - len(fails)}/{n} "
                  f"corruptions flagged")
            for f in fails:
                print(f"  MISSED {f}")
            failures += len(fails)
        return 1 if failures else 0
    if args.grid:
        n = 0
        for label, plan in iter_grid():
            failures += one(label, plan)
            n += 1
        print(f"verify-grid: {n} cells, "
              f"{'all clean' if not failures else f'{failures} violations'}")
    else:
        v = args.virtual_stages
        kw = {}
        if args.microbatches:
            kw["n_microbatches"] = args.microbatches
        if args.ragged:
            C = args.stages * v
            L = args.layers or 2 * C
            costs = [1.0 + 0.5 * (i % 3) for i in range(L)]
            plan = api.plan(None, n_stages=args.stages,
                            schedule=args.schedule, virtual_stages=v,
                            partitioner="dp",
                            profile=profiler.synthetic_profile(costs),
                            **kw)
        else:
            plan = api.plan(None, n_stages=args.stages,
                            schedule=args.schedule, virtual_stages=v,
                            n_layers=args.layers or 2 * args.stages * v,
                            **kw)
        label = f"{plan.schedule}/S{plan.n_stages}" + \
            (f"v{v}" if v > 1 else "")
        failures += one(label, plan)
        if args.self_test:
            n, fails = self_test(plan)
            print(f"mutation self-test: {n - len(fails)}/{n} "
                  f"corruptions flagged")
            for f in fails:
                print(f"  MISSED {f}")
            failures += len(fails)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
