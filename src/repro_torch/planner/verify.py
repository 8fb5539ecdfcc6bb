"""Static verifier of the serving round (twin of the serving half of
``repro/planner/verify.py``).

Re-simulates the compiled artifacts of ``planner/schedule_ir`` with
symbolic value ids against an independent model of what each event must
read, write, free and send, and collects every violation, grouped into
check classes (the ``check`` field of each :class:`Violation`; the
training classes of the JAX twin come with the planner slice):

``slot-hazard``
    every slot read is dominated by a write of the matching value, no
    write clobbers a live value, and no slot reference escapes its pool.
``comm-mismatch``
    every tick's ring send pairs with an armed receive on the right
    neighbour, and no armed receive lacks a sender.
``completeness``
    every lane visits every chunk exactly once, in order, and the round
    ends with no value in flight.
``resource-bound``
    the verified peak liveness equals the allocator's pool sizes.
``placement``
    chunk q's events run on device q (serving is one chunk per device).
``encoding``
    row columns agree with their branch spec and the staircase ticks.
``decode-once``
    the decode wave visits every chunk exactly once per round, and every
    live request decodes exactly once per round over its lifetime.
``page-lifetime``
    a request's KV pages come from the free set at admission, are held
    for its whole lifetime and return exactly at eviction.

Entry points: :func:`verify_serve_table`, :func:`verify_serve_streams`,
:func:`verify_request_trace` (each returns a :class:`VerifyReport`),
:func:`verify_serve_plan` / :func:`check_serve_plan` (plan-level, the
latter raising), and a mutation harness (:func:`serve_mutation_catalog`,
:func:`serve_self_test`) proving the checks have power.  Pure numpy,
copied from the JAX package.
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



def serve_mutation_catalog(table: sir.ServeTable,
                           streams: sir.ServeStreams
                           ) -> Iterator[Tuple[str, str, object]]:
    """Single-row corruptions of valid serving artifacts (the JAX
    twin's training ``mutation_catalog`` has the same form) — each
    models a concrete serve-lowering
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
    ``(n_mutations, failures)``: each failure names a mutation whose
    report lacks its check class."""
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
