"""Event-timeline IR for pipeline schedules (twin of
``repro/planner/schedule_ir.py``; pure numpy, copied from the JAX
package).

A :class:`Schedule` is an ordered list of typed events — ``fwd``/``bwd``
compute events and ``update`` events (each update names the stages whose
weights it touches and the minibatches whose gradients it applies).  Time
is discrete: events carry a tick ``t`` plus a deterministic sub-tick order
(fwd by ascending stage, then bwd by descending stage, then updates), so
every weight read happens before the same tick's weight writes.

Six emitters: :func:`round_robin_1f1b` (the paper's §3.1 schedule),
:func:`gpipe` (fill/drain, one accumulated update a round),
:func:`streaming` (the tick schedule of ``core/pipeline_stream.py``),
:func:`one_f_one_b` (PipeDream-flush), :func:`pipedream_2bw`
(double-buffered weights, every read pinned one version back) and
:func:`interleaved_1f1b` (Megatron's virtual stages: device ``d`` holds
chunk-stages ``d, d+S, …``).

Weight-version differences are **derived**, not assumed:
:meth:`Schedule.staleness` counts the update events landing on a stage's
weights between a minibatch's weight read and that minibatch's own
gradient apply, so the closed forms of ``core/spectrain.py`` become
checked properties of the emitters.  Bubble fraction, activation stash
and weight-stash depth come from the same timeline.

One round of a round schedule lowers to a dense int32
:class:`EventTable` (:func:`round_compute_program` →
:func:`compile_event_table`), which the ``"scan"`` backend of
``core/pipeline_stream.py``'s IR interpreter runs row by row, and to
per-device :class:`DeviceStreams` (:func:`compile_device_streams`),
compiled and verified here: stage-local execution is a later slice of
the port.  A serving round (one decode wave plus prefill lanes) lowers
to the :class:`ServeTable` that ``serve/engine.py``'s ``ServeEngine``
interprets and to per-device :class:`ServeStreams`.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

FWD, BWD, UPDATE = "fwd", "bwd", "update"
_KIND_RANK = {FWD: 0, BWD: 1, UPDATE: 2}


@dataclass(frozen=True)
class Event:
    """One schedule event.

    ``stage``/``mb`` identify compute events; update events instead carry
    ``stages`` (weights written) and ``mbs`` (gradients applied) and keep
    ``stage = mb = -1``.  A compute event may pin its weight read to a
    specific version ``wv`` (the number of updates already applied to its
    stage's weights); ``wv = None`` means "read whatever is current" —
    the only read semantic the pre-2BW emitters needed.
    """
    kind: str
    t: int
    stage: int = -1
    mb: int = -1
    stages: Tuple[int, ...] = ()
    mbs: Tuple[int, ...] = ()
    wv: Optional[int] = None

    def sort_key(self):
        rank = _KIND_RANK[self.kind]
        # fwd consumes activations from the previous stage (ascending);
        # bwd consumes cotangents from the next stage (descending).
        sub = self.stage if self.kind == FWD else -self.stage
        return (self.t, rank, sub)


@dataclass
class Schedule:
    """Event timeline for ``n_stages`` logical pipeline stages.

    ``n_devices`` is the number of physical devices executing them
    (``None`` → one device per stage).  Interleaved/virtual-stage
    schedules set ``n_devices < n_stages``: device ``d`` hosts the
    chunk-stages ``{q : q % n_devices == d}`` (Megatron's round-robin
    chunk placement), and at most one compute event per device runs per
    tick.  Emitters of round-based schedules also set
    ``round_microbatches`` — the number of microbatches per flush round
    (1F1B, GPipe, interleaved) or per accumulation group (2BW)."""
    name: str
    n_stages: int
    events: List[Event] = field(default_factory=list)
    n_devices: Optional[int] = None
    round_microbatches: int = 0

    def __post_init__(self):
        self.events = sorted(self.events, key=Event.sort_key)
        self._index: Dict[Tuple[str, int, int], int] = {}
        self._own_update: Dict[Tuple[int, int], int] = {}
        self._ver_prefix: Dict[int, List[int]] = {}
        for i, e in enumerate(self.events):
            if e.kind == UPDATE:
                for k in e.stages:
                    for m in e.mbs:
                        self._own_update[(m, k)] = i
            else:
                self._index[(e.kind, e.mb, e.stage)] = i

    # ------------------------------------------------------------ queries
    def makespan(self) -> int:
        return max(e.t for e in self.events) + 1 if self.events else 0

    def minibatches(self) -> Tuple[int, ...]:
        return tuple(sorted({e.mb for e in self.events if e.kind == FWD}))

    def device_of(self, stage: int) -> int:
        """Physical device hosting a (chunk-)stage."""
        return stage % (self.n_devices or self.n_stages)

    def _versions(self, stage: int) -> List[int]:
        """Prefix counts: versions[i] = #updates on ``stage`` in
        events[:i] (cached — version_at is hot in metric derivation)."""
        if stage not in self._ver_prefix:
            pre = [0]
            for e in self.events:
                pre.append(pre[-1] + (1 if e.kind == UPDATE
                                      and stage in e.stages else 0))
            self._ver_prefix[stage] = pre
        return self._ver_prefix[stage]

    def version_at(self, event_idx: int, stage: int) -> int:
        """#updates touching ``stage``'s weights strictly before an event."""
        return self._versions(stage)[event_idx]

    def read_version(self, event_idx: int, stage: int) -> int:
        """Weight version a compute event reads: its pinned ``wv`` when
        the schedule dictates one, else the current version."""
        e = self.events[event_idx]
        if e.kind != UPDATE and e.wv is not None:
            return e.wv
        return self.version_at(event_idx, stage)

    def complete_minibatches(self) -> Tuple[int, ...]:
        """Minibatches with fwd+bwd on every stage and an applied update."""
        out = []
        for m in self.minibatches():
            ok = all((FWD, m, k) in self._index and (BWD, m, k) in self._index
                     for k in range(self.n_stages))
            ok = ok and all((m, k) in self._own_update
                            for k in range(self.n_stages))
            if ok:
                out.append(m)
        return tuple(out)

    def steady_minibatch(self) -> int:
        """A minibatch past warm-up (reads never truncated to version 0).

        The closed forms of ``core/spectrain.py`` describe steady state;
        early minibatches read the initial weights more often than the
        formulas say.  Any complete minibatch injected after the pipeline
        has filled (index ≥ 2·N) is in steady state for every schedule
        emitted here.
        """
        complete = self.complete_minibatches()
        if not complete:
            raise ValueError(f"{self.name}: no complete minibatch in IR")
        steady = [m for m in complete if m >= 2 * self.n_stages]
        if not steady:
            raise ValueError(
                f"{self.name}: timeline too short for steady state "
                f"(complete={complete[:4]}...); emit more minibatches")
        return steady[len(steady) // 2]

    # ---------------------------------------------------------- staleness
    def staleness(self, stage: int, phase: str, mb: Optional[int] = None
                  ) -> int:
        """Derived weight-version difference s for (stage, phase).

        s = #updates landing on ``stage``'s weights between the weight
        read of minibatch ``mb``'s fwd/bwd event and ``mb``'s own
        gradient-apply on that stage — the generic form of the paper's
        Eqs. 5–6.
        """
        if phase not in ("forward", "backward"):
            raise ValueError(phase)
        if not 0 <= stage < self.n_stages:
            raise ValueError(f"stage {stage} out of range for "
                             f"{self.n_stages} stages")
        if mb is None:
            mb = self.steady_minibatch()
        kind = FWD if phase == "forward" else BWD
        read = self._index.get((kind, mb, stage))
        own = self._own_update.get((mb, stage))
        if read is None or own is None:
            raise ValueError(f"minibatch {mb} incomplete on stage {stage}")
        return self.version_at(own, stage) - self.read_version(read, stage)

    def staleness_vector(self, phase: str, mb: Optional[int] = None
                         ) -> Tuple[int, ...]:
        if mb is None:
            mb = self.steady_minibatch()
        return tuple(self.staleness(k, phase, mb)
                     for k in range(self.n_stages))

    def bwd_lag(self, stage: int, mb: Optional[int] = None) -> int:
        """Ticks between a minibatch's injection (stage-0 forward) and its
        stage-k backward — how long gradients for stage k are in flight."""
        if mb is None:
            mb = self.steady_minibatch()
        bwd = self._index.get((BWD, mb, stage))
        fwd0 = self._index.get((FWD, mb, 0))
        if bwd is None or fwd0 is None:
            raise ValueError(f"minibatch {mb} incomplete on stage {stage}")
        return self.events[bwd].t - self.events[fwd0].t

    def fwd_bwd_gap(self, stage: int, mb: Optional[int] = None) -> int:
        """Ticks between a minibatch's stage-k forward and its stage-k
        backward — how long stage k must stash that minibatch's input
        activation (the streaming runtime's ring gather offset)."""
        if mb is None:
            mb = self.steady_minibatch()
        bwd = self._index.get((BWD, mb, stage))
        fwd = self._index.get((FWD, mb, stage))
        if bwd is None or fwd is None:
            raise ValueError(f"minibatch {mb} incomplete on stage {stage}")
        return self.events[bwd].t - self.events[fwd].t

    # ------------------------------------------------------------ metrics
    def bubble_fraction(self) -> float:
        """Idle fraction of device·tick slots over the whole timeline —
        the schedule-family cost axis (1F1B pays (S−1)/(M+S−1) per
        round, interleaved (S−1)/(M·v+S−1), streaming ~0 past warm-up).

        Slot width per tick is inferred as the peak per-(device, tick)
        occupancy: the unit-time emitters (streaming, round-robin) fit
        one fwd + one bwd per time unit, the list-scheduled families one
        op per tick."""
        D = self.n_devices or self.n_stages
        per_slot: Dict[Tuple[int, int], int] = {}
        for e in self.events:
            if e.kind == UPDATE:
                continue
            key = (self.device_of(e.stage), e.t)
            per_slot[key] = per_slot.get(key, 0) + 1
        if not per_slot:
            return 0.0
        width = max(per_slot.values())
        busy = sum(per_slot.values())
        return 1.0 - busy / (D * self.makespan() * width)

    def peak_activation_stash(self, stage: int) -> int:
        """Max #microbatches simultaneously holding a stashed input
        activation on ``stage`` (forward issued, backward not yet done) —
        the activation-memory axis: M for GPipe, S−k for 1F1B."""
        cur = peak = 0
        for e in self.events:
            if e.stage != stage:
                continue
            if e.kind == FWD:
                cur += 1
                peak = max(peak, cur)
            elif e.kind == BWD:
                cur -= 1
        return peak

    def weight_stash_depth(self, stage: int) -> int:
        """Weight versions ``stage`` must retain: 1 + the max distance
        between an event's current version and the (possibly pinned)
        version it reads.  1 for every always-read-current schedule,
        2 for 2BW's double buffering — the runtime sizes its weight
        rings from this instead of a hardcoded constant."""
        depth = 1
        for i, e in enumerate(self.events):
            if e.kind == UPDATE or e.stage != stage:
                continue
            lag = self.version_at(i, stage) - self.read_version(i, stage)
            depth = max(depth, lag + 1)
        return depth

    # ----------------------------------------------------------- validity
    def validate(self) -> None:
        """Dataflow sanity: activations and cotangents exist when read.

        * fwd(m, k) strictly after fwd(m, k−1)
        * bwd(m, N−1) strictly after fwd(m, N−1)
        * bwd(m, k) strictly after bwd(m, k+1)
        * m's update on stage k strictly after bwd(m, k)
        * every update references an emitted fwd and bwd for each
          (minibatch, stage) it applies — a gradient with no backward
          is a malformed timeline, not an incomplete one
        * a pinned read version exists when read (wv ≤ current version)
        * at most one compute event per (device, kind) per tick — the
          unit-time emitters (streaming, round-robin) model a time unit
          as one fwd slot plus one bwd slot
        """
        N = self.n_stages
        for i, e in enumerate(self.events):
            if e.kind != UPDATE:
                continue
            for k in e.stages:
                for m in e.mbs:
                    for kind in (FWD, BWD):
                        j = self._index.get((kind, m, k))
                        if j is None:
                            raise ValueError(
                                f"{self.name}: update at t={e.t} applies "
                                f"minibatch {m} on stage {k} with no "
                                f"{kind}({m},{k}) event")
                        if kind == BWD and not j < i:
                            raise ValueError(
                                f"{self.name}: update of {m} before "
                                f"bwd({m},{k})")
        for m in self.complete_minibatches():
            f = [self._index[(FWD, m, k)] for k in range(N)]
            b = [self._index[(BWD, m, k)] for k in range(N)]
            for k in range(1, N):
                if not f[k - 1] < f[k]:
                    raise ValueError(
                        f"{self.name}: fwd({m},{k}) before fwd({m},{k-1})")
            if not f[N - 1] < b[N - 1]:
                raise ValueError(f"{self.name}: bwd({m}) before fwd({m})")
            for k in range(N - 1):
                if not b[k + 1] < b[k]:
                    raise ValueError(
                        f"{self.name}: bwd({m},{k}) before bwd({m},{k+1})")
            for k in range(N):
                if not b[k] < self._own_update[(m, k)]:
                    raise ValueError(
                        f"{self.name}: update of {m} before bwd({m},{k})")
        busy: Dict[Tuple[int, int, str], Tuple[str, int]] = {}
        for i, e in enumerate(self.events):
            if e.kind == UPDATE:
                continue
            if e.wv is not None and e.wv > self.version_at(i, e.stage):
                raise ValueError(
                    f"{self.name}: {e.kind}({e.mb},{e.stage}) pins "
                    f"version {e.wv}, only "
                    f"{self.version_at(i, e.stage)} exist")
            slot = (self.device_of(e.stage), e.t, e.kind)
            if slot in busy:
                raise ValueError(
                    f"{self.name}: device {slot[0]} double-booked at "
                    f"t={e.t}: {busy[slot]} and ({e.kind},{e.mb})")
            busy[slot] = (e.kind, e.mb)

    # ------------------------------------------------------------- render
    def render(self, max_ticks: int = 24) -> str:
        """ASCII timeline: one row per *device*, ``f<mb>``/``b<mb>``
        cells.  With virtual stages (n_devices < n_stages) a cell is
        ``f<mb>.<c>`` where ``c`` is the device-local chunk index."""
        D = self.n_devices or self.n_stages
        v = self.n_stages // D
        grid: Dict[Tuple[int, int], List[str]] = {}
        for e in self.events:
            if e.kind == UPDATE:
                for k in e.stages:
                    grid.setdefault((self.device_of(k), e.t), []).append("u")
            else:
                cell = f"{e.kind[0]}{e.mb}"
                if v > 1:
                    cell += f".{e.stage // D}"
                grid.setdefault((self.device_of(e.stage), e.t),
                                []).append(cell)
        T = min(self.makespan(), max_ticks)
        width = max([len("+".join(grid.get((d, t), [])))
                     for d in range(D) for t in range(T)] + [2])
        rows = []
        for d in range(D):
            cells = ["+".join(grid.get((d, t), [])).ljust(width)
                     for t in range(T)]
            rows.append(f"d{d} |" + "|".join(cells) + "|")
        return "\n".join(rows)


# ===========================================================================
# emitters
# ===========================================================================


def _default_mbs(n_stages: int) -> int:
    # enough for fill, a steady-state region past 2N, and drain
    return 6 * n_stages + 4


def round_robin_1f1b(n_stages: int, n_minibatches: Optional[int] = None
                     ) -> Schedule:
    """The paper's round-robin schedule (§3.1, Figs. 4/7).

    Each time unit every GPU runs one forward and one backward slot;
    minibatch i runs fwd on stage k at unit ``i + ⌈k/2⌉`` and bwd at unit
    ``i + N − 1 − ⌊k/2⌋``; its round trip completes in N−1 units and its
    gradient updates all stages at the end of unit ``i + N − 1`` (one
    global weight version per unit).
    """
    N = n_stages
    M = n_minibatches or _default_mbs(N)
    ev: List[Event] = []
    all_stages = tuple(range(N))
    for i in range(M):
        for k in range(N):
            ev.append(Event(FWD, i + (k + 1) // 2, stage=k, mb=i))
            ev.append(Event(BWD, i + N - 1 - k // 2, stage=k, mb=i))
        ev.append(Event(UPDATE, i + N - 1, stages=all_stages, mbs=(i,)))
    return Schedule("1f1b_rr", N, ev)


def gpipe(n_stages: int, n_microbatches: Optional[int] = None,
          n_rounds: int = 3) -> Schedule:
    """GPipe fill/drain: all microbatches forward, then all backward, then
    one accumulated update — staleness-free (s_fwd = s_bwd = 0) at the
    cost of a 2(N−1)-slot bubble per round."""
    N = n_stages
    M = n_microbatches or max(2, 2 * N)
    ev: List[Event] = []
    all_stages = tuple(range(N))
    span = 2 * (M + N - 1) + 1
    for r in range(n_rounds):
        base = r * span
        mbs = tuple(r * M + m for m in range(M))
        for m in range(M):
            for k in range(N):
                ev.append(Event(FWD, base + m + k, stage=k, mb=r * M + m))
                ev.append(Event(
                    BWD, base + (M + N - 1) + (M - 1 - m) + (N - 1 - k),
                    stage=k, mb=r * M + m))
        ev.append(Event(UPDATE, base + span - 1, stages=all_stages, mbs=mbs))
    return Schedule("gpipe", N, ev, round_microbatches=M)


def streaming(n_stages: int, n_ticks: Optional[int] = None) -> Schedule:
    """The streaming tick schedule (``core/pipeline_stream.py``).

    Per tick t, stage k forwards the minibatch injected k ticks ago and
    backwards the one injected 2(N−1)−k ticks ago, then applies that
    minibatch's gradient to **its own** weights — per-stage, per-tick
    updates (minibatch id == injection tick).
    """
    N = n_stages
    T = n_ticks or (_default_mbs(N) + 2 * (N - 1))
    ev: List[Event] = []
    for t in range(T):
        for k in range(N):
            if t - k >= 0:
                ev.append(Event(FWD, t, stage=k, mb=t - k))
            mb_b = t - 2 * (N - 1) + k
            if mb_b >= 0 and mb_b <= t:
                ev.append(Event(BWD, t, stage=k, mb=mb_b))
                ev.append(Event(UPDATE, t, stages=(k,), mbs=(mb_b,)))
    return Schedule("stream", N, ev)


# ---------------------------------------------------------------------------
# 1F1B family: PipeDream-flush, PipeDream-2BW, Megatron interleaved.
#
# All three share one construction: a fixed Megatron-style op order per
# device (warm-up forwards, steady fwd/bwd alternation, cool-down
# backwards) turned into a tick timeline by deterministic list
# scheduling — each tick, each device runs its next op iff the op's
# dataflow inputs were produced at a strictly earlier tick.


def _device_op_order(S: int, v: int, M: int, d: int
                     ) -> List[Tuple[str, int, int]]:
    """Op sequence ``(kind, mb, chunk_stage)`` for device ``d`` over one
    round of ``M`` microbatches across ``v`` chunks per device.

    Chunk-stage ``q = c·S + d`` is device ``d``'s ``c``-th chunk
    (Megatron placement); forwards walk microbatches in groups of S per
    chunk, backwards the same groups with chunks reversed.  Warm-up
    depth is Megatron's: S−d−1 for v = 1, else 2(S−d−1) + (v−1)·S.
    """
    n = M * v

    def fwd_op(i):
        if v == 1:
            mb, c = i, 0
        else:
            g, r = divmod(i, S * v)
            c, mb = r // S, g * S + r % S
        return (FWD, mb, c * S + d)

    def bwd_op(j):
        if v == 1:
            mb, c = j, 0
        else:
            g, r = divmod(j, S * v)
            c, mb = v - 1 - r // S, g * S + r % S
        return (BWD, mb, c * S + d)

    warmup = min(n, (S - d - 1) if v == 1 else 2 * (S - d - 1) + (v - 1) * S)
    ops = [fwd_op(i) for i in range(warmup)]
    for j in range(n - warmup):
        ops.append(fwd_op(warmup + j))
        ops.append(bwd_op(j))
    ops.extend(bwd_op(j) for j in range(n - warmup, n))
    return ops


def _list_schedule(S: int, v: int, M: int, *, mb_base: int = 0,
                   t_base: int = 0) -> Dict[Tuple[str, int, int], int]:
    """Tick assignment ``(kind, mb, chunk_stage) -> t`` for one round.

    Time-stepped: each tick every device runs its next queued op iff
    that op's producer finished at a strictly earlier tick (fwd needs
    the previous chunk-stage's fwd, bwd the next chunk-stage's bwd, the
    last chunk-stage's bwd its own fwd).
    """
    C = S * v
    queues = [_device_op_order(S, v, M, d) for d in range(S)]
    heads = [0] * S
    done: Dict[Tuple[str, int, int], int] = {}
    t = t_base
    while any(heads[d] < len(queues[d]) for d in range(S)):
        progressed = False
        for d in range(S):
            if heads[d] >= len(queues[d]):
                continue
            kind, mb, q = queues[d][heads[d]]
            if kind == FWD:
                ready = q == 0 or done.get((FWD, mb, q - 1), t) < t
            elif q == C - 1:
                ready = done.get((FWD, mb, q), t) < t
            else:
                ready = done.get((BWD, mb, q + 1), t) < t
            if ready:
                done[(kind, mb, q)] = t
                heads[d] += 1
                progressed = True
        if not progressed:
            # nothing ran this tick ⇒ `done` is unchanged ⇒ nothing can
            # ever become ready: the fixed per-device op order is cyclic
            raise RuntimeError(
                f"list scheduler deadlocked at t={t} "
                f"(S={S}, v={v}, M={M})")
        t += 1
    return {(k, mb + mb_base, q): tt for (k, mb, q), tt in done.items()}


def _flush_rounds(name: str, S: int, v: int, M: int, n_rounds: int
                  ) -> Schedule:
    """Rounds of M microbatches, per-stage flush update at each stage's
    last backward of the round — staleness-free by construction."""
    if v > 1 and M % S:
        raise ValueError(
            f"interleaved needs n_microbatches % n_stages == 0, got "
            f"M={M}, S={S}")
    C = S * v
    ev: List[Event] = []
    t_base = 0
    for r in range(n_rounds):
        ticks = _list_schedule(S, v, M, mb_base=r * M, t_base=t_base)
        mbs = tuple(range(r * M, (r + 1) * M))
        for (kind, mb, q), t in ticks.items():
            ev.append(Event(kind, t, stage=q, mb=mb))
        for q in range(C):
            last_b = max(t for (k, mb, qq), t in ticks.items()
                         if k == BWD and qq == q)
            ev.append(Event(UPDATE, last_b, stages=(q,), mbs=mbs))
        t_base = max(ticks.values()) + 1
    return Schedule(name, C, ev, n_devices=S, round_microbatches=M)


def _rounds_for(C: int, M: int, n_rounds: Optional[int]) -> int:
    # enough rounds that a steady minibatch (index ≥ 2C) exists
    if n_rounds is not None:
        return n_rounds
    need = 2 * C + 2
    return max(3, -(-need // M) + 1)


def one_f_one_b(n_stages: int, n_microbatches: Optional[int] = None,
                n_rounds: Optional[int] = None) -> Schedule:
    """PipeDream-flush 1F1B: stage k runs S−1−k warm-up forwards, then
    one-forward-one-backward steady state, then drains; gradients
    accumulate across the round's M microbatches and flush in one
    per-stage update.  Staleness-free (s_fwd = s_bwd = 0) at the same
    (S−1)/(M+S−1) bubble as GPipe, but stage k stashes only S−k
    activations instead of M."""
    S = n_stages
    M = n_microbatches or max(2, 2 * S)
    return _flush_rounds("1f1b", S, 1, M, _rounds_for(S, M, n_rounds))


def interleaved_1f1b(n_stages: int, n_microbatches: Optional[int] = None,
                     *, v: int = 2, n_rounds: Optional[int] = None
                     ) -> Schedule:
    """Megatron-style interleaved 1F1B: device d hosts the v chunk-stages
    ``d, d+S, …``; the round's bubble shrinks to (S−1)/(M·v+S−1) at the
    price of v× more in-flight chunk activations and p2p traffic.  Still
    staleness-free (flush update per round)."""
    if v < 1:
        raise ValueError(f"virtual stages v must be >= 1, got {v}")
    S = n_stages
    M = n_microbatches if n_microbatches is not None else max(2 * S, 2)
    return _flush_rounds("interleaved", S, v, M,
                         _rounds_for(S * v, M, n_rounds))


def pipedream_2bw(n_stages: int, n_microbatches: Optional[int] = None,
                  n_groups: Optional[int] = None) -> Schedule:
    """PipeDream-2BW: continuous 1F1B (no flush) with per-stage updates
    every ``m = n_microbatches`` microbatches and double-buffered
    weights.  Group g's fwd *and* bwd reads are pinned (``wv``) to the
    version with g−1 updates applied — the newest version every stage is
    guaranteed to have when the group's first forward arrives, given the
    paper's m ≥ S constraint.  Derived staleness is therefore a uniform
    1 and the derived weight-stash depth 2 (the "2-buffered weights")."""
    S = n_stages
    m = n_microbatches or max(2, S)
    if m < S:
        raise ValueError(
            f"2bw needs n_microbatches >= n_stages for 2 weight buffers "
            f"to suffice, got m={m}, S={S}")
    G = n_groups or max(3, -(-(2 * S + 2) // m) + 1)
    ticks = _list_schedule(S, 1, m * G)
    ev: List[Event] = []
    for (kind, mb, q), t in ticks.items():
        ev.append(Event(kind, t, stage=q, mb=mb,
                        wv=max(0, mb // m - 1)))
    for g in range(G):
        mbs = tuple(range(g * m, (g + 1) * m))
        for q in range(S):
            last_b = max(ticks[(BWD, mb, q)] for mb in mbs)
            ev.append(Event(UPDATE, last_b, stages=(q,), mbs=mbs))
    return Schedule("2bw", S, ev, round_microbatches=m)


EMITTERS = {
    "1f1b_rr": round_robin_1f1b,
    "gpipe": gpipe,
    "stream": streaming,
    "1f1b": one_f_one_b,
    "2bw": pipedream_2bw,
    "interleaved": interleaved_1f1b,
}

# schedules whose emitters take a per-round/group microbatch count and
# which core/pipeline_stream.py executes through the IR interpreter —
# the single source for planner/api.py and the runtimes
ROUND_SCHEDULES = ("gpipe", "1f1b", "2bw", "interleaved")


def emit(name: str, n_stages: int, **kw) -> Schedule:
    if name not in EMITTERS:
        raise KeyError(f"unknown schedule {name!r}; known: {sorted(EMITTERS)}")
    return EMITTERS[name](n_stages, **kw)


# ===========================================================================
# lowering: one round of compute events -> a dense int32 event table
# ===========================================================================
#
# The scan backend of ``core/pipeline_stream.py`` executes one table
# row at a time, dispatching on a *branch id* that statically
# encodes (opcode, chunk-stage, weight-version lag) — the three
# facts that pick a branch body (ragged chunk weights make
# per-chunk dispatch unavoidable; the lag picks a predicted weight
# tree).  Everything dynamic per event lives in int32 columns:

# row columns (COL_* indices into EventTable.rows[i])
COL_BRANCH = 0   # index into EventTable.branches (the interpreter's arm)
COL_OP = 1       # 0 = fwd, 1 = bwd (informational: branch id implies it)
COL_CHUNK = 2    # chunk-stage q (informational: branch id implies it)
COL_MB = 3       # microbatch slot m within the round, 0..M-1
COL_WV = 4       # weight-version lag s of the event's read (in branch id)
COL_A = 5        # fwd q==0: write slot of v(m,0) (the embed output)
#                  fwd q>0:  read slot of v(m,q) (the chunk input)
#                  bwd:      read slot of v(m,q) (the stashed activation)
COL_B = 6        # fwd:       write slot of v(m,q+1) (the chunk output)
#                  bwd q==C-1: read slot of v(m,C) (the head input)
#                  bwd q<C-1:  read cot slot of c(m,q+1) (output cotangent)
COL_C = 7        # bwd q>0: write cot slot of c(m,q); else -1
COL_FIRST_G = 8  # 1 iff this bwd event is chunk q's first grad contribution
COL_FIRST_O = 9  # 1 iff this is the first *head* outer-grad contribution
COL_FIRST_E = 10  # 1 iff this is the first *embed* outer-grad contribution
N_COLS = 11

OP_FWD, OP_BWD = 0, 1


@dataclass(frozen=True, eq=False)
class EventTable:
    """Dense array encoding of one schedule round.

    ``branches[b] = (kind, chunk_stage, wv_lag)`` — the static facts a
    branch arm closes over; ``rows`` is ``[2·M·C, N_COLS]``
    int32 (column semantics above).  Buffer slots are register-allocated
    over the round (greedy lowest-free-slot over value lifetimes), so
    ``n_val_slots`` / ``n_cot_slots`` are the schedule's true peak
    in-flight activation / cotangent counts — buffer memory is set by
    the schedule; ``len(branches)`` is ≤ 2·C, independent of M.

    Value naming: ``v(m, q)`` is microbatch m's input to chunk q (the
    embed output for q = 0) for q in 0..C-1, and ``v(m, C)`` the last
    chunk's output consumed by the loss head; ``c(m, q)`` is the
    cotangent w.r.t. ``v(m, q)``, buffered only for 0 < q < C (the head
    produces c(m, C) in-branch; the embed backward consumes c(m, 0)
    in-branch).
    """
    n_chunks: int
    n_microbatches: int
    branches: Tuple[Tuple[str, int, int], ...]
    rows: np.ndarray
    n_val_slots: int
    n_cot_slots: int

    def __post_init__(self):
        self.rows.setflags(write=False)


def round_compute_events(sched: Schedule, *, base: int = 0
                         ) -> List[Tuple[str, int, int, int, int]]:
    """One round's compute events ``(kind, local_mb, chunk_stage, s, t)``
    in timeline order, with ``s`` the IR-derived weight-version lag of
    each event's read and ``t`` the event's schedule tick (raw — callers
    normalize).  The tick is what :func:`compile_device_streams` needs
    to slice the round into per-device event streams; callers that only
    interpret the global timeline use :func:`round_compute_program`.

    ``base`` selects the round's first minibatch: flush schedules repeat
    identically from round 0, 2BW's group 0 still reads the initial
    weights (warm-up truncation), so its callers pass ``base = m`` to
    lower a steady group.
    """
    M = sched.round_microbatches
    if M < 1:
        raise ValueError(
            f"{sched.name}: not a round schedule (round_microbatches={M})")
    prog = []
    for e in sched.events:
        if e.kind == UPDATE or not base <= e.mb < base + M:
            continue
        phase = "forward" if e.kind == FWD else "backward"
        prog.append((e.kind, e.mb - base, e.stage,
                     sched.staleness(e.stage, phase, e.mb), e.t))
    want = 2 * M * sched.n_stages
    if len(prog) != want:
        raise ValueError(
            f"{sched.name}: round at base {base} has {len(prog)} compute "
            f"events, expected {want}")
    return prog


def round_compute_program(sched: Schedule, *, base: int = 0
                          ) -> List[Tuple[str, int, int, int]]:
    """One round's compute events ``(kind, local_mb, chunk_stage, s)``
    in timeline order — :func:`round_compute_events` with the ticks
    dropped (the global-timeline interpreters don't need them)."""
    return [(kind, m, q, s)
            for kind, m, q, s, _t in round_compute_events(sched, base=base)]


def compile_event_table(prog: List[Tuple[str, int, int, int]],
                        n_chunks: int, n_microbatches: int) -> EventTable:
    """Lower a round program (:func:`round_compute_program`) to an
    :class:`EventTable`.

    Walks the program once, allocating buffer slots over value
    lifetimes: ``v(m, q)`` is born at its producing forward and dies at
    chunk q's backward (the head input ``v(m, C)`` at chunk C-1's
    backward); ``c(m, q)`` is born at chunk q's backward and dies at
    chunk q-1's.  Slots freed by an event may be reused by the same
    event's write — the interpreter reads all inputs before writing.
    """
    C, M = n_chunks, n_microbatches
    if len(prog) != 2 * M * C:
        raise ValueError(f"program has {len(prog)} events, expected "
                         f"{2 * M * C} (= 2·{M}·{C})")
    specs: List[Tuple[str, int, int]] = []
    spec_ix: Dict[Tuple[str, int, int], int] = {}
    rows = []
    val_slot: Dict[Tuple[int, int], int] = {}
    cot_slot: Dict[Tuple[int, int], int] = {}
    free: List[List[int]] = [[], []]      # min-heaps: [values, cotangents]
    hwm = [0, 0]                          # slot high-water marks

    def alloc(pool: int) -> int:
        if free[pool]:
            return heapq.heappop(free[pool])
        hwm[pool] += 1
        return hwm[pool] - 1

    seen_g = set()
    head_seen = embed_seen = False
    for kind, m, q, s in prog:
        if not (0 <= m < M and 0 <= q < C):
            raise ValueError(f"event ({kind},{m},{q}) out of range for "
                             f"M={M}, C={C}")
        key = (kind, q, s)
        if key not in spec_ix:
            spec_ix[key] = len(specs)
            specs.append(key)
        fg = fo = fe = 0
        if kind == FWD:
            op = OP_FWD
            if (m, q + 1) in val_slot:
                raise ValueError(f"fwd({m},{q}) emitted twice")
            if q == 0:
                a = alloc(0)
                val_slot[(m, 0)] = a
            else:
                if (m, q) not in val_slot:
                    raise ValueError(f"fwd({m},{q}) before fwd({m},{q-1})")
                a = val_slot[(m, q)]
            b = alloc(0)
            val_slot[(m, q + 1)] = b
            c = -1
        else:
            op = OP_BWD
            if (m, q) not in val_slot:
                raise ValueError(f"bwd({m},{q}) before fwd({m},{q}) or "
                                 f"emitted twice")
            a = val_slot.pop((m, q))
            heapq.heappush(free[0], a)
            if q == C - 1:
                b = val_slot.pop((m, C))
                heapq.heappush(free[0], b)
            else:
                if (m, q + 1) not in cot_slot:
                    raise ValueError(f"bwd({m},{q}) before bwd({m},{q+1})")
                b = cot_slot.pop((m, q + 1))
                heapq.heappush(free[1], b)
            c = -1
            if q > 0:
                c = alloc(1)
                cot_slot[(m, q)] = c
            if q not in seen_g:
                seen_g.add(q)
                fg = 1
            # the outer grad is accumulated as two independent streams
            # (head contributions at chunk C-1, embed contributions at
            # chunk 0) combined once at the end of the round — the
            # association the MPMD backend can reproduce without
            # per-event cross-device traffic
            if q == C - 1 and not head_seen:
                head_seen = True
                fo = 1
            if q == 0 and not embed_seen:
                embed_seen = True
                fe = 1
        rows.append((spec_ix[key], op, q, m, s, a, b, c, fg, fo, fe))
    if val_slot or cot_slot:
        raise ValueError(
            f"round leaves in-flight values: "
            f"{sorted(val_slot) + sorted(cot_slot)}")
    return EventTable(
        n_chunks=C, n_microbatches=M, branches=tuple(specs),
        rows=np.asarray(rows, np.int32),
        n_val_slots=hwm[0], n_cot_slots=hwm[1])


# ===========================================================================
# lowering: one round -> per-device event streams (the MPMD execution
# path: each device runs its own stream and activations/cotangents
# cross the stage cuts; compiled and verified here)
# ===========================================================================
#
# Device-stream rows are tick-indexed: ``rows[t, d]`` is what device
# ``d`` does at synchronous tick ``t`` — at most one compute event (the
# branch id) plus up to one incoming forward activation and
# one incoming backward cotangent, written into *device-local*
# value/cotangent pools.  Transfers happen on the producing tick: a
# forward output crosses to device d+1 (ring), a backward cotangent to
# device d-1, and the receiver's row says which local slot to park the
# payload in (−1 → a trash slot; the ring carries garbage on idle
# ticks so the program stays SPMD).

# row columns (DCOL_* indices into DeviceStreams.rows[t, d])
DCOL_BRANCH = 0   # branch arm; -1 in the np array is re-written to
#                   the NOP arm (= len(branches)) before freezing
DCOL_MB = 1       # microbatch slot m within the round
DCOL_A = 2        # fwd q==0: write slot of v(m,0); fwd q>0 and bwd:
#                   read slot of v(m,q) (the chunk input / stashed act)
DCOL_B = 3        # fwd q==C-1: write slot of v(m,C) (the head input);
#                   bwd q==C-1: read slot of v(m,C); else -1
DCOL_C = 4        # bwd q<C-1: read slot of the incoming cotangent
DCOL_RECV_F = 5   # local val slot for this tick's incoming fwd payload
DCOL_RECV_B = 6   # local cot slot for this tick's incoming bwd payload
DCOL_FIRST_G = 7  # 1 iff chunk q's first grad contribution
DCOL_FIRST_O = 8  # 1 iff the first head outer-grad contribution
DCOL_FIRST_E = 9  # 1 iff the first embed outer-grad contribution
DN_COLS = 10


@dataclass(frozen=True, eq=False)
class DeviceStreams:
    """Per-device tick streams of one schedule round.

    ``rows`` is ``[T, S, DN_COLS]`` int32 — slicing column ``d`` with a
    ``PartitionSpec(None, 'pipe')`` hands each device exactly its own
    stream.  Buffer slots are register-allocated **per device**, so
    ``n_val_slots`` / ``n_cot_slots`` (the max over devices — pools are
    uniform so the program stays SPMD) are per-device peaks: a chunk's
    activation stash is spread across the devices that host it instead
    of replicated.  Every device executes the same
    branch list (a device's rows only ever select its own chunks'
    branches); arm ``len(branches)`` is the NOP.
    """
    n_chunks: int
    n_microbatches: int
    n_devices: int
    branches: Tuple[Tuple[str, int, int], ...]
    rows: np.ndarray
    n_val_slots: int
    n_cot_slots: int

    def __post_init__(self):
        self.rows.setflags(write=False)


def compile_device_streams(events: List[Tuple[str, int, int, int, int]],
                           n_chunks: int, n_microbatches: int,
                           n_devices: int) -> DeviceStreams:
    """Lower a round's compute events (:func:`round_compute_events`) to
    per-device tick streams (:class:`DeviceStreams`).

    Chunk ``q`` lives on device ``q % n_devices`` (Megatron round-robin
    folding); ticks are the rank-compressed distinct event start times,
    so cross-device dependencies are always separated by at least one
    tick (an event's consumers start strictly after it).  Value
    lifetimes: a received activation is born on the consumer's device
    at the *producer's* tick and dies at the consumer chunk's backward;
    in-branch values (the embed output on device 0, the head input on
    the last chunk's device) are born at their forward.  Slots freed by
    a tick's compute may be reused by the same tick's writes — the
    interpreter reads all branch inputs before writing, and payload
    receives land after the branch runs.
    """
    C, M, S = n_chunks, n_microbatches, n_devices
    if len(events) != 2 * M * C:
        raise ValueError(f"program has {len(events)} events, expected "
                         f"{2 * M * C} (= 2·{M}·{C})")
    if S < 1 or C % S:
        raise ValueError(f"{C} chunks do not fold onto {S} devices "
                         f"(n_chunks % n_devices != 0)")
    ranks = {t: i for i, t in enumerate(sorted({e[4] for e in events}))}
    T = len(ranks)
    by_tick: Dict[int, List[Tuple[str, int, int, int]]] = {}
    seen_dev: set = set()
    for kind, m, q, s, t in events:
        if not (0 <= m < M and 0 <= q < C):
            raise ValueError(f"event ({kind},{m},{q}) out of range for "
                             f"M={M}, C={C}")
        r, d = ranks[t], q % S
        if (r, d) in seen_dev:
            raise ValueError(
                f"device {d} has two compute events at tick {t} — the "
                f"schedule is not one-event-per-(device, tick)")
        seen_dev.add((r, d))
        by_tick.setdefault(r, []).append((kind, m, q, s))

    specs: List[Tuple[str, int, int]] = []
    spec_ix: Dict[Tuple[str, int, int], int] = {}
    rows = np.full((T, S, DN_COLS), -1, np.int32)
    rows[:, :, DCOL_MB] = 0
    rows[:, :, DCOL_FIRST_G] = 0
    rows[:, :, DCOL_FIRST_O] = 0
    rows[:, :, DCOL_FIRST_E] = 0

    # per-device register allocators: [device][pool] min-heap + hwm
    free = [[[], []] for _ in range(S)]
    hwm = [[0, 0] for _ in range(S)]

    def alloc(d: int, pool: int) -> int:
        if free[d][pool]:
            return heapq.heappop(free[d][pool])
        hwm[d][pool] += 1
        return hwm[d][pool] - 1

    val_slot: Dict[Tuple[int, int], int] = {}   # x(m,q) on device q%S
    out_slot: Dict[int, int] = {}               # v(m,C) on device (C-1)%S
    cot_slot: Dict[Tuple[int, int], int] = {}   # cot read by bwd(m,q)
    seen_g: set = set()
    head_seen = embed_seen = False

    for r in range(T):
        evs = sorted(by_tick.get(r, ()), key=lambda e: e[2] % S)
        # phase 1: frees from this tick's reads (before any allocation)
        for kind, m, q, s in evs:
            d = q % S
            if kind != BWD:
                continue
            if (m, q) not in val_slot:
                raise ValueError(f"bwd({m},{q}) before fwd({m},{q}) or "
                                 f"emitted twice")
            heapq.heappush(free[d][0], val_slot[(m, q)])
            if q == C - 1:
                if m not in out_slot:
                    raise ValueError(f"bwd({m},{q}) before fwd({m},{q})")
                heapq.heappush(free[d][0], out_slot[m])
            elif (m, q) not in cot_slot:
                raise ValueError(f"bwd({m},{q}) before bwd({m},{q+1})")
            else:
                heapq.heappush(free[d][1], cot_slot[(m, q)])
        # phase 2: the events' own rows + in-branch writes
        for kind, m, q, s in evs:
            d = q % S
            key = (kind, q, s)
            if key not in spec_ix:
                spec_ix[key] = len(specs)
                specs.append(key)
            row = rows[r, d]
            row[DCOL_BRANCH] = spec_ix[key]
            row[DCOL_MB] = m
            if kind == FWD:
                if q == 0:
                    if (m, 0) in val_slot:
                        raise ValueError(f"fwd({m},0) emitted twice")
                    val_slot[(m, 0)] = alloc(d, 0)
                elif (m, q) not in val_slot:
                    raise ValueError(f"fwd({m},{q}) before fwd({m},{q-1})")
                row[DCOL_A] = val_slot[(m, q)]
                if q == C - 1:
                    if m in out_slot:
                        raise ValueError(f"fwd({m},{q}) emitted twice")
                    out_slot[m] = alloc(d, 0)
                    row[DCOL_B] = out_slot[m]
            else:
                row[DCOL_A] = val_slot.pop((m, q))
                if q == C - 1:
                    row[DCOL_B] = out_slot.pop(m)
                else:
                    row[DCOL_C] = cot_slot.pop((m, q))
                if q not in seen_g:
                    seen_g.add(q)
                    row[DCOL_FIRST_G] = 1
                if q == C - 1 and not head_seen:
                    head_seen = True
                    row[DCOL_FIRST_O] = 1
                if q == 0 and not embed_seen:
                    embed_seen = True
                    row[DCOL_FIRST_E] = 1
        # phase 3: payload receives on the ring neighbors (land after
        # the neighbors' branch bodies ran, so freed slots are reusable)
        for kind, m, q, s in evs:
            d = q % S
            if kind == FWD and q < C - 1:
                nd = (d + 1) % S
                if (m, q + 1) in val_slot:
                    raise ValueError(f"fwd({m},{q}) emitted twice")
                slot = alloc(nd, 0)
                val_slot[(m, q + 1)] = slot
                rows[r, nd, DCOL_RECV_F] = slot
            elif kind == BWD and q > 0:
                nd = (d - 1) % S
                slot = alloc(nd, 1)
                cot_slot[(m, q - 1)] = slot
                rows[r, nd, DCOL_RECV_B] = slot

    if val_slot or out_slot or cot_slot:
        raise ValueError(
            f"round leaves in-flight values: "
            f"{sorted(val_slot) + sorted(out_slot) + sorted(cot_slot)}")
    # un-filled branch column -> the NOP arm (a valid switch index)
    br = rows[:, :, DCOL_BRANCH]
    br[br < 0] = len(specs)
    return DeviceStreams(
        n_chunks=C, n_microbatches=M, n_devices=S, branches=tuple(specs),
        rows=rows,
        n_val_slots=max(h[0] for h in hwm),
        n_cot_slots=max(h[1] for h in hwm))


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
SCOL_BRANCH = 0  # index into ServeTable.branches (the interpreter's arm)
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
