"""Pipeline tracer: measured per-(device, event) spans from the runtimes
(twin of ``repro/obs/trace.py``).

Measurement model
-----------------

The SPMD runtimes execute every pipeline "device" serially on one card,
so spans cannot be read off per device directly.  The tracer therefore
measures **per-event durations** and *reconstructs* the parallel
timeline the IR describes:

  * IR-interpreter runtimes (``backend="unrolled"`` and ``"scan"`` in
    ``core/pipeline_stream.py``): every compute event ends with a mark
    (:meth:`PipelineTracer._mark`), in the IR's timeline order (the
    order of ``round_program()``, in which the event table's rows also
    run), so arrival index *is* the event index.  Consecutive marks
    attribute the round's time to its events.
  * stage-local (MPMD) rounds: each rank marks once per row of its
    device-stream column, after that row's exchange, so a rank's tick
    includes its wait in the transport.  At the end of a traced round
    every rank sends its per-tick durations to the others in one
    ``StageGroup.all_gather_object``; an event of tick group ``t`` on
    device ``d`` gets rank ``d``'s duration of tick ``t``, one measured
    lane per rank (:meth:`PipelineTracer.set_stage_group`).
  * streaming runtime: one step is one fused tick over all stages — the
    tracer records per-step wall time and attributes it across stages by
    separately **probed** per-stage costs (:func:`probe_stage_costs`,
    the PipeDream profile-then-attribute approach).

What a mark reads depends on the device the tracer was made for.  On a
CUDA device it records a ``torch.cuda.Event(enable_timing=True)`` on the
current stream and never synchronizes; :meth:`PipelineTracer.wrap_step`
records a start event before the step, synchronizes once after it and
turns consecutive ``elapsed_time``s into per-event seconds of the
card's timeline (a span holds the event's kernels and any idle gap
before them).  On the CPU a mark reads the injectable ``clock``.  A
failure to record or time an event raises.

Reconstruction lays measured durations on the IR's discrete tick grid:
tick ``t`` starts when every device finished tick ``t-1`` (the IR's
synchronous-time semantics), a device's events within a tick run
back-to-back.  Realized bubble fraction, per-device busy/idle and the
per-stage cost vector all fall out of the reconstructed spans; the
predicted lane applies the same reconstruction to the planner's modelled
durations (fwd = stage cost, bwd = 2x — the standard 1:2 fwd:bwd FLOP
ratio the roofline model also uses).

The first recorded round is dropped from aggregates when more than one
exists (it pays the warm-up).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

BWD_FWD_RATIO = 2.0     # modelled bwd/fwd cost ratio (2 matmuls vs 1)


@dataclass(frozen=True)
class Span:
    """One lane-resident interval of the (re)constructed timeline."""
    device: int          # pipe device = Perfetto lane (tid)
    name: str            # "fwd m3 q1", "tick 7", ...
    t0: float            # seconds from timeline origin
    dur: float           # seconds
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def t1(self) -> float:
        return self.t0 + self.dur


def round_event_metas(plan) -> List[Dict[str, Any]]:
    """Static per-event metadata for one round of an IR schedule, in the
    exact order the interpreter executes (and the tracer's marks
    arrive): ``kind``, ``mb``, ``chunk``, ``wv`` (weight-version lag),
    ``tick`` (round-relative) and ``device``."""
    from repro_torch.planner import schedule_ir as sir

    sched = plan.round_ir()
    M = plan.round_microbatches
    base = M if plan.schedule == "2bw" else 0
    prog = plan.round_program()
    ticks = [e.t for e in sched.events
             if e.kind != sir.UPDATE and base <= e.mb < base + M]
    if len(ticks) != len(prog):
        raise ValueError(
            f"{plan.schedule}: {len(ticks)} round events vs "
            f"{len(prog)} program entries")
    t0 = min(ticks)
    D = plan.n_devices
    return [
        {"kind": kind, "mb": m, "chunk": q, "wv": s,
         "tick": t - t0, "device": q % D}
        for (kind, m, q, s), t in zip(prog, ticks)]


def device_stream_tick_groups(plan) -> List[List[int]]:
    """Event-index groups per schedule tick, in tick order — the mark
    granularity of the MPMD execution path.

    A stage rank marks once per row of its device stream (one row per
    distinct tick of the round), while :func:`round_event_metas` is per
    *event*.  Group ``t`` lists the meta indices of every event in the
    round's ``t``-th distinct tick — the same rank compression
    ``planner.schedule_ir.compile_device_streams`` applies.  Install on
    the tracer with :meth:`PipelineTracer.set_tick_groups`."""
    by: Dict[int, List[int]] = {}
    for i, m in enumerate(round_event_metas(plan)):
        by.setdefault(m["tick"], []).append(i)
    return [by[t] for t in sorted(by)]


def _reconstruct(metas: Sequence[Dict[str, Any]],
                 durs: Sequence[float]) -> Tuple[List[Span], float]:
    """Lay per-event durations on the IR tick grid (synchronous ticks,
    back-to-back events per device within a tick).  Returns (spans,
    makespan)."""
    if len(metas) != len(durs):
        raise ValueError(f"{len(durs)} durations for {len(metas)} events")
    spans: List[Span] = []
    cursor = 0.0
    by_tick: Dict[int, List[int]] = {}
    for i, m in enumerate(metas):
        by_tick.setdefault(m["tick"], []).append(i)
    for t in sorted(by_tick):
        dev_off: Dict[int, float] = {}
        for i in by_tick[t]:
            m = metas[i]
            off = dev_off.get(m["device"], 0.0)
            spans.append(Span(
                device=m["device"],
                name=f"{m['kind']} m{m['mb']} q{m['chunk']}",
                t0=cursor + off, dur=float(durs[i]),
                args={"op": m["kind"], "mb": m["mb"], "chunk": m["chunk"],
                      "wv_lag": m["wv"], "tick": t}))
            dev_off[m["device"]] = off + float(durs[i])
        cursor += max(dev_off.values()) if dev_off else 0.0
    return spans, cursor


def timeline_stats(spans: Sequence[Span], makespan: float,
                   n_devices: int) -> Dict[str, Any]:
    """Busy/idle accounting over a reconstructed timeline."""
    busy = [0.0] * n_devices
    for s in spans:
        busy[s.device] += s.dur
    total = n_devices * makespan
    return {
        "makespan_s": makespan,
        "busy_s": busy,
        "idle_s": [max(0.0, makespan - b) for b in busy],
        "busy_frac": [b / makespan if makespan else 0.0 for b in busy],
        "bubble_frac": 1.0 - (sum(busy) / total if total else 0.0),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_stage_costs(model, stage_trees, *, mb: int = 1, seq: int = 16,
                      iters: int = 3,
                      clock: Callable[[], float] = time.perf_counter
                      ) -> List[float]:
    """Measured per-stage forward wall time (after a warm call, the card
    synchronized around the timed calls) — the streaming runtime's
    attribution weights and the PipeDream-style realized profile a
    recalibration would feed back to the planner."""
    from repro_torch.models.layers import dtype_of

    dev = model.device
    x = torch.zeros((mb, seq, model.cfg.d_model),
                    dtype=dtype_of(model.cfg.compute_dtype), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    costs = []
    with torch.no_grad():
        for sp in stage_trees:
            model.stage_apply(sp, (x, zero))         # warm
            _sync(dev)
            t0 = clock()
            for _ in range(iters):
                model.stage_apply(sp, (x, zero))
            _sync(dev)
            costs.append((clock() - t0) / iters)
    return costs


class PipelineTracer:
    """Collects measured event timings for one :class:`PipelinePlan`.

    Usage (the ``launch/train.py --trace`` wiring)::

        tracer = PipelineTracer(plan, device=model.device)
        rt = Runtime(plan, model, RuntimeConfig(trace=True), tracer=tracer)
        ... run rt.train_step ...
        obs.write_trace(path, tracer)
        print(obs.format_drift(obs.drift_report(tracer)))

    ``device`` is where the traced runtime runs: marks are CUDA events
    on a card and ``clock`` readings on the CPU.  ``clock`` (the host
    clock of step walls, and of CPU marks) is injectable for
    deterministic tests (a fake clock that advances a fixed amount per
    call yields exactly-uniform durations).
    """

    def __init__(self, plan, *,
                 clock: Callable[[], float] = time.perf_counter,
                 device="cpu"):
        from repro_torch.planner.api import ROUND_SCHEDULES

        self.plan = plan
        self.clock = clock
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.is_round = plan.schedule in ROUND_SCHEDULES
        self.metas = round_event_metas(plan) if self.is_round else []
        self.rounds: List[List[float]] = []   # per-round event durations
        self.step_walls: List[float] = []     # per-step wall seconds
        self.probed: Optional[List[float]] = None
        self.dropped_rounds = 0               # mark-count mismatches
        self.tick_groups: Optional[List[List[int]]] = None
        self.group = None                     # MPMD: this rank's group
        self._cur: list = []
        self._t0: Optional[float] = None
        self._events: List[torch.cuda.Event] = []   # reused each round
        self._start: Optional[torch.cuda.Event] = None

    def check_device(self, device) -> None:
        """Raise unless the traced runtime runs on this tracer's
        device (its marks would time another device's work)."""
        if torch.device(device) != self.device:
            raise ValueError(
                f"the tracer marks on {self.device}, the runtime runs on "
                f"{device}: make it PipelineTracer(plan, device=...) with "
                f"the model's device")

    # ------------------------------------------------------ runtime hooks
    def _mark(self) -> None:
        """One call per compute event (MPMD: per device-stream row), in
        the IR's timeline order (arrival index == event index)."""
        if self.device.type != "cuda":
            self._cur.append(self.clock())
            return
        i = len(self._cur)
        if i == len(self._events):
            self._events.append(torch.cuda.Event(enable_timing=True))
        ev = self._events[i]
        ev.record(torch.cuda.current_stream(self.device))
        self._cur.append(ev)

    def set_tick_groups(self, groups: Sequence[Sequence[int]]) -> None:
        """Switch to tick-granular marks: one mark per schedule tick
        instead of one per event (:func:`device_stream_tick_groups`).
        Each measured tick duration is attributed to *every* event in
        that tick — an upper bound per event (the tracer cannot see the
        intra-tick split from one mark per tick).  Under
        :meth:`set_stage_group` each event takes its own rank's tick
        duration instead."""
        groups = [list(g) for g in groups]
        covered = sorted(i for g in groups for i in g)
        if covered != list(range(len(self.metas))):
            raise ValueError(
                f"tick groups cover event indices {covered[:8]}..., "
                f"expected exactly 0..{len(self.metas) - 1}")
        self.tick_groups = groups

    def set_stage_group(self, group, n_rows: int) -> None:
        """The MPMD wiring (``core/pipeline_stream.py``): this rank marks
        once per row of its device-stream column (``n_rows`` of them, one
        per tick group), and at the end of each traced round the ranks
        exchange their per-tick durations through ``group``; an event of
        tick ``t`` on device ``d`` gets rank ``d``'s tick ``t``."""
        groups = device_stream_tick_groups(self.plan)
        if n_rows != len(groups):
            raise ValueError(
                f"the device streams have {n_rows} rows a rank, the "
                f"round's events fall in {len(groups)} ticks")
        if group.world != self.plan.n_devices:
            raise ValueError(f"the plan has {self.plan.n_devices} devices, "
                             f"the group {group.world} ranks")
        self.set_tick_groups(groups)
        self.group = group

    def _durations(self) -> List[float]:
        """Seconds between consecutive marks of the step just run, from
        the step's start (the card synchronized)."""
        if self.device.type != "cuda":
            ts = [self._t0] + self._cur
            return [ts[i + 1] - ts[i] for i in range(len(self._cur))]
        evs = [self._start] + self._cur
        return [evs[i].elapsed_time(evs[i + 1]) / 1e3
                for i in range(len(self._cur))]

    def wrap_step(self, step_fn: Callable) -> Callable:
        """Wrap a train step with round bracketing: resets the mark
        buffer, times the call (synchronizing the card once after it),
        and files the round's durations."""
        cuda = self.device.type == "cuda"

        def traced_step(state, batch):
            self._cur = []
            if cuda:
                if self._start is None:
                    self._start = torch.cuda.Event(enable_timing=True)
                self._start.record(torch.cuda.current_stream(self.device))
            self._t0 = self.clock()
            out = step_fn(state, batch)
            _sync(self.device)
            wall = self.clock() - self._t0
            self.step_walls.append(wall)
            if self.is_round:
                want = (len(self.tick_groups)
                        if self.tick_groups is not None else len(self.metas))
                durs = self._durations() if len(self._cur) == want else None
                if self.group is not None:
                    # every rank takes part, complete or not, so that no
                    # rank waits on a gather the others skipped
                    lanes = self.group.all_gather_object(
                        (len(self._cur), durs))
                    if all(d is not None for _, d in lanes):
                        self.rounds.append(self._by_rank(
                            [d for _, d in lanes]))
                    elif any(n for n, _ in lanes):
                        self.dropped_rounds += 1
                elif durs is not None:
                    if self.tick_groups is not None:
                        ev = [0.0] * len(self.metas)
                        for t, grp in enumerate(self.tick_groups):
                            for i in grp:
                                ev[i] = durs[t]
                        durs = ev
                    self.rounds.append(durs)
                elif self._cur:
                    self.dropped_rounds += 1
            return out
        return traced_step

    def _by_rank(self, lanes: Sequence[Sequence[float]]) -> List[float]:
        """Per-event durations from each rank's per-tick durations: the
        event of tick ``t`` on device ``d`` takes ``lanes[d][t]``."""
        ev = [0.0] * len(self.metas)
        for t, grp in enumerate(self.tick_groups):
            for i in grp:
                ev[i] = lanes[self.metas[i]["device"]][t]
        return ev

    def set_probed(self, costs: Sequence[float]) -> None:
        self.probed = [float(c) for c in costs]

    # ------------------------------------------------------- aggregation
    def _steady(self, seq: Sequence) -> Sequence:
        """Drop the first (warm-up) entry when more than one exists."""
        return seq[1:] if len(seq) > 1 else seq

    def mean_durations(self) -> List[float]:
        """Per-event durations averaged over steady rounds (IR
        schedules only)."""
        rounds = self._steady(self.rounds)
        if not rounds:
            raise ValueError("tracer recorded no complete rounds")
        n = len(rounds[0])
        return [sum(r[i] for r in rounds) / len(rounds) for i in range(n)]

    def n_steps(self) -> int:
        return len(self.step_walls)

    # ------------------------------------------------------- timelines
    def measured_timeline(self) -> Tuple[List[Span], float]:
        if self.is_round:
            return _reconstruct(self.metas, self.mean_durations())
        return self._stream_timeline(self._stream_weights())

    def predicted_timeline(self) -> Tuple[List[Span], float]:
        """The planner's modelled timeline on the same tick grid
        (fwd = stage cost, bwd = ``BWD_FWD_RATIO`` x)."""
        costs = self._plan_costs()
        if self.is_round:
            durs = [costs[m["chunk"]] *
                    (1.0 if m["kind"] == "fwd" else BWD_FWD_RATIO)
                    for m in self.metas]
            return _reconstruct(self.metas, durs)
        return self._stream_timeline(costs, predicted=True)

    def _plan_costs(self) -> List[float]:
        costs = list(self.plan.stage_costs_s or [])
        if not costs or not any(costs):
            costs = [1.0] * self.plan.n_chunks
        return costs

    def _stream_weights(self) -> List[float]:
        if self.probed:
            return list(self.probed)
        return self._plan_costs()

    def _stream_timeline(self, weights: Sequence[float], *,
                         predicted: bool = False
                         ) -> Tuple[List[Span], float]:
        """Streaming runtime: one span per (device, step); span length
        is the step wall scaled by that stage's share of the bottleneck
        stage's cost (every stage runs concurrently inside the fused
        tick, the bottleneck sets the step time)."""
        walls = self._steady(self.step_walls)
        if not walls:
            raise ValueError("tracer recorded no steps")
        if predicted:
            # modelled step time: bottleneck stage fwd+bwd
            walls = [max(weights) * (1.0 + BWD_FWD_RATIO)] * len(walls)
        wmax = max(weights)
        spans: List[Span] = []
        cursor = 0.0
        for t, wall in enumerate(walls):
            for k, w in enumerate(weights):
                spans.append(Span(
                    device=k, name=f"tick {t} s{k}",
                    t0=cursor, dur=wall * (w / wmax),
                    args={"op": "tick", "tick": t, "chunk": k,
                          "attributed": True}))
            cursor += wall
        return spans, cursor

    # ------------------------------------------------------- measurements
    def measured_stage_costs(self) -> List[float]:
        """Realized per-(chunk-)stage forward cost in seconds: the mean
        measured fwd-event duration (IR schedules) or the probed stage
        times (streaming) — the vector a profiler recalibration feeds
        back into ``planner.plan()``."""
        if not self.is_round:
            if not self.probed:
                raise ValueError(
                    "streaming tracer needs probe_stage_costs() results "
                    "(tracer.set_probed) for per-stage measurements")
            return list(self.probed)
        durs = self.mean_durations()
        C = self.plan.n_chunks
        tot = [0.0] * C
        n = [0] * C
        for m, d in zip(self.metas, durs):
            if m["kind"] == "fwd":
                tot[m["chunk"]] += d
                n[m["chunk"]] += 1
        return [t / max(1, c) for t, c in zip(tot, n)]

    def staleness_histogram(self) -> Dict[str, Dict[int, int]]:
        """Realized weight-version-lag counts per phase, from the
        executed events (IR schedules) or the plan vectors (stream)."""
        out: Dict[str, Dict[int, int]] = {"fwd": {}, "bwd": {}}
        if self.is_round:
            for m in self.metas:
                h = out[m["kind"]]
                h[m["wv"]] = h.get(m["wv"], 0) + 1
        else:
            for s in self.plan.s_fwd:
                out["fwd"][s] = out["fwd"].get(s, 0) + 1
            for s in self.plan.s_bwd:
                out["bwd"][s] = out["bwd"].get(s, 0) + 1
        return out
