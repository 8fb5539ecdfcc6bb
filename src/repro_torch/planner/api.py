"""``plan()`` and ``serve_plan()`` — the planner's front door (twin of
``repro/planner/api.py``).

Combines a cost profile (:mod:`profiler`), a stage split
(:mod:`partition`) and an emitted schedule timeline (:mod:`schedule_ir`)
into one :class:`PipelinePlan` that the simulator, the pipeline runtimes
and the training launcher consume, or into a :class:`ServePlan` for the
serving engines.  The per-stage weight prediction distances
``s_fwd``/``s_bwd`` are *derived* from the IR by counting update events,
never assumed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.planner import partition as pt
from repro_torch.planner import profiler as pf
from repro_torch.planner import schedule_ir as ir

SCHEDULES = tuple(ir.EMITTERS)
# the round/group schedule families the IR interpreter of
# core/pipeline_stream.py executes
ROUND_SCHEDULES = ir.ROUND_SCHEDULES


@dataclass(frozen=True)
class PipelinePlan:
    """Everything the runtimes need to execute one pipeline layout.

    ``s_fwd``/``s_bwd`` are the IR-derived weight-version differences per
    (chunk-)stage (SpecTrain's prediction distances, Eqs. 5–6
    generalized); ``bwd_lag`` is the injection→backward tick distance per
    stage; ``fb_gap`` the same-stage forward→backward distance (the
    streaming runtime's ring read offsets); ``partition`` maps layers to
    (chunk-)stages and is executed: the runtimes regroup stage weights by
    its layer ranges (``stage_ranges``) and validate them against the
    model.  ``stage_costs_s`` is the modelled per-stage time under that
    partition and ``bottleneck_s`` its max.

    ``virtual_stages`` (interleaved) is the chunk count v per device: the
    plan then describes ``n_chunks = n_stages·v`` chunk-stages, device d
    hosting chunks ``d, d+S, …``, and every per-stage vector has length
    ``n_chunks``.  ``round_microbatches`` is the microbatch count per
    flush round (1f1b/gpipe/interleaved) or accumulation group (2bw);
    ``bubble_frac``, ``act_stash`` and ``w_stash_depth`` are derived from
    the IR timeline.
    """
    n_stages: int
    schedule: str
    s_fwd: Tuple[int, ...]
    s_bwd: Tuple[int, ...]
    bwd_lag: Tuple[int, ...]
    fb_gap: Tuple[int, ...]
    partition: pt.Partition
    partitioner: str = "uniform"
    bottleneck_s: float = 0.0
    uniform_bottleneck_s: float = 0.0
    stage_costs_s: Tuple[float, ...] = ()
    virtual_stages: int = 1
    round_microbatches: int = 0
    bubble_frac: float = 0.0
    act_stash: Tuple[int, ...] = ()
    w_stash_depth: Tuple[int, ...] = ()
    profile: Optional[pf.ModelProfile] = field(default=None, repr=False)
    ir: Optional[ir.Schedule] = field(default=None, repr=False, hash=False,
                                      compare=False)

    @property
    def n_chunks(self) -> int:
        """Logical pipeline depth: chunk-stages a microbatch traverses."""
        return self.n_stages * self.virtual_stages

    @property
    def n_devices(self) -> int:
        """Devices the chunks fold onto (= n_stages)."""
        return self.n_stages

    @property
    def stage_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """Per-(chunk-)stage [lo, hi) layer ranges the runtime executes."""
        return self.partition.stages()

    @property
    def stage_sizes(self) -> Tuple[int, ...]:
        return self.partition.sizes()

    def staleness(self, stage: int, phase: str) -> int:
        vec = self.s_fwd if phase == "forward" else self.s_bwd
        if phase not in ("forward", "backward"):
            raise ValueError(phase)
        if not 0 <= stage < self.n_chunks:
            raise ValueError(f"stage {stage} out of range for "
                             f"{self.n_chunks} stages")
        return vec[stage]

    @property
    def ring_slots(self) -> int:
        """In-flight slots the streaming runtime must hold."""
        return max(max(self.bwd_lag), max(self.fb_gap)) + 1

    # ---------------------------------------------- round-schedule lowering
    def round_ir(self) -> ir.Schedule:
        """The schedule timeline backing this plan — ``self.ir``, or a
        deterministic re-emission when the plan was built with
        ``keep_ir=False``."""
        if self.ir is not None:
            return self.ir
        kw = {}
        if self.schedule == "interleaved":
            kw["v"] = self.virtual_stages
        if self.round_microbatches:
            kw["n_microbatches"] = self.round_microbatches
        return ir.emit(self.schedule, self.n_stages, **kw)

    def _round_base(self) -> int:
        # flush schedules lower round 0 (every round is identical); 2BW
        # a steady group (group 0's pinned reads are truncated to the
        # initial weights)
        if self.schedule not in ROUND_SCHEDULES:
            raise ValueError(
                f"{self.schedule!r} is not a round schedule; only "
                f"{ROUND_SCHEDULES} lower to a round program")
        return self.round_microbatches if self.schedule == "2bw" else 0

    def round_program(self):
        """One canonical round of compute events ``(kind, local_mb,
        chunk_stage, s)`` in timeline order (round schedules only)."""
        return ir.round_compute_program(self.round_ir(),
                                        base=self._round_base())

    def event_table(self) -> ir.EventTable:
        """Dense int32 lowering of :meth:`round_program`: what the IR
        interpreter's ``"scan"`` backend runs row by row."""
        return ir.compile_event_table(self.round_program(), self.n_chunks,
                                      self.round_microbatches)

    def device_streams(self) -> ir.DeviceStreams:
        """Per-device tick streams of one round (device ``d`` runs
        chunks ``d, d+S, …``): compiled and verified here, executed by
        the stage-local backend of a later slice."""
        return ir.compile_device_streams(
            ir.round_compute_events(self.round_ir(),
                                    base=self._round_base()),
            self.n_chunks, self.round_microbatches, self.n_devices)

    def verify(self, *, device_streams: bool = True) -> None:
        """Statically verify this plan's compiled artifacts
        (``planner/verify.py``).  Raises
        :class:`~repro_torch.planner.verify.VerificationError`."""
        from repro_torch.planner import verify as pv
        pv.check_plan(self, device_streams=device_streams)

    def summary(self) -> str:
        v = (f" v={self.virtual_stages}" if self.virtual_stages > 1 else "")
        return (f"plan[{self.schedule} x{self.n_stages}{v} "
                f"part={self.partitioner}:{self.partition.sizes()} "
                f"s_fwd={self.s_fwd} s_bwd={self.s_bwd} "
                f"bottleneck={self.bottleneck_s:.2e}s]")


def _profile(config, profile, *, n_layers, default_layers, profile_method,
             batch, seq, device):
    if profile is not None:
        return profile
    if config is not None:
        return pf.profile_model(config, method=profile_method, batch=batch,
                                seq=seq, device=device)
    L = n_layers if n_layers is not None else default_layers
    return pf.synthetic_profile([1.0] * L)


def plan(config=None, n_stages: int = 2, *, schedule: str = "1f1b_rr",
         partitioner: str = "dp", profile: Optional[pf.ModelProfile] = None,
         profile_method: str = "analytic", batch: int = 1, seq: int = 32,
         n_layers: Optional[int] = None, virtual_stages: int = 1,
         n_microbatches: Optional[int] = None,
         keep_ir: bool = True, validate: bool = True,
         device="cuda") -> PipelinePlan:
    """Build a :class:`PipelinePlan` (the JAX twin's arguments, plus
    ``device``: where ``profile_method="timed"`` runs its block).

    ``config`` is an ``ArchConfig`` (profiled via ``profile_method`` at
    the run's ``batch``/``seq`` shape), or None with an explicit
    ``profile`` or bare ``n_layers`` (uniform unit costs).
    ``schedule`` ∈ {"1f1b_rr", "gpipe", "stream", "1f1b", "2bw",
    "interleaved"}.  ``virtual_stages`` (interleaved only) is the chunk
    count v per device; the partition then splits layers into
    ``n_stages·v`` chunk-stages.  ``n_microbatches`` overrides the
    schedule's default round/group size (must divide the run's batch for
    the IR interpreter).
    """
    if schedule not in ir.EMITTERS:
        raise KeyError(
            f"unknown schedule {schedule!r}; known: {sorted(ir.EMITTERS)}")
    if virtual_stages < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {virtual_stages}")
    if virtual_stages > 1 and schedule != "interleaved":
        raise ValueError(
            f"virtual_stages={virtual_stages} requires "
            f"schedule='interleaved', got {schedule!r}")
    n_chunks = n_stages * virtual_stages
    profile = _profile(config, profile, n_layers=n_layers,
                       default_layers=n_chunks,
                       profile_method=profile_method, batch=batch, seq=seq,
                       device=device)
    if profile.n_layers < n_chunks:
        raise ValueError(f"{profile.n_layers} layers cannot fill "
                         f"{n_chunks} (chunk-)stages")

    part = pt.partition_profile(profile, n_chunks, method=partitioner)
    costs = pt.profile_stage_costs(profile, part)
    ucost = pt.profile_bottleneck(
        profile, pt.uniform(profile.n_layers, n_chunks))

    kw = {}
    if schedule == "interleaved":
        kw["v"] = virtual_stages
    if n_microbatches is not None and schedule in ROUND_SCHEDULES:
        kw["n_microbatches"] = n_microbatches
    sched = ir.emit(schedule, n_stages, **kw)
    if validate:
        sched.validate()
    mb = sched.steady_minibatch()
    return PipelinePlan(
        n_stages=n_stages, schedule=schedule,
        s_fwd=sched.staleness_vector("forward", mb),
        s_bwd=sched.staleness_vector("backward", mb),
        bwd_lag=tuple(sched.bwd_lag(k, mb) for k in range(n_chunks)),
        fb_gap=tuple(sched.fwd_bwd_gap(k, mb) for k in range(n_chunks)),
        partition=part, partitioner=partitioner,
        bottleneck_s=max(costs), uniform_bottleneck_s=ucost,
        stage_costs_s=costs, virtual_stages=virtual_stages,
        round_microbatches=sched.round_microbatches,
        bubble_frac=sched.bubble_fraction(),
        act_stash=tuple(sched.peak_activation_stash(k)
                        for k in range(n_chunks)),
        w_stash_depth=tuple(sched.weight_stash_depth(k)
                            for k in range(n_chunks)),
        profile=profile, ir=sched if keep_ir else None)


@dataclass(frozen=True)
class ServePlan:
    """One serving layout: the stage partition plus the round geometry —
    live decode slots (``n_slots``), prompts admitted per round
    (``max_prefill``), the per-lane prompt budget (``prompt_budget``)
    and the KV paging (``n_pages`` pages of ``page_seq`` positions; a
    request's prompt + generation is capped at ``page_seq``).  Serving
    folds one chunk per device: ``n_chunks == n_devices == n_stages``."""
    n_stages: int
    partition: pt.Partition
    n_slots: int
    max_prefill: int
    prompt_budget: int
    n_pages: int
    page_seq: int
    schedule: str = "serve"
    partitioner: str = "uniform"

    @property
    def n_chunks(self) -> int:
        return self.n_stages

    @property
    def n_devices(self) -> int:
        return self.n_stages

    @property
    def stage_ranges(self) -> Tuple[Tuple[int, int], ...]:
        return self.partition.stages()

    @property
    def stage_sizes(self) -> Tuple[int, ...]:
        return self.partition.sizes()

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
                f"part={self.partitioner}:{self.partition.sizes()} "
                f"slots={self.n_slots} prefill={self.max_prefill} "
                f"P={self.prompt_budget} pages={self.n_pages}"
                f"x{self.page_seq}]")


def serve_plan(config=None, n_stages: int = 2, *, n_slots: int = 4,
               max_prefill: int = 1, prompt_budget: int = 16,
               n_pages: Optional[int] = None, page_seq: int = 64,
               n_layers: Optional[int] = None,
               partitioner: str = "uniform",
               profile: Optional[pf.ModelProfile] = None,
               profile_method: str = "analytic",
               validate: bool = True, device="cuda") -> ServePlan:
    """Build a :class:`ServePlan` with the JAX twin's validation.

    ``config`` is an ``ArchConfig`` (profiled like :func:`plan` at
    ``[n_slots, page_seq]``), or None with bare ``n_layers`` (unit
    costs).  ``n_pages`` defaults to ``n_slots``; ``page_seq`` must cover
    ``prompt_budget``.  With ``validate`` the round's compiled artifacts
    are verified (:meth:`ServePlan.verify`)."""
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
    profile = _profile(config, profile, n_layers=n_layers,
                       default_layers=n_stages,
                       profile_method=profile_method, batch=n_slots,
                       seq=page_seq, device=device)
    if profile.n_layers < n_stages:
        raise ValueError(f"{profile.n_layers} layers cannot fill "
                         f"{n_stages} stages")
    splan = ServePlan(
        n_stages=n_stages,
        partition=pt.partition_profile(profile, n_stages,
                                       method=partitioner),
        n_slots=n_slots, max_prefill=max_prefill,
        prompt_budget=prompt_budget, n_pages=n_pages, page_seq=page_seq,
        partitioner=partitioner)
    if validate:
        splan.verify()
    return splan


def check_against_closed_forms(p: PipelinePlan) -> None:
    """Raise if IR-derived staleness differs from ``core/spectrain.py``'s
    closed forms — the property the planner exists to make checkable."""
    from repro_torch.core import spectrain as st
    closed = {"1f1b_rr": st.version_difference_paper,
              "stream": st.version_difference_stream,
              "1f1b": st.version_difference_1f1b,
              "interleaved": st.version_difference_1f1b,
              "2bw": st.version_difference_2bw}
    if p.schedule == "gpipe":
        if any(p.s_fwd) or any(p.s_bwd):
            raise AssertionError(f"gpipe must be staleness-free, got {p}")
        return
    fn = closed[p.schedule]
    for k in range(p.n_chunks):
        for phase, vec in (("forward", p.s_fwd), ("backward", p.s_bwd)):
            want = fn(k, p.n_chunks, phase)
            if vec[k] != want:
                raise AssertionError(
                    f"{p.schedule} stage {k} {phase}: IR-derived {vec[k]} "
                    f"!= closed form {want}")
