"""The Runtime facade (twin of ``repro/api.py``): one config, one entry
point, both workloads.

``RuntimeConfig`` is the frozen bag of execution knobs (mode, schedule,
backend, execution, verify, trace, lr, gamma, clip, ticks_per_step);
``Runtime`` binds it to a planner artifact and a model:

    rt = Runtime(plan, model, RuntimeConfig(mode="spectrain", lr=2e-2))
    state = rt.init_state(model.init(gen), batch)
    state, metrics = rt.train_step(state, batch)       # PipelinePlan

    rt = Runtime(splan, model)
    results = rt.serve_step(params, requests)          # ServePlan

Dispatch is by plan type and schedule: a ``PipelinePlan`` with the
stream schedule runs the streaming tick runtime, one with a round
schedule the IR interpreter; a ``ServePlan`` the pipelined
``ServeEngine``.  There is no jit and no donation here: the steps update
their state in place, and :meth:`Runtime.train_step` calls the built
step.  ``execution="mpmd"`` and ``trace`` are not ported yet and raise.

``add_runtime_args`` / ``runtime_config_from_args`` are the argparse
wiring the training launcher builds its config from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.core import pipeline_stream as ps

_SCHEDULES = ("stream",) + ps.IR_SCHEDULES


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs for :class:`Runtime`, validated at construction.

    ``mode``       staleness-handling scheme (vanilla / pipedream /
                   spectrain); training only.
    ``schedule``   the schedule the plan was compiled for (``"stream"``
                   or an IR round schedule), cross-checked against the
                   plan at bind time; ``None`` adopts the plan's.
    ``backend``    the IR interpreter's round body (scan / unrolled).
    ``execution``  ``"spmd"`` (every chunk on the one device); the
                   stage-local ``"mpmd"`` is not ported yet.
    ``verify``     statically verify compiled schedule artifacts before
                   execution (``planner/verify.py``).
    ``trace``      the pipeline tracer; not ported yet.
    ``lr/gamma/clip/ticks_per_step``  optimizer and tick knobs.
    """
    mode: str = "spectrain"
    schedule: Optional[str] = None
    backend: str = "scan"
    execution: str = "spmd"
    verify: bool = True
    trace: bool = False
    lr: float = 1e-2
    gamma: float = 0.9
    clip: Optional[float] = None
    ticks_per_step: int = 1

    def __post_init__(self):
        if self.mode not in ps.MODES:
            raise ValueError(f"unknown mode {self.mode!r}; "
                             f"known: {ps.MODES}")
        if self.schedule is not None and self.schedule not in _SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"known: {_SCHEDULES}")
        if self.backend not in ps.IR_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"known: {ps.IR_BACKENDS}")
        if self.execution not in ps.EXECS:
            raise ValueError(f"unknown execution {self.execution!r}; "
                             f"known: {ps.EXECS}")
        if self.execution == "mpmd" and self.schedule == "stream":
            raise ValueError(
                "execution='mpmd' runs IR round schedules "
                f"({'/'.join(ps.IR_SCHEDULES)}) and serving rounds; "
                "the stream schedule is SPMD-only")
        if self.ticks_per_step < 1:
            raise ValueError(f"ticks_per_step must be >= 1, got "
                             f"{self.ticks_per_step}")

    def replace(self, **kw) -> "RuntimeConfig":
        return dataclasses.replace(self, **kw)


class Runtime:
    """A planner artifact bound to a model under one
    :class:`RuntimeConfig`.

    Training (``plan`` is a :class:`~repro_torch.planner.PipelinePlan`):
    :meth:`init_state` builds the schedule's train state from canonical
    init params and :meth:`train_step` runs one tick (stream) or one
    round (IR schedules).  Serving (``plan`` is a
    :class:`~repro_torch.planner.ServePlan`): :meth:`serve_engine`
    builds the pipelined ``ServeEngine`` and :meth:`serve_step` drives a
    request trace through it."""

    def __init__(self, plan, model, config: Optional[RuntimeConfig]
                 = None, *, registry=None):
        from repro_torch.planner.api import PipelinePlan, ServePlan
        if not isinstance(plan, (PipelinePlan, ServePlan)):
            raise TypeError(
                f"Runtime needs a planner PipelinePlan or ServePlan, "
                f"got {type(plan).__name__}")
        self.plan, self.model = plan, model
        self.config = config if config is not None else RuntimeConfig()
        self.registry = registry
        self.serving = isinstance(plan, ServePlan)
        if self.config.trace:
            raise NotImplementedError(
                "the pipeline tracer (obs/trace.py) is not ported to "
                "PyTorch yet")
        if self.config.execution == "mpmd":
            raise NotImplementedError(
                "execution='mpmd' (stage-local execution) is not ported "
                "to PyTorch yet; it is the next slice of the port")
        if not self.serving and self.config.schedule is not None \
                and self.config.schedule != plan.schedule:
            raise ValueError(
                f"RuntimeConfig.schedule={self.config.schedule!r} does "
                f"not match the plan's schedule {plan.schedule!r}")
        self._step: Optional[Callable] = None
        self._engine = None

    # ------------------------------------------------------------- training
    @property
    def _ir(self) -> bool:
        return (not self.serving
                and self.plan.schedule in ps.IR_SCHEDULES)

    def _training(self, what: str) -> None:
        if self.serving:
            raise TypeError(f"{what} is a training entry point; this "
                            f"Runtime binds a ServePlan — use "
                            f"serve_engine/serve_step")

    def init_state(self, params, batch=None) -> Dict[str, Any]:
        """Train state from canonical init ``params``
        (``model.init(gen)``); ``batch`` (an example global batch) is
        required by the streaming schedule's rings."""
        self._training("init_state")
        c = self.config
        if self._ir:
            return ps.make_ir_state(self.model, params, batch,
                                    plan=self.plan, mode=c.mode,
                                    execution=c.execution, verify=c.verify)
        return ps.make_state(self.model, params, batch, mode=c.mode,
                             ticks_per_step=c.ticks_per_step,
                             plan=self.plan)

    def train_step(self, state, batch):
        """One training step (round or tick group), built on first
        call."""
        self._training("train_step")
        if self._step is None:
            c = self.config
            if self._ir:
                self._step = ps.make_ir_train_step(
                    self.model, plan=self.plan, mode=c.mode, lr=c.lr,
                    gamma=c.gamma, clip=c.clip, backend=c.backend,
                    execution=c.execution)
            else:
                self._step = ps.make_train_step(
                    self.model, mode=c.mode, lr=c.lr, gamma=c.gamma,
                    clip=c.clip, ticks_per_step=c.ticks_per_step,
                    plan=self.plan)
        return self._step(state, batch)

    # -------------------------------------------------------------- serving
    def serve_engine(self, params):
        """The pipelined engine for ``params`` (built once and cached)."""
        if not self.serving:
            raise TypeError("serve_engine needs a ServePlan; this "
                            "Runtime binds a training PipelinePlan — "
                            "use init_state/train_step")
        if self._engine is None:
            from repro_torch.serve import ServeEngine
            self._engine = ServeEngine(
                self.model, params, self.plan, registry=self.registry,
                verify=self.config.verify)
        return self._engine

    def serve_step(self, params, requests, *,
                   max_rounds: Optional[int] = None) -> Dict[int, tuple]:
        """Drive ``requests`` (a trace of ``serve.Request``) through the
        engine to completion; returns ``{rid: emitted tokens}``."""
        return self.serve_engine(params).run(requests,
                                             max_rounds=max_rounds)


# ---------------------------------------------------------------- argparse


def add_runtime_args(ap) -> None:
    """Install the training launcher's RuntimeConfig flags on ``ap``."""
    ap.add_argument("--mode", default="spectrain",
                    choices=("sync",) + ps.MODES)
    ap.add_argument("--schedule", default="stream", choices=_SCHEDULES,
                    help="pipeline schedule: the streaming tick runtime "
                         "(default) or an IR-interpreted round schedule "
                         "(gpipe / 1f1b / 2bw / interleaved)")
    ap.add_argument("--ir-backend", default="scan", dest="ir_backend",
                    choices=ps.IR_BACKENDS,
                    help="round body for IR schedules: 'scan' interprets "
                         "the plan's event table row by row, 'unrolled' "
                         "walks the round program (the reference)")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--gamma", type=float, default=0.9)
    ap.add_argument("--clip", type=float, default=0.0)
    ap.add_argument("--execution", default=None, dest="execution",
                    choices=ps.EXECS,
                    help="execution backend: 'spmd' (default); 'mpmd' "
                         "(stage-local) is not ported yet")
    ap.add_argument("--no-verify", action="store_true", dest="no_verify",
                    help="skip the static schedule verifier "
                         "(planner/verify.py) that runs by default at "
                         "step construction")


def runtime_config_from_args(args, **overrides) -> RuntimeConfig:
    """The :class:`RuntimeConfig` of parsed launcher flags; ``overrides``
    win over flags."""
    kw: Dict[str, Any] = {
        "execution": getattr(args, "execution", None) or "spmd",
        "verify": not getattr(args, "no_verify", False),
    }
    if hasattr(args, "mode") and args.mode != "sync":
        kw["mode"] = args.mode
    for flag, key in (("schedule", "schedule"), ("ir_backend", "backend"),
                      ("lr", "lr"), ("gamma", "gamma")):
        if hasattr(args, flag):
            kw[key] = getattr(args, flag)
    if hasattr(args, "clip"):
        kw["clip"] = args.clip or None
    if getattr(args, "trace", ""):
        kw["trace"] = True
    kw.update(overrides)
    return RuntimeConfig(**kw)
