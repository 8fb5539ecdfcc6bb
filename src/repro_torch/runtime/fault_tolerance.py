"""Fault tolerance for long runs: the port's twin of
``repro/runtime/fault_tolerance.py``.

Three layers:

1. **Checkpoint/restart** — ``runtime.checkpoint`` + :class:`RestartManager`:
   crash ⇒ restore last committed step ⇒ identical trajectory (the data
   pipeline is a pure function of the step counter, so resume is exact).

2. **Straggler mitigation** — Chen et al. (2016)-style backup-worker
   drop: when a data replica misses its deadline, its gradient
   contribution is masked and the mean renormalized
   (:func:`masked_gradient_mean`, the host-level math of a masked
   all-reduce).

3. **Heartbeats** — :class:`HeartbeatMonitor` tracks per-worker progress
   and flags stragglers/failures for the launcher to act on (drop vs
   restart vs elastic shrink).

A library, as in the JAX package, whose launcher reads none of it.  The
port's train steps update their state in place, so a
:class:`RestartManager` run continues the state it is given and returns
the restored one after an injected failure.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.models.layers import tree_zip_map


# ---------------------------------------------------------------------------
# straggler math


def masked_gradient_mean(grad_shards: List[Any], alive: List[bool]):
    """Mean of per-replica gradients over the alive set (backup-worker
    semantics: slow replicas are dropped, not waited for), in fp32."""
    n = sum(alive)
    if n == 0:
        raise RuntimeError("all replicas dead")
    scale = 1.0 / n

    def combine(*leaves):
        tot = None
        for leaf, ok in zip(leaves, alive):
            if not ok:
                continue
            term = leaf.float()
            tot = term if tot is None else tot + term
        return tot * scale

    return tree_zip_map(combine, *grad_shards)


# ---------------------------------------------------------------------------
# heartbeats


@dataclass
class HeartbeatMonitor:
    """``registry`` (an ``obs.MetricsRegistry``, optional) receives one
    structured ``heartbeat_missed`` event per worker on the alive ->
    overdue transition and a ``heartbeat_recovered`` event when a
    flagged worker beats again — the launcher's audit trail for
    drop/restart/shrink decisions."""
    deadline_s: float = 30.0
    registry: Optional[Any] = None
    _last: Dict[int, float] = field(default_factory=dict)
    _step: Dict[int, int] = field(default_factory=dict)
    _flagged: set = field(default_factory=set)

    def beat(self, worker: int, step: int, now: Optional[float] = None):
        self._last[worker] = time.monotonic() if now is None else now
        self._step[worker] = step
        if worker in self._flagged:
            self._flagged.discard(worker)
            if self.registry is not None:
                self.registry.emit("heartbeat_recovered", worker=worker,
                                   step=step)

    def stragglers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        bad = [w for w, t in self._last.items()
               if now - t > self.deadline_s]
        for w in bad:
            if w not in self._flagged:
                self._flagged.add(w)
                if self.registry is not None:
                    self.registry.emit(
                        "heartbeat_missed", worker=w,
                        last_step=self._step.get(w, -1),
                        overdue_s=now - self._last[w] - self.deadline_s)
        return bad

    def alive_mask(self, workers: int,
                   now: Optional[float] = None) -> List[bool]:
        bad = set(self.stragglers(now))
        return [w in self._last and w not in bad for w in range(workers)]


# ---------------------------------------------------------------------------
# restart manager


class RestartManager:
    """Wraps a step function with checkpoint/restart over
    ``runtime.checkpoint`` (the JAX package's format).

    ``inject_failure_at`` simulates a node loss at a given step (tests).
    """

    def __init__(self, ckpt_dir: str, *, save_every: int = 10,
                 keep: int = 3,
                 inject_failure_at: Optional[int] = None,
                 registry: Optional[Any] = None):
        from repro_torch.runtime import checkpoint as ckpt
        self.ckpt = ckpt
        self.dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.inject_failure_at = inject_failure_at
        self.registry = registry
        self._failed = False

    def _emit(self, event: str, **fields):
        if self.registry is not None:
            self.registry.emit(event, **fields)

    def maybe_restore(self, state):
        step = self.ckpt.latest_step(self.dir)
        if step is None:
            return state, 0
        state, step = self.ckpt.restore(self.dir, state)
        self._emit("restore", step=step)
        return state, step + 1

    def run(self, state, step_fn: Callable, data, start: int, steps: int):
        """Run [start, steps); on injected failure, restore + replay."""
        s = start
        while s < steps:
            if (self.inject_failure_at is not None and not self._failed
                    and s == self.inject_failure_at):
                self._failed = True
                self._emit("failure_injected", step=s)
                state, s = self.maybe_restore(state)
                continue
            batch = data.batch_at(s)
            state, metrics = step_fn(state, batch)
            if (s + 1) % self.save_every == 0:
                self.ckpt.save(self.dir, state, s, keep=self.keep)
                self._emit("checkpoint_save", step=s)
            s += 1
        return state, s
