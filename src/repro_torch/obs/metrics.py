"""Structured telemetry: counters / gauges / histograms + event JSONL.

The port's own copy of ``repro/obs/metrics.py`` (pure Python).

One registry instance per process (train or serve driver, tests).  Two
surfaces:

  * **instruments** — ``registry.counter(name)`` / ``gauge`` /
    ``histogram``: in-memory aggregates, dumped as one ``summary`` event
    on :meth:`MetricsRegistry.close` and renderable as a table
    (:meth:`MetricsRegistry.summary`);
  * **events** — ``registry.emit("heartbeat_missed", worker=3, ...)``:
    one JSON line per event, appended and flushed immediately (so a
    KeyboardInterrupt or crash loses nothing), and kept in
    ``registry.events`` for tests.

``train.py``'s human and ``--json`` step records both come from
:meth:`log_step` — one record-construction code path, two formatters
(``json.dumps`` and :func:`format_step`).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming aggregate + a bounded sample reservoir for quantiles
    (first ``cap`` observations — ample for driver-scale runs)."""
    __slots__ = ("count", "total", "min", "max", "_sample", "_cap")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._sample: List[float] = []
        self._cap = cap

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._sample) < self._cap:
            self._sample.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100], nearest-rank over the reservoir."""
        if not self._sample:
            return 0.0
        xs = sorted(self._sample)
        i = min(len(xs) - 1, max(0, round(q / 100.0 * (len(xs) - 1))))
        return xs[i]

    def snapshot(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Counters/gauges/histograms + structured events -> JSONL.

    ``jsonl_path=None`` keeps everything in memory (tests, tracing-only
    runs); with a path, every event is one appended-and-flushed JSON
    line.  Usable as a context manager; :meth:`close` is idempotent and
    safe to call from a ``finally`` after KeyboardInterrupt.
    """

    def __init__(self, jsonl_path: Optional[str] = None, *,
                 clock: Callable[[], float] = time.time):
        self.clock = clock
        self.events: List[Dict[str, Any]] = []
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._path = jsonl_path
        self._file = open(jsonl_path, "a") if jsonl_path else None

    # --------------------------------------------------------- instruments
    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._hists.setdefault(name, Histogram())

    def kernel_hook(self) -> Callable[[str, float], None]:
        """Timing hook for ``kernels.ops.set_timing_hook``: feeds each
        (kernel name, microseconds) sample into a histogram."""
        def hook(name: str, us: float) -> None:
            self.histogram(f"kernel/{name}_us").observe(us)
        return hook

    # -------------------------------------------------------------- events
    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"event": event, "t": self.clock(), **fields}
        self.events.append(rec)
        if self._file is not None:
            json.dump(rec, self._file)
            self._file.write("\n")
            self._file.flush()
        return rec

    def log_step(self, *, step: int, loss: float, tok_per_s: float,
                 **extra: Any) -> Dict[str, Any]:
        """The train driver's per-step record — the single code path
        behind both the human line and ``--json`` stdout, also emitted
        to the JSONL stream as a ``train_step`` event."""
        rec = {"step": step, "loss": loss, "tok_per_s": tok_per_s, **extra}
        self.counter("train/steps_logged").inc()
        self.gauge("train/loss").set(loss)
        self.gauge("train/tok_per_s").set(tok_per_s)
        self.emit("train_step", **rec)
        return rec

    def find(self, event: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("event") == event]

    # ------------------------------------------------------------- summary
    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.snapshot() for k, h in self._hists.items()},
        }

    def summary(self) -> str:
        snap = self.snapshot()
        lines = ["# metric                                  value"]
        for k, v in sorted(snap["counters"].items()):
            lines.append(f"# {k:<40} {v:g}")
        for k, v in sorted(snap["gauges"].items()):
            lines.append(f"# {k:<40} "
                         f"{'-' if v is None else format(v, 'g')}")
        for k, h in sorted(snap["histograms"].items()):
            if not h.get("count"):
                continue
            lines.append(
                f"# {k:<40} n={h['count']} mean={h['mean']:.1f} "
                f"p50={h['p50']:.1f} p99={h['p99']:.1f} max={h['max']:.1f}")
        return "\n".join(lines)

    def close(self) -> None:
        """Emit a final ``summary`` event and close the JSONL stream —
        idempotent, and the KeyboardInterrupt flush path."""
        if self._file is not None:
            self.emit("summary", **self.snapshot())
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def format_step(rec: Dict[str, Any]) -> str:
    """Human rendering of a :meth:`MetricsRegistry.log_step` record
    (with an MoE model's aux loss when the record has one)."""
    aux = f"  aux {rec['aux']:.4f}" if "aux" in rec else ""
    return (f"step {rec['step']:5d}  loss {rec['loss']:.4f}{aux}  "
            f"tok/s {rec['tok_per_s']}")
