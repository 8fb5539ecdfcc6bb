"""Chrome/Perfetto trace export + schema validation (twin of
``repro/obs/perfetto.py``).

Emits the Trace Event Format JSON that both ``chrome://tracing`` and
https://ui.perfetto.dev load: an object with a ``traceEvents`` list of
complete-duration (``"ph": "X"``) events, one **process** per lane group
(pid 0 = measured, pid 1 = predicted) and one **thread lane per pipe
device** (per rank under stage-local execution) inside each, named via
``"M"`` metadata events.  Timestamps are microseconds relative to the
timeline origin.

``validate_trace`` is the schema check the trace tests and
``chip_smoke.py`` run; ``python -m repro_torch.obs.perfetto
trace.json`` validates a file from the command line.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

PID_MEASURED, PID_PREDICTED = 0, 1
_LANE_NAMES = {PID_MEASURED: "measured", PID_PREDICTED: "predicted"}


def _lane_events(spans, pid: int, label: str) -> List[Dict[str, Any]]:
    ev: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": label},
    }]
    devices = sorted({s.device for s in spans})
    for d in devices:
        ev.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": d,
                   "args": {"name": f"device {d}"}})
    for s in spans:
        ev.append({
            "ph": "X", "name": s.name, "pid": pid, "tid": s.device,
            "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
            "cat": s.args.get("op", "event"),
            "args": dict(s.args),
        })
    return ev


def trace_events(tracer) -> Dict[str, Any]:
    """Full trace object: measured lane group + the IR's predicted lane
    group, plus plan metadata for provenance."""
    m_spans, m_span = tracer.measured_timeline()
    p_spans, p_span = tracer.predicted_timeline()
    p = tracer.plan
    return {
        "traceEvents": (
            _lane_events(m_spans, PID_MEASURED,
                         f"measured ({p.schedule})") +
            _lane_events(p_spans, PID_PREDICTED,
                         f"predicted ({p.schedule} IR)")),
        "displayTimeUnit": "ms",
        "otherData": {
            "schedule": p.schedule,
            "n_stages": p.n_stages,
            "n_chunks": p.n_chunks,
            "partition": list(p.stage_sizes),
            "measured_makespan_s": m_span,
            "predicted_makespan_s": p_span,
            "steps_recorded": tracer.n_steps(),
        },
    }


def validate_trace(obj: Any) -> List[str]:
    """Schema problems in a trace object (empty list = valid).

    Checks the invariants Perfetto needs to render the two lane groups:
    a ``traceEvents`` list; every event a dict with a string ``name``
    and ``ph`` in {"X", "M"}; every "X" event carrying finite
    non-negative ``ts``/``dur`` and integer ``pid``/``tid``; and at
    least one "X" event in each of the measured and predicted groups.
    """
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"trace must be a JSON object, got {type(obj).__name__}"]
    ev = obj.get("traceEvents")
    if not isinstance(ev, list):
        return ["missing or non-list traceEvents"]
    seen_x = set()
    for i, e in enumerate(ev):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"{where}: ph={ph!r} not in ('X', 'M')")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            problems.append(f"{where}: missing name")
        if not isinstance(e.get("pid"), int) or \
                not isinstance(e.get("tid"), int):
            problems.append(f"{where}: pid/tid must be ints")
            continue
        if ph == "X":
            seen_x.add(e["pid"])
            for fld in ("ts", "dur"):
                v = e.get(fld)
                ok = isinstance(v, (int, float)) and v == v \
                    and v not in (float("inf"), float("-inf")) and v >= 0
                if not ok:
                    problems.append(
                        f"{where}: {fld}={v!r} not a finite number >= 0")
    for pid, label in _LANE_NAMES.items():
        if pid not in seen_x:
            problems.append(f"no span events in the {label!r} lane group "
                            f"(pid {pid})")
    return problems


def write_trace(path: str, tracer) -> Dict[str, Any]:
    """Build, validate and write the trace JSON; returns the object."""
    obj = trace_events(tracer)
    problems = validate_trace(obj)
    if problems:
        raise ValueError("invalid trace: " + "; ".join(problems))
    with open(path, "w") as f:
        json.dump(obj, f)
        f.write("\n")
    return obj


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a Perfetto trace JSON file")
    ap.add_argument("trace", help="path to a trace JSON file")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        obj = json.load(f)
    problems = validate_trace(obj)
    for p in problems:
        print(f"INVALID: {p}")
    if not problems:
        n = sum(1 for e in obj["traceEvents"] if e.get("ph") == "X")
        print(f"OK: {n} span events across "
              f"{len({e['pid'] for e in obj['traceEvents']})} lane groups")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
