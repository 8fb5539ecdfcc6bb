"""Predicted-vs-measured drift report (twin of ``repro/obs/drift.py``).

Diffs the tracer's reconstructed measured timeline against the plan's
IR-derived metrics and the profiler's cost estimates:

  * **bubble**: realized idle fraction of device-tick slots vs the IR's
    ``plan.bubble_frac`` (unit-cost) and the cost-weighted predicted
    timeline's bubble;
  * **per-stage cost model**: measured per-stage forward seconds vs
    ``plan.stage_costs_s``, compared as shares of their totals so the
    host-vs-model absolute scale cancels — per-stage relative error
    > ~0.2 means the partition was computed from a miscalibrated
    profile and should be re-profiled (``--profile-method timed``);
  * **per-device busy/idle/P2P shares**: the Fig. 10 axes.  P2P is
    *modelled*, not measured on any card: cut activation bytes over the
    planner's modelled link (``planner/partition.py::LINK_BW``, the
    paper's P40 PCIe 3.0 x16 at 12 GB/s), reported alongside the
    breakdown.  Under stage-local execution the measured transport
    time sits inside each rank's tick spans;
  * **staleness histogram**: realized weight-version lags per phase vs
    the plan's ``s_fwd``/``s_bwd`` vectors.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.obs.trace import PipelineTracer, timeline_stats
from repro_torch.planner.partition import LINK_BW

# bytes/s effective per link: the planner's modelled P40 PCIe link, not a
# measured rate of this card
PCIE_BW = LINK_BW


def _shares(xs: List[float]) -> List[float]:
    tot = sum(xs)
    return [x / tot if tot else 0.0 for x in xs]


def _modelled_p2p_s(plan) -> float:
    """Per-cut activation transfer time from the plan's profile (0 when
    the profile carries no byte counts — synthetic profiles)."""
    prof = plan.profile
    if prof is None or not prof.layers:
        return 0.0
    act = max(lp.act_bytes for lp in prof.layers)
    return 2.0 * act / PCIE_BW      # activation fwd + cotangent bwd


def drift_report(tracer: PipelineTracer) -> Dict[str, Any]:
    plan = tracer.plan
    D = plan.n_devices
    m_spans, m_makespan = tracer.measured_timeline()
    p_spans, p_makespan = tracer.predicted_timeline()
    m_stats = timeline_stats(m_spans, m_makespan, D)
    p_stats = timeline_stats(p_spans, p_makespan, D)

    meas = tracer.measured_stage_costs()
    pred = list(plan.stage_costs_s) if any(plan.stage_costs_s) \
        else [1.0] * plan.n_chunks
    ms, ps = _shares(meas), _shares(pred)
    rel_err = [m / p - 1.0 if p else float("inf")
               for m, p in zip(ms, ps)]
    scale = (sum(meas) / sum(pred)) if sum(pred) else float("inf")

    return {
        "schedule": plan.schedule,
        "n_stages": plan.n_stages,
        "n_chunks": plan.n_chunks,
        "partition": list(plan.stage_sizes),
        "steps_recorded": tracer.n_steps(),
        "bubble": {
            "measured": m_stats["bubble_frac"],
            "predicted_ir": plan.bubble_frac,
            "predicted_weighted": p_stats["bubble_frac"],
            "drift": m_stats["bubble_frac"] - plan.bubble_frac,
        },
        "devices": {
            "busy_frac": m_stats["busy_frac"],
            "idle_frac": [1.0 - b for b in m_stats["busy_frac"]],
            "p2p_s_modelled": _modelled_p2p_s(plan),
            "makespan_s": m_stats["makespan_s"],
        },
        "stage_cost_model": {
            "measured_s": meas,
            "predicted_s": pred,
            "measured_share": ms,
            "predicted_share": ps,
            "rel_err": rel_err,
            "max_abs_rel_err": max(abs(e) for e in rel_err),
            "time_scale": scale,
        },
        "staleness": {
            "realized": tracer.staleness_histogram(),
            "plan_s_fwd": list(plan.s_fwd),
            "plan_s_bwd": list(plan.s_bwd),
        },
    }


def format_drift(rep: Dict[str, Any]) -> str:
    """Human-readable drift report (what ``train.py --trace`` prints)."""
    b = rep["bubble"]
    sc = rep["stage_cost_model"]
    dv = rep["devices"]
    lines = [
        f"# drift report: {rep['schedule']} x{rep['n_stages']} "
        f"partition={rep['partition']} over {rep['steps_recorded']} steps",
        f"# bubble: measured {b['measured']:.3f}  "
        f"ir-predicted {b['predicted_ir']:.3f}  "
        f"cost-weighted {b['predicted_weighted']:.3f}  "
        f"drift {b['drift']:+.3f}",
        "# device busy fractions: "
        + " ".join(f"d{i}={f:.2f}" for i, f in enumerate(dv['busy_frac']))
        + f"  (p2p modelled {dv['p2p_s_modelled']:.2e}s/cut)",
        "# stage  pred_s      meas_s      pred_share meas_share rel_err",
    ]
    for k, (p, m, psh, msh, e) in enumerate(zip(
            sc["predicted_s"], sc["measured_s"],
            sc["predicted_share"], sc["measured_share"], sc["rel_err"])):
        lines.append(f"#  s{k:<4d} {p:<11.3e} {m:<11.3e} "
                     f"{psh:<10.3f} {msh:<10.3f} {e:+.3f}")
    lines.append(
        f"# cost model: max |rel err| {sc['max_abs_rel_err']:.3f}, "
        f"wall/model time scale {sc['time_scale']:.2f}x")
    st = rep["staleness"]["realized"]
    lines.append(
        "# staleness (lag: events): fwd {"
        + ", ".join(f"{k}: {v}" for k, v in sorted(st["fwd"].items()))
        + "}  bwd {"
        + ", ".join(f"{k}: {v}" for k, v in sorted(st["bwd"].items()))
        + "}")
    return "\n".join(lines)
