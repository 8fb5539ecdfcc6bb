"""The port's pipeline tracer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on the CPU.

The parts that are pure Python over the plan are held to the JAX
results exactly, or within 1e-12 where a float passes through a sum:
the per-event metadata and tick groups of every round schedule, the
timeline reconstruction and its stats on uniform and non-uniform
durations, and the whole report path — the two tracers filled through
``wrap_step`` with the same fake-clock readings give the same rounds,
timelines, drift report, formatted drift (string-equal) and trace JSON
(JSON-equal), for per-event marks, tick-group marks and the stream tick
with probed stage costs; ``validate_trace`` reports the same problems.
No JAX step is compiled: the JAX tracer wraps a plain Python step that
marks as the interpreter would.

On the port's IR interpreter (a 4-layer smoke granite, d_model 64,
fp32): a traced round is bit-equal to an untraced one on both backends,
the marks arrive in ``round_event_metas`` order (a recording clock
interleaved with the event bodies' calls) and a round files exactly
``len(metas)`` marks.  The launcher writes a valid trace and prints the
drift report under ``--trace``, and still refuses it with ``--mode
sync`` and ``--pipe 1``.  Stage-local rounds on spawned ranks are
``tests/test_torch_obs_mpmd.py``'s.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import trace as jtrace
from repro.planner import plan as jplan
from repro.planner import synthetic_profile as jsynthetic
from repro_torch import obs as tobs
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import pipeline_stream as tps
from repro_torch.launch import train as ttrain
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.obs import trace as ttrace
from repro_torch.planner import plan as tplan
from repro_torch.planner import synthetic_profile as tsynthetic
from test_torch_threads import one_thread  # noqa: F401

TOL = 1e-12
COSTS = [1.0 + 0.5 * (i % 3) + (2.0 if i == 0 else 0.0) for i in range(8)]
# (schedule, S, v, M)
ROUND_CASES = [("gpipe", 2, 1, 4), ("1f1b", 2, 1, 4), ("1f1b", 3, 1, 3),
               ("2bw", 2, 1, 2), ("2bw", 3, 1, 4),
               ("interleaved", 2, 2, 4), ("interleaved", 2, 2, 2)]
ROUND_IDS = [f"{s}-S{S}-v{v}-M{M}" for s, S, v, M in ROUND_CASES]


class FakeClock:
    """+1.0 s per reading, or the next of ``steps`` (cycled)."""

    def __init__(self, steps=(1.0,)):
        self.t, self.steps, self.i = 0.0, list(steps), 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


def _plans(schedule, S, v, M, **kw):
    """The JAX and the port plan of the same arguments."""
    args = dict(n_stages=S, schedule=schedule, virtual_stages=v,
                n_microbatches=M, partitioner="dp", **kw)
    costs = COSTS[:S * v * 2]
    return (jplan(profile=jsynthetic(costs, act_bytes=3e5), **args),
            tplan(profile=tsynthetic(costs, act_bytes=3e5), **args))


def _close(got, want, what="report"):
    """Equal structure; floats within TOL (absolute and relative)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL * max(1.0, abs(want)), \
            (what, got, want)
    else:
        assert got == want, (what, got, want)


def _spans(spans):
    return [(s.device, s.name, s.t0, s.dur, s.args) for s in spans]


# ------------------------------------------------------- plan helpers
@pytest.mark.parametrize("case", ROUND_CASES, ids=ROUND_IDS)
def test_metas_and_tick_groups_equal_jax(case):
    jp, tp = _plans(*case)
    assert ttrace.round_event_metas(tp) == jtrace.round_event_metas(jp)
    assert ttrace.device_stream_tick_groups(tp) == \
        jtrace.device_stream_tick_groups(jp)
    # the MPMD mark count: one device-stream row per tick group
    assert tp.device_streams().rows.shape[0] == \
        len(ttrace.device_stream_tick_groups(tp))


@pytest.mark.parametrize("case", ROUND_CASES, ids=ROUND_IDS)
@pytest.mark.parametrize("durs", ["uniform", "ragged"])
def test_reconstruction_equals_jax(case, durs):
    jp, tp = _plans(*case)
    metas = ttrace.round_event_metas(tp)
    n = len(metas)
    d = ([1.0] * n if durs == "uniform" else
         list(np.random.default_rng(n).uniform(1e-4, 3e-2, n)))
    ts, tm = ttrace._reconstruct(metas, d)
    js, jm = jtrace._reconstruct(jtrace.round_event_metas(jp), d)
    _close(_spans(ts), _spans(js), "spans")
    _close(tm, jm, "makespan")
    _close(ttrace.timeline_stats(ts, tm, tp.n_devices),
           jtrace.timeline_stats(js, jm, jp.n_devices), "stats")
    with pytest.raises(ValueError):
        ttrace._reconstruct(metas, d[:-1])


# ------------------------------------------------------- reports
def _mark_step(tracer, n):
    """A plain step that marks ``n`` times, as a traced round does."""
    def step(state, batch):
        for _ in range(n):
            tracer._mark()
        return state, {"loss": 0.0}
    return step


def _reports(tracer):
    return {"rounds": tracer.rounds, "walls": tracer.step_walls,
            "dropped": tracer.dropped_rounds,
            "measured": _spans(tracer.measured_timeline()[0]),
            "predicted": _spans(tracer.predicted_timeline()[0]),
            "stages": tracer.measured_stage_costs(),
            "staleness": tracer.staleness_histogram()}


def _same_reports(tt, jt):
    _close(_reports(tt), _reports(jt))
    _close(tobs.drift_report(tt), jobs.drift_report(jt), "drift")
    assert tobs.format_drift(tobs.drift_report(tt)) == \
        jobs.format_drift(jobs.drift_report(jt))
    t_obj = json.loads(json.dumps(tobs.trace_events(tt)))
    j_obj = json.loads(json.dumps(jobs.trace_events(jt)))
    _close(t_obj, j_obj, "trace")
    assert tobs.validate_trace(t_obj) == []


@pytest.mark.parametrize("case", ROUND_CASES, ids=ROUND_IDS)
@pytest.mark.parametrize("marks", ["events", "ticks"])
def test_reports_equal_jax(case, marks, tmp_path):
    """Per-event marks and JAX's tick-group attribution (one duration a
    tick for every event in it), 3 rounds with ragged clock steps, one
    round short of a mark (dropped)."""
    jp, tp = _plans(*case)
    steps = list(np.random.default_rng(7).uniform(1e-3, 5e-2, 97))
    jt = jobs.PipelineTracer(jp, clock=FakeClock(steps))
    tt = tobs.PipelineTracer(tp, clock=FakeClock(steps))
    n = len(tt.metas)
    if marks == "ticks":
        groups = ttrace.device_stream_tick_groups(tp)
        jt.set_tick_groups(jtrace.device_stream_tick_groups(jp))
        tt.set_tick_groups(groups)
        n = len(groups)
    for k in (n, n, n - 1, n):
        for tr in (jt, tt):
            tr.wrap_step(_mark_step(tr, k))(None, None)
    assert len(tt.rounds) == 3 and tt.dropped_rounds == 1
    _same_reports(tt, jt)
    # the file the launcher writes is the same object
    obj = tobs.write_trace(str(tmp_path / "t.json"), tt)
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads(json.dumps(obj))


def test_tick_groups_must_cover_every_event():
    jp, tp = _plans("1f1b", 2, 1, 4)
    tt = tobs.PipelineTracer(tp)
    with pytest.raises(ValueError, match="cover"):
        tt.set_tick_groups([[0, 1]])


@pytest.mark.parametrize("probed", [True, False])
def test_stream_reports_equal_jax(probed):
    """The stream tick: step walls attributed by probed stage costs (or
    the plan's modelled ones), as JAX's."""
    from conftest import tiny_cfg
    from test_torch_model import port_cfg
    jcfg = tiny_cfg("granite-8b", n_layers=4, pipe=2)
    jp = jplan(jcfg, n_stages=2, schedule="stream", batch=4, seq=16)
    tp = tplan(port_cfg(jcfg), n_stages=2, schedule="stream", batch=4,
               seq=16)
    steps = [0.25, 0.5, 0.125]
    jt = jobs.PipelineTracer(jp, clock=FakeClock(steps))
    tt = tobs.PipelineTracer(tp, clock=FakeClock(steps))
    for tr in (jt, tt):
        if probed:
            tr.set_probed([2e-3, 3e-3])
        for _ in range(4):
            tr.wrap_step(_mark_step(tr, 0))(None, None)
    assert tt.rounds == [] and tt.n_steps() == 4
    if probed:
        _same_reports(tt, jt)
        return
    for tr in (jt, tt):
        with pytest.raises(ValueError, match="probe"):
            tr.measured_stage_costs()
    _close(_spans(tt.measured_timeline()[0]),
           _spans(jt.measured_timeline()[0]))


def test_validate_trace_reports_as_jax():
    good = {"traceEvents": [
        {"ph": "X", "name": "e", "pid": 0, "tid": 0, "ts": 0.0, "dur": 1.0},
        {"ph": "X", "name": "e", "pid": 1, "tid": 0, "ts": 0.0, "dur": 1}]}
    broken = [
        [], {}, {"traceEvents": 3}, {"traceEvents": [{"ph": "Z"}]},
        {"traceEvents": ["x", {"ph": "X", "name": "", "pid": 0,
                               "tid": 0.5}]},
        {"traceEvents": [
            {"ph": "X", "name": "e", "pid": 0, "tid": 0,
             "ts": float("nan"), "dur": -1.0},
            {"ph": "X", "name": "e", "pid": 1, "tid": 0,
             "ts": float("inf"), "dur": "1"}]},
        {"traceEvents": good["traceEvents"][:1]},
        {"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0,
                          "tid": 0}]},
    ]
    assert tobs.validate_trace(good) == jobs.validate_trace(good) == []
    for obj in broken:
        want = jobs.validate_trace(obj)
        assert want and tobs.validate_trace(obj) == want


def test_perfetto_cli(tmp_path, capsys):
    from repro_torch.obs import perfetto
    jp, tp = _plans("1f1b", 2, 1, 4)
    tt = tobs.PipelineTracer(tp, clock=FakeClock())
    for _ in range(2):
        tt.wrap_step(_mark_step(tt, len(tt.metas)))(None, None)
    tobs.write_trace(str(tmp_path / "t.json"), tt)
    assert perfetto.main([str(tmp_path / "t.json")]) == 0
    assert "OK: 32 span events across 2 lane groups" in \
        capsys.readouterr().out
    (tmp_path / "bad.json").write_text('{"traceEvents": []}')
    assert perfetto.main([str(tmp_path / "bad.json")]) == 1


class _FakeGroup:
    """A stage group whose gather returns given per-rank tick durations
    (rank 0's own entry replaced by what it sends)."""

    def __init__(self, world, others):
        self.world, self.others = world, others

    def all_gather_object(self, obj):
        return [obj] + list(self.others)


def test_stage_group_lanes_take_each_ranks_ticks():
    """Under MPMD each event of tick t on device d takes rank d's tick t:
    the measured lanes are the ranks' own durations."""
    jp, tp = _plans("1f1b", 2, 1, 4)
    groups = ttrace.device_stream_tick_groups(tp)
    T = len(groups)
    other = [0.5 + t for t in range(T)]
    tt = tobs.PipelineTracer(tp, clock=FakeClock())
    with pytest.raises(ValueError, match="rows"):
        tt.set_stage_group(_FakeGroup(2, []), T + 1)
    tt.set_stage_group(_FakeGroup(2, [(T, other)]), T)
    tt.wrap_step(_mark_step(tt, T))(None, None)
    (ev,) = tt.rounds
    for t, grp in enumerate(groups):
        for i in grp:
            want = 1.0 if tt.metas[i]["device"] == 0 else other[t]
            assert ev[i] == want
    spans, _ = tt.measured_timeline()
    assert {s.device for s in spans} == {0, 1}
    # a rank short of a mark drops the round on every rank
    tt.group = _FakeGroup(2, [(T - 1, None)])
    tt.wrap_step(_mark_step(tt, T))(None, None)
    assert len(tt.rounds) == 1 and tt.dropped_rounds == 1


# ------------------------------------------------- the IR interpreter
def _smoke(S=2, n_layers=4):
    cfg = smoke_config(get_config("granite-8b"))
    cfg = cfg.replace(n_layers=n_layers, param_dtype="float32",
                      compute_dtype="float32",
                      mesh_plan=dataclasses.replace(cfg.mesh_plan, pipe=S,
                                                    tensor=1))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, size=(4, 17)).astype(np.int64)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return model, params, batches


def _run_ir(model, params, pplan, batches, backend, tracer=None):
    state = tps.make_ir_state(model, tree_map(lambda _, a: a.clone(),
                                              params), plan=pplan)
    step = tps.make_ir_train_step(model, plan=pplan, lr=0.05,
                                  backend=backend, tracer=tracer)
    if tracer is not None:
        step = tracer.wrap_step(step)
    losses = [step(state, b)[1]["loss"] for b in batches]
    return state, losses


@pytest.mark.parametrize("backend", tps.IR_BACKENDS)
@pytest.mark.parametrize("schedule,v,M", [("1f1b", 1, 4), ("2bw", 1, 2),
                                          ("interleaved", 2, 2)])
def test_traced_round_bit_equal_and_ordered(backend, schedule, v, M,
                                            monkeypatch):
    model, params, batches = _smoke(2, 4)
    pplan = tplan(model.cfg, n_stages=2, schedule=schedule,
                  virtual_stages=v, n_microbatches=M, batch=4, seq=16)
    plain, l_plain = _run_ir(model, params, pplan, batches, backend)
    log = []

    class Recording(FakeClock):
        def __call__(self):
            log.append(("mark",))
            return super().__call__()

    for name in ("embed", "fwd", "head", "bwd", "embed_bwd"):
        orig = getattr(tps._Round, name)

        def rec(self, *a, _name=name, _orig=orig, **kw):
            log.append((_name,) + tuple(int(x) for x in a[:2]
                                        if isinstance(x, (int, np.integer))))
            return _orig(self, *a, **kw)
        monkeypatch.setattr(tps._Round, name, rec)
    tracer = tobs.PipelineTracer(pplan, clock=Recording())
    traced, l_traced = _run_ir(model, params, pplan, batches, backend,
                               tracer)
    assert [float(x) for x in l_traced] == [float(x) for x in l_plain]
    for key in ("params", "momentum") + (("stash",) if "stash" in plain
                                        else ()):
        for a, b in zip(tree_leaves(traced[key]), tree_leaves(plain[key])):
            assert torch.equal(a, b), key
    metas, C = tracer.metas, pplan.n_chunks
    assert len(tracer.rounds) == len(batches) and tracer.dropped_rounds == 0
    assert all(len(r) == len(metas) for r in tracer.rounds)
    # each round: a start reading, then one event's calls before each
    # mark, in metas order; then the step's wall reading
    per_round = 1 + sum(1 for e in log if e[0] != "mark") // len(batches) \
        + len(metas) + 1
    for k in range(len(batches)):
        rnd = log[k * per_round:(k + 1) * per_round]
        assert rnd[0] == ("mark",) and rnd[-1] == ("mark",)
        body, i, ev = rnd[1:-1], 0, []
        for e in body:
            if e != ("mark",):
                ev.append(e)
                continue
            m = metas[i]
            q, s, mb = m["chunk"], m["wv"], m["mb"]
            if m["kind"] == "fwd":
                want = ([("embed", mb, s)] if q == 0 else []) + \
                    [("fwd", q, s)]
            else:
                want = ([("head", mb, s)] if q == C - 1 else []) + \
                    [("bwd", q, s)] + \
                    ([("embed_bwd", mb, s)] if q == 0 else [])
            assert ev == want, (k, i, m)
            ev, i = [], i + 1
        assert i == len(metas) and ev == []


def test_tracer_wiring_refusals():
    model, params, _ = _smoke(2, 4)
    one = tplan(model.cfg, n_stages=2, schedule="1f1b", n_microbatches=4)
    other = tplan(model.cfg, n_stages=2, schedule="1f1b", n_microbatches=2)
    with pytest.raises(ValueError, match="another plan"):
        tps.make_ir_train_step(model, plan=one, lr=0.05,
                               tracer=tobs.PipelineTracer(other))
    # a tracer made for another device than the model's (it touches no
    # card before its first mark)
    with pytest.raises(ValueError, match="device"):
        tps.make_ir_train_step(model, plan=one, lr=0.05,
                               tracer=tobs.PipelineTracer(one,
                                                          device="cuda:0"))


def test_runtime_trace_config():
    from repro_torch.api import Runtime, RuntimeConfig
    model, params, batches = _smoke(2, 4)
    pplan = tplan(model.cfg, n_stages=2, schedule="1f1b", n_microbatches=4)
    tracer = tobs.PipelineTracer(pplan, clock=FakeClock())
    with pytest.raises(ValueError, match="trace=True"):
        Runtime(pplan, model, RuntimeConfig(lr=0.05), tracer=tracer)
    rt = Runtime(pplan, model, RuntimeConfig(lr=0.05, trace=True),
                 tracer=tracer)
    state = rt.init_state(tree_map(lambda _, a: a.clone(), params))
    for b in batches:
        state, _ = rt.train_step(state, b)
    assert tracer.n_steps() == 3 and len(tracer.rounds) == 3
    assert all(d == 1.0 for r in tracer.rounds for d in r)
    # unit durations reproduce the plan's unit-cost bubble
    assert tobs.drift_report(tracer)["bubble"]["measured"] == \
        pytest.approx(pplan.bubble_frac)


def test_probe_stage_costs():
    model, params, _ = _smoke(2, 4)
    stages = model.partition_stage_params(params["stages"], (2, 2))
    costs = tobs.probe_stage_costs(model, stages, mb=2, seq=8,
                                   clock=FakeClock([0.5]))
    # a warm call, then 3 timed calls between two clock readings
    assert costs == [0.5 / 3, 0.5 / 3]


# ------------------------------------------------------- the launcher
@pytest.mark.parametrize("schedule", ["stream", "1f1b"])
def test_launcher_trace(schedule, tmp_path, capsys):
    path = tmp_path / "t.json"
    assert ttrain.main(["--smoke", "--device", "cpu", "--pipe", "2",
                        "--layers", "4", "--schedule", schedule, "--steps",
                        "3", "--seq", "16", "--trace", str(path)]) == 0
    out = capsys.readouterr().out
    obj = json.loads(path.read_text())
    assert tobs.validate_trace(obj) == []
    assert f"# trace written to {path} (3 steps recorded)" in out
    assert f"# drift report: {schedule} x2 partition=[2, 2] over 3 " \
           f"steps" in out
    assert "# bubble: measured" in out and "rel_err" in out
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    if schedule == "1f1b":
        assert "# trace rounds: 3 filed, 0 dropped, 16 events a round" \
            in out
        assert len(xs) == 2 * 16
    else:
        assert len(xs) == 2 * 2 * 2      # 2 steady steps x 2 stages x 2


@pytest.mark.parametrize("argv,why", [
    (["--mode", "sync"], "not traceable"),
    (["--pipe", "1"], "real pipeline"),
    (["--schedule", "1f1b", "--pipe", "1"], "real pipeline")])
def test_launcher_trace_refusals(argv, why):
    with pytest.raises(SystemExit, match=why):
        ttrain.main(["--smoke", "--device", "cpu", "--trace", "t.json"]
                    + argv)
