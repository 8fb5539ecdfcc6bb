"""The pipeline tracer on stage-local (MPMD) rounds: two spawned ranks
over gloo on the CPU (``repro_torch.launch.mesh.run_stage_ranks``), a
4-layer smoke granite in fp32, 1f1b, 4 microbatches a round.

Claims:
  * two traced rounds (``Runtime(..., tracer=)``) are bit-equal to two
    untraced rounds from the same weights: the losses and every leaf of
    the gathered state;
  * each rank marks once per row of its device stream; rank 0 files one
    per-event round each step, equal to what the JAX tracer files under
    ``set_tick_groups`` from the same uniform fake clock, and its drift
    report formats as JAX's;
  * an untraced round moves exactly the payloads the streams predict and
    no control message; a traced round moves the same payloads (its one
    gather is not a payload);
  * ``launch.train.main --execution mpmd --trace`` writes, on rank 0, a
    valid trace with one measured lane per rank and every event.

JAX is imported inside the test functions: the spawned ranks import
this module and need only torch.
"""
import json

import numpy as np
import torch

from repro_torch.core import pipeline_stream as tps
from repro_torch.launch.mesh import run_stage_ranks
from repro_torch.models.layers import tree_map
from test_torch_threads import one_thread  # noqa: F401

LR, M, ROUNDS = 0.05, 4, 2


class FakeClock:
    """+1.0 s per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _cfg():
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(get_config("granite-8b"))
    return cfg.replace(n_layers=4, param_dtype="float32",
                       compute_dtype="float32",
                       mesh_plan=dataclasses.replace(cfg.mesh_plan, pipe=2,
                                                     tensor=1))


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(ROUNDS):
        t = rng.integers(0, vocab, size=(4, 17)).astype(np.int64)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


def _traced_rank(group, cfg):
    """Two untraced rounds, then two traced rounds from the same weights
    through the Runtime facade: losses, payload counters, the gathered
    state of each, and (rank 0) the tracer's rounds and drift report."""
    from repro_torch import obs
    from repro_torch.api import Runtime, RuntimeConfig
    from repro_torch.models import Model
    from repro_torch.planner import plan
    from repro_torch.runtime import elastic
    model = Model(cfg, device="cpu")
    pl = plan(cfg, n_stages=2, schedule="1f1b", n_microbatches=M, batch=4,
              seq=16)
    batches = _batches(cfg.vocab_size)
    out = {"rows": int(pl.device_streams().rows.shape[0])}
    for label in ("plain", "traced"):
        params = model.init(torch.Generator().manual_seed(0))
        tracer = (obs.PipelineTracer(pl, clock=FakeClock())
                  if label == "traced" else None)
        rt = Runtime(pl, model, RuntimeConfig(
            lr=LR, execution="mpmd", trace=tracer is not None),
            group=group, tracer=tracer)
        state = rt.init_state(params)
        losses, counters = [], []
        for b in batches:
            group.reset_counters()
            state, met = rt.train_step(state, b)
            counters.append(group.counters())
            losses.append(None if met["loss"] is None
                          else float(met["loss"]))
        g = elastic.gather_mpmd_state(state, model, pl, group)
        rec = {"losses": losses, "counters": counters,
               "state": None if g is None else tree_map(
                   lambda _, a: a.numpy().copy()
                   if isinstance(a, torch.Tensor) else a, g)}
        if tracer is not None:
            rec.update(rounds=tracer.rounds, dropped=tracer.dropped_rounds,
                       walls=len(tracer.step_walls),
                       drift=obs.format_drift(obs.drift_report(tracer)))
        out[label] = rec
    return out


def _leaves(tree):
    from repro_torch.models.layers import tree_leaves
    return tree_leaves(tree)


def test_traced_mpmd_rounds():
    from repro import obs as jobs
    from repro.planner import plan as jplan
    from repro_torch.planner import plan as tplan
    cfg = _cfg()
    ranks = run_stage_ranks(_traced_rank, 2, "cpu", args=(cfg,),
                            timeout_s=300)
    pl = tplan(cfg, n_stages=2, schedule="1f1b", n_microbatches=M,
               batch=4, seq=16)
    pred = tps.mpmd_transfers(pl.device_streams())
    for r, rk in enumerate(ranks):
        # every rank marks once per row: no round dropped, all filed
        assert rk["traced"]["dropped"] == 0 and rk["traced"]["walls"] == 2
        assert len(rk["traced"]["rounds"]) == ROUNDS
        assert rk["traced"]["losses"] == rk["plain"]["losses"]
        want = (pred[r]["fwd_sent"] + pred[r]["bwd_sent"],
                pred[r]["fwd_recv"] + pred[r]["bwd_recv"], 0)
        for label in ("plain", "traced"):
            for c in rk[label]["counters"]:
                assert (c["n_sent"], c["n_recv"], c["n_ctl"]) == want
    s_plain, s_traced = ranks[0]["plain"]["state"], \
        ranks[0]["traced"]["state"]
    pl_leaves, tr_leaves = _leaves(s_plain), _leaves(s_traced)
    assert len(pl_leaves) == len(tr_leaves) > 0
    for a, b in zip(tr_leaves, pl_leaves):
        assert np.array_equal(a, b)
    # rank 0's rounds against the JAX tracer under set_tick_groups
    jp = jplan(_jax_cfg(cfg), n_stages=2, schedule="1f1b",
               n_microbatches=M, batch=4, seq=16)
    jt = jobs.PipelineTracer(jp, clock=FakeClock())
    jt.set_tick_groups(jobs.device_stream_tick_groups(jp))
    assert len(jt.tick_groups) == ranks[0]["rows"]

    def step(state, batch):
        for _ in range(len(jt.tick_groups)):
            jt._mark()
        return state, {}
    for _ in range(ROUNDS):
        jt.wrap_step(step)(None, None)
    assert ranks[0]["traced"]["rounds"] == jt.rounds
    assert ranks[0]["traced"]["drift"] == \
        jobs.format_drift(jobs.drift_report(jt))


def _jax_cfg(cfg):
    """The JAX ArchConfig with every field of the port's."""
    import dataclasses
    from repro.configs import base as jbase
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["mesh_plan"] = jbase.MeshPlan(**dataclasses.asdict(cfg.mesh_plan))
    return jbase.ArchConfig(**kw)


def test_launcher_mpmd_trace(tmp_path, capfd):
    from repro_torch.launch import train as ttrain
    from repro_torch.obs import validate_trace
    path = tmp_path / "t.json"
    assert ttrain.main(["--smoke", "--device", "cpu", "--pipe", "2",
                        "--layers", "4", "--schedule", "1f1b",
                        "--execution", "mpmd", "--steps", "2", "--seq",
                        "16", "--trace", str(path)]) == 0
    out = capfd.readouterr().out
    assert "# trace rounds: 2 filed, 0 dropped, 16 events a round" in out
    assert "# drift report: 1f1b x2" in out
    obj = json.loads(path.read_text())
    assert validate_trace(obj) == []
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X" and e["pid"] == 0]
    assert len(xs) == 16 and {e["tid"] for e in xs} == {0, 1}
    assert all(e["dur"] > 0 for e in xs)
