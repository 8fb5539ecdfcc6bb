"""The port's IR runtime around the interpreter: refusals, the Runtime
facade and its config (validated as the JAX twin's), and the training
launcher under every ``--schedule`` at ``--smoke --device cpu``.  The
round's numbers against JAX are ``tests/test_torch_ir_train.py``'s."""
import json

import numpy as np
import pytest

from repro.api import RuntimeConfig as JRuntimeConfig
from repro_torch.api import Runtime, RuntimeConfig
from repro_torch.core import pipeline_stream as tps
from repro_torch.launch import train as ttrain
from repro_torch.models.layers import tree_map
from repro_torch.planner import plan as tplan
from test_torch_train import LR, _batches, _pair


def _fresh(tree):
    return tree_map(lambda _, a: a.clone(), tree)


def test_refusals():
    cfg, jm, jparams, tm, tparams = _pair(2, 4)
    stream = tplan(tm.cfg, n_stages=2, schedule="stream")
    one = tplan(tm.cfg, n_stages=2, schedule="1f1b")
    with pytest.raises(ValueError, match="IR interpreter executes"):
        tps.make_ir_state(tm, tparams, plan=stream)
    with pytest.raises(ValueError, match="needs a plan"):
        tps.make_ir_train_step(tm, plan=None, lr=LR)
    with pytest.raises(NotImplementedError, match="mpmd"):
        tps.make_ir_state(tm, tparams, plan=one, execution="mpmd")
    with pytest.raises(NotImplementedError, match="mpmd"):
        tps.make_ir_train_step(tm, plan=one, lr=LR, execution="mpmd",
                               clip=1.0)
    with pytest.raises(NotImplementedError, match="trac"):
        tps.make_ir_train_step(tm, plan=one, lr=LR, tracer=object())
    with pytest.raises(ValueError, match="backend"):
        tps.make_ir_train_step(tm, plan=one, lr=LR, backend="loop")
    three = tplan(n_layers=4, n_stages=3, schedule="1f1b")
    with pytest.raises(ValueError, match="device stages"):
        tps.make_ir_state(tm, tparams, plan=three)
    step = tps.make_ir_train_step(tm, plan=one, lr=LR)
    state = tps.make_ir_state(tm, tparams, plan=one)
    with pytest.raises(ValueError, match="not divisible"):
        step(state, _batches(cfg, 1, batch=3)[0])


def test_runtime_config_and_dispatch():
    """RuntimeConfig validates as JAX's does; Runtime dispatches a stream
    plan to the tick runtime and a round plan to the IR interpreter."""
    for kw in (dict(mode="adam"), dict(schedule="zigzag"),
               dict(backend="loop"), dict(execution="nccl"),
               dict(execution="mpmd", schedule="stream"),
               dict(ticks_per_step=0)):
        with pytest.raises(ValueError):
            JRuntimeConfig(**kw)
        with pytest.raises(ValueError):
            RuntimeConfig(**kw)
    cfg, jm, jparams, tm, tparams = _pair(2, 4)
    b = _batches(cfg, 1)[0]
    rt = Runtime(tplan(tm.cfg, n_stages=2, schedule="stream"), tm,
                 RuntimeConfig(lr=LR))
    state = rt.init_state(_fresh(tparams), b)
    state, met = rt.train_step(state, b)
    assert "stash_x" in state and state["tick"] == 1
    rt = Runtime(tplan(tm.cfg, n_stages=2, schedule="2bw",
                       n_microbatches=2), tm, RuntimeConfig(lr=LR))
    state = rt.init_state(_fresh(tparams), b)
    state, met = rt.train_step(state, b)
    assert "stash" in state and state["step"] == 1
    with pytest.raises(TypeError):
        Runtime(object(), tm)
    with pytest.raises(ValueError, match="does not match"):
        Runtime(tplan(tm.cfg, n_stages=2, schedule="1f1b"), tm,
                RuntimeConfig(schedule="gpipe"))
    with pytest.raises(NotImplementedError, match="mpmd"):
        Runtime(tplan(tm.cfg, n_stages=2, schedule="1f1b"), tm,
                RuntimeConfig(execution="mpmd"))
    with pytest.raises(TypeError, match="serve"):
        rt.serve_engine(tparams)


@pytest.mark.parametrize("schedule", ["stream", "1f1b"])
def test_plan_of_another_depth_refused(schedule):
    """Both runtimes refuse a partition that does not tile the model's
    layers, through the one shared check."""
    cfg, jm, jparams, tm, tparams = _pair(2, 4)
    other = tplan(n_layers=5, n_stages=2, schedule=schedule)
    with pytest.raises(ValueError, match="partitions 5 layers, model "
                                         "has 4"):
        if schedule == "stream":
            tps.make_state(tm, tparams, _batches(cfg, 1)[0], plan=other)
        else:
            tps.make_ir_state(tm, tparams, plan=other)


@pytest.mark.parametrize("verify,want", [(True, 1), (False, 0)])
def test_runtime_verifies_plan_once(monkeypatch, verify, want):
    """A round plan is verified once, when the state is built, however
    many steps run (and never under ``verify=False``)."""
    cfg, jm, jparams, tm, tparams = _pair(2, 4)
    pplan = tplan(tm.cfg, n_stages=2, schedule="1f1b", n_microbatches=2)
    calls = []
    monkeypatch.setattr(type(pplan), "verify",
                        lambda self, **kw: calls.append(kw))
    rt = Runtime(pplan, tm, RuntimeConfig(lr=LR, verify=verify))
    b = _batches(cfg, 1)[0]
    state = rt.init_state(_fresh(tparams), b)
    for _ in range(2):
        state, _ = rt.train_step(state, b)
    assert len(calls) == want


@pytest.mark.parametrize("argv", [
    ["--schedule", "gpipe"], ["--schedule", "1f1b"],
    ["--schedule", "2bw", "--mode", "pipedream"],
    ["--schedule", "interleaved", "--virtual-stages", "2", "--layers",
     "4"],
    ["--schedule", "stream"],
    ["--schedule", "1f1b", "--layers", "7", "--pipe", "3",
     "--ir-backend", "unrolled"],
    ["--schedule", "2bw", "--layers", "5", "--profile-method", "timed",
     "--no-verify"]])
def test_launcher_runs_each_schedule(argv, capsys):
    base = ["--smoke", "--device", "cpu", "--steps", "2", "--log-every",
            "1", "--json", "--batch", "4", "--seq", "16"]
    assert ttrain.main(base + argv) == 0
    out = capsys.readouterr().out
    schedule = argv[1]
    assert f"# plan[{schedule} " in out and "# realized stages:" in out
    assert (f"# schedule {schedule}: round=" in out) == \
        (schedule != "stream")
    if "7" in argv:
        assert "part=dp:(3, 2, 2)" in out
    recs = [json.loads(x) for x in out.splitlines()
            if x.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)


@pytest.mark.parametrize("argv,why", [
    (["--schedule", "1f1b", "--mode", "sync"], "cannot honor"),
    (["--schedule", "1f1b", "--virtual-stages", "2"], "requires"),
    (["--schedule", "interleaved", "--virtual-stages", "2", "--batch",
      "3"], "no round size"),
    (["--schedule", "1f1b", "--execution", "mpmd"], "not ported"),
    (["--profile-method", "hlo"], "not ported")])
def test_launcher_refusals(argv, why):
    with pytest.raises(SystemExit, match=why):
        ttrain.main(["--smoke", "--device", "cpu"] + argv)


@pytest.mark.parametrize("schedule,batch,pipe,v,ticks,want", [
    ("1f1b", 8, 4, 1, 1, 8), ("2bw", 8, 4, 1, 1, 8),
    ("interleaved", 8, 4, 2, 1, 8), ("gpipe", 6, 4, 1, 1, 6),
    ("2bw", 6, 4, 1, 1, 6), ("interleaved", 12, 3, 2, 1, 12),
    ("1f1b", 8, 2, 1, 2, 2)])
def test_round_size_rule(schedule, batch, pipe, v, ticks, want):
    assert ttrain.round_size(schedule, batch, pipe, v, ticks) == want
