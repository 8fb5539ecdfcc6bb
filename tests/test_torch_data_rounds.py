"""The data axis under the IR round schedules: ``launch/train.py --data
2`` with ``--schedule 1f1b``, ``2bw`` and ``interleaved`` (v = 2), held
on the CPU to the JAX package's ``make_ir_train_step`` (``unrolled``)
on the whole batch, and a traced ``--data 2`` run.

Two gloo replicas each take their block of every round microbatch's
rows, accumulate the round and average its mean gradient over the
replicas once, before the update; the JAX side runs the port's draw
from ``--seed`` on the whole batch in fp32.

Claims (rtol 1e-4 / atol 1e-5): the replicas' mean loss each round and
every params / momentum leaf (2bw: its stash too) after 2 rounds, the
replicas bit-equal, one reduction a round of the whole fp32 gradient
(ZeRO-1: a reduce-scatter, the weights all-gathered);
the 1f1b run is traced (``--trace``): replica 0 writes a trace that
validates, and tracing leaves the numbers as JAX's; a ``Runtime``
refuses a data axis under MPMD.
Helpers and the probe: ``test_torch_data_pipe.py``.
"""
import concurrent.futures as cf
import json

import pytest

from repro_torch.launch import train
from test_torch_data_pipe import (BASE, LR, _batches, _cfgs, _check_replicas,
                                  _close_leaves, _jax_params, _leaves_at,
                                  _mean_losses, launch)
from test_torch_threads import one_thread  # noqa: F401

ROUNDS = 2
# (name, flags beyond BASE)
CASES = {
    "1f1b": ["--schedule", "1f1b", "--data", "2", "--trace",
             "{out}/trace.json"],
    "2bw": ["--schedule", "2bw", "--data", "2"],
    "interleaved": ["--schedule", "interleaved", "--virtual-stages", "2",
                    "--ticks", "4", "--data", "2"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_rounds")
    pool = cf.ThreadPoolExecutor(max_workers=2)
    futs = {}
    for name, extra in CASES.items():
        out = str(root / name)
        futs[name] = pool.submit(
            launch, BASE + [a.format(out=out) for a in extra], out, ROUNDS)

    def get(name):
        return futs[name].result(), root / name
    yield get
    pool.shutdown(wait=True)


def jax_rounds(name):
    """JAX ``make_ir_train_step(backend="unrolled")`` on the whole
    batches, with the launcher's plan: (losses, final state)."""
    import jax
    from repro.core import pipeline_stream as jps
    from repro.models import Model as JModel
    from repro.planner import plan as jplan
    extra = [a for a in CASES[name]
             if a != "--trace" and not a.startswith("{")]
    args, tcfg, jcfg = _cfgs(BASE + extra)
    M = train.round_size(args.schedule, args.batch, args.pipe,
                         args.virtual_stages, args.ticks)
    jp = jplan(jcfg, n_stages=args.pipe, schedule=args.schedule,
               virtual_stages=args.virtual_stages, n_microbatches=M,
               partitioner="uniform")
    jm = JModel(jcfg)
    bs = _batches(args, tcfg, ROUNDS)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       bs[0])
    js = jps.make_ir_state(jm, _jax_params(tcfg, jm), sds, plan=jp,
                           mode=args.mode)
    jstep = jax.jit(jps.make_ir_train_step(jm, plan=jp, mode=args.mode,
                                           lr=LR, backend="unrolled"))
    losses = []
    for b in bs:
        js, met = jstep(js, b)
        losses.append(float(met["loss"]))
    return losses, js


@pytest.mark.parametrize("name", list(CASES))
def test_round_replicas_match_jax_whole_batch(name, runs):
    import jax
    import numpy as np
    losses, js = jax_rounds(name)
    reps, out = runs(name)
    _check_replicas(reps, ROUNDS)
    np.testing.assert_allclose(_mean_losses(reps), losses, rtol=1e-4,
                               atol=1e-5)
    a0 = reps[0][1]
    keys = ("params", "momentum") + (("stash/params", "stash/momentum")
                                     if name == "2bw" else ())
    for key in keys:
        want = js
        for part in key.split("/"):
            want = want[part]
        _close_leaves(_leaves_at(a0, ROUNDS - 1, key),
                      jax.tree.leaves(want), key)
    if name == "1f1b":
        from repro_torch.obs import validate_trace
        with open(out / "trace.json") as f:
            trace = json.load(f)
        assert validate_trace(trace) == []


def test_runtime_refuses_a_data_axis_under_mpmd():
    from repro_torch.api import Runtime, RuntimeConfig
    from repro_torch.models import Model
    from repro_torch.planner import plan as tplan
    args = train.parse_args(BASE + ["--schedule", "1f1b"])
    cfg = train.build(args)
    model = Model(cfg, device="cpu")
    pl = tplan(cfg, n_stages=2, schedule="1f1b", n_microbatches=4,
               partitioner="uniform")

    class Replicas:
        world, rank = 2, 0
    with pytest.raises(ValueError, match=r"unsupported combination: a data "
                       r"axis \(data=\) with execution='mpmd' — .*pure "
                       r"pipeline parallelism.*; supported alternative"):
        Runtime(pl, model, RuntimeConfig(execution="mpmd"),
                group=Replicas(), data=Replicas())
