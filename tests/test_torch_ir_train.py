"""The port's IR interpreter (round schedules) against the JAX package's.

The same weights (the JAX model's, carried over by ``from_jax_params``)
and the same numpy batches go through JAX's ``make_ir_state`` /
``make_ir_train_step(backend="unrolled")`` (its reference oracle) and the
port's twins, round by round, on the CPU in fp32, here for gpipe and
1f1b (2bw and interleaved v = 2 in their own files), at S in {2, 3},
with a ragged dp partition.  The port's attention backward there is
``flash_bwd_ref``, the JAX side's autodiff of ``_attend``.

Tolerances, as ``tests/test_torch_train.py`` holds the stream tick:
every loss within rtol 1e-5; every state leaf (params, momentum, the 2bw
stash) within rtol 1e-4 / atol 1e-5 after 3 rounds.  The port's two
backends ("scan" over the event table, "unrolled" over the round
program) run the same arithmetic in the same order and are held equal
bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline_stream as jps
from repro.planner import plan as jplan
from repro.planner import synthetic_profile as jsynthetic
from repro_torch.core import pipeline_stream as tps
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.planner import plan as tplan
from repro_torch.planner import synthetic_profile as tsynthetic
from test_torch_train import (LOSS_RTOL, LR, _batches, _close_trees,
                              _pair)

ROUNDS = 3

# (schedule, S, n_layers, v, mode, batch, round size, dp profile costs);
# this file holds the flush schedules gpipe and 1f1b,
# test_torch_ir_2bw.py and test_torch_ir_interleaved.py the others (one
# file each keeps every file near a minute: the JAX rounds compile per
# case)
CASES = [
    ("gpipe", 2, 4, 1, "spectrain", 4, 2, None),
    ("gpipe", 3, 6, 1, "vanilla", 3, 3, None),
    ("1f1b", 2, 4, 1, "pipedream", 4, 2, None),
    ("1f1b", 3, 7, 1, "spectrain", 3, 3, [3, 1, 1, 1, 1, 1, 1]),
]


def case_ids(cases):
    return [f"{c[0]}-S{c[1]}-L{c[2]}-{c[4]}" + ("-dp" if c[7] else "")
            for c in cases]


def _plans(cfg, tcfg, schedule, S, v, M, costs):
    kw = dict(n_stages=S, schedule=schedule, virtual_stages=v,
              n_microbatches=M, partitioner="dp")
    if costs is None:
        return jplan(cfg, **kw), tplan(tcfg, **kw)
    return (jplan(cfg, profile=jsynthetic(costs), **kw),
            tplan(tcfg, profile=tsynthetic(costs), **kw))


def _fresh(tree):
    return tree_map(lambda _, a: a.clone(), tree)


def _run(case, backends=("scan",), rounds=ROUNDS, port_only=False):
    """JAX (unrolled oracle) and the port (each backend in
    ``backends``) over ``rounds`` rounds from the same weights."""
    schedule, S, L, v, mode, batch, M, costs = case
    cfg, jm, jparams, tm, tparams = _pair(S, L)
    jp, tp = _plans(cfg, tm.cfg, schedule, S, v, M, costs)
    assert tp.partition.boundaries == jp.partition.boundaries
    if costs is not None:
        assert len(set(tp.stage_sizes)) > 1      # a ragged split
    bs = _batches(cfg, rounds, batch=batch)
    out = {"plans": (jp, tp)}
    if not port_only:
        sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape,
                                                          x.dtype), bs[0])
        js = jps.make_ir_state(jm, jparams, sds, plan=jp, mode=mode)
        jstep = jax.jit(jps.make_ir_train_step(
            jm, plan=jp, mode=mode, lr=LR, backend="unrolled"))
        jl = []
        for b in bs:
            js, met = jstep(js, b)
            jl.append(float(met["loss"]))
        out["jax"] = (js, jl)
    for backend in backends:
        ts = tps.make_ir_state(tm, _fresh(tparams), bs[0], plan=tp,
                               mode=mode)
        tstep = tps.make_ir_train_step(tm, plan=tp, mode=mode, lr=LR,
                                       backend=backend)
        tl = []
        for b in bs:
            ts, met = tstep(ts, b)
            assert met["loss_valid"] == 1.0
            tl.append(float(met["loss"]))
        out[backend] = (ts, tl)
    return out


def _check(js, jl, ts, tl):
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close_trees(ts["params"], js["params"], "params")
    _close_trees(ts["momentum"], js["momentum"], "momentum")
    assert ts["step"] == int(js["step"])
    assert ("stash" in ts) == ("stash" in js)
    if "stash" in js:
        _close_trees(ts["stash"]["params"], js["stash"]["params"],
                     "stash params")
        _close_trees(ts["stash"]["momentum"], js["stash"]["momentum"],
                     "stash momentum")


def check_round(case):
    """JAX's round against both port backends, and the backends against
    each other bit for bit (the same arithmetic in the same order)."""
    out = _run(case, backends=("scan", "unrolled"))
    js, jl = out["jax"]
    _check(js, jl, *out["scan"])
    (ts, tl), (tu, ul) = out["scan"], out["unrolled"]
    assert tl == ul
    for a, b in zip(tree_leaves(ts), tree_leaves(tu)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_round_matches_jax(case):
    check_round(case)


def test_flush_schedules_are_mode_invariant():
    """No update lands inside a flush round (IR staleness 0), so every
    mode runs the same numbers, bit for bit."""
    runs = [_run(("1f1b", 2, 4, 1, mode, 4, 4, None), port_only=True,
                 rounds=2)["scan"] for mode in tps.MODES]
    for ts, tl in runs[1:]:
        assert tl == runs[0][1]
        for a, b in zip(tree_leaves(ts["params"]),
                        tree_leaves(runs[0][0]["params"])):
            assert torch.equal(a, b)


def test_stacked_params_and_chunk_trees():
    """``make_ir_state`` takes the legacy stacked [S, Lps, ...] input as
    JAX's does, and an interleaved plan's state holds S·v chunk trees."""
    cfg, jm, jparams, tm, tparams = _pair(2, 4)
    jp, tp = _plans(cfg, tm.cfg, "interleaved", 2, 2, 4, None)
    stacked = {"layers": tree_map(
        lambda path, _: torch.stack([_at(t["layers"], path)
                                     for t in tparams["stages"]]),
        tparams["stages"][0]["layers"])}
    ts = tps.make_ir_state(tm, {"outer": tparams["outer"],
                                "stages": stacked}, plan=tp)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       _batches(cfg, 1)[0])
    js = jps.make_ir_state(jm, {"outer": jparams["outer"],
                                "stages": jm.stack_stage_params(
                                    jparams["stages"])}, sds, plan=jp)
    assert len(ts["params"]["stages"]) == 4
    _close_trees(ts["params"], js["params"], "params")
    by_dev = tm.device_chunk_params(ts["params"]["stages"])
    assert [len(d) for d in by_dev] == [2, 2]
    assert by_dev[1][1] is ts["params"]["stages"][3]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree
