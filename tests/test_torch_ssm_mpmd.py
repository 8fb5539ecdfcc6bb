"""rwkv6 under stage-local (MPMD) execution: two gloo ranks on the CPU,
one per stage, bit for bit the port's SPMD rounds (1f1b and interleaved
v = 2, spectrain, two rounds each): every loss and every leaf of the
gathered state (params, momentum).  The hybrid zamba2 is refused under
MPMD in both packages.

This module imports no JAX: the spawned ranks import it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import MeshPlan
from repro_torch.core import pipeline_stream as tps
from repro_torch.launch.mesh import run_stage_ranks
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.planner import plan as tplan
from repro_torch.runtime import elastic
from test_torch_threads import one_thread  # noqa: F401

LR = 0.05
# (schedule, virtual stages, round size)
CASES = [("1f1b", 1, 2), ("interleaved", 2, 2)]


def _cfg(arch="rwkv6-7b"):
    return smoke_config(get_config(arch)).replace(
        n_layers=4, mesh_plan=MeshPlan(pipe=2, tensor=1, num_microbatches=2),
        param_dtype="float32", compute_dtype="float32")


def _plan(cfg, schedule, v, M):
    return tplan(cfg, n_stages=2, schedule=schedule, virtual_stages=v,
                 n_microbatches=M, partitioner="uniform")


def _np(tree):
    return tree_map(lambda _, a: a.detach().numpy().copy()
                    if isinstance(a, torch.Tensor) else a, tree)


def _torch(tree):
    return tree_map(lambda _, a: torch.from_numpy(np.array(a))
                    if isinstance(a, np.ndarray) else a, tree)


def _batches(vocab, n, batch=4, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, size=(batch, seq + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


def _rounds(model, params, plan, batches, **kw):
    state = tps.make_ir_state(model, _torch(params), plan=plan, **kw)
    step = tps.make_ir_train_step(model, plan=plan, lr=LR, **kw)
    losses = []
    for b in batches:
        state, met = step(state, b)
        losses.append(None if met["loss"] is None else float(met["loss"]))
    return state, losses


def _rank(group, cfg, params, batches):
    """Every case on this rank: the MPMD rounds, the state gathered to
    rank 0."""
    model = Model(cfg, device="cpu")
    out = []
    for case in CASES:
        pl = _plan(cfg, *case)
        state, losses = _rounds(model, params, pl, batches,
                                execution="mpmd", group=group)
        g = elastic.gather_mpmd_state(state, model, pl, group)
        out.append({"losses": losses, "state": None if g is None
                    else _np(g)})
    return out


def test_rwkv6_mpmd_rounds_bit_equal_spmd():
    cfg = _cfg()
    model = Model(cfg, device="cpu")
    params = _np(model.init(torch.Generator().manual_seed(0)))
    batches = _batches(cfg.vocab_size, 2)
    ranks = run_stage_ranks(_rank, 2, "cpu", args=(cfg, params, batches))
    for i, case in enumerate(CASES):
        spmd, losses = _rounds(model, params, _plan(cfg, *case), batches)
        got = [r[i] for r in ranks]
        head = [g["losses"] for g in got if g["losses"][0] is not None]
        assert head == [losses], case
        whole = got[0]["state"]
        for key in ("params", "momentum"):
            want, have = tree_leaves(spmd[key]), tree_leaves(_torch(
                whole[key]))
            assert len(want) == len(have)
            for a, b in zip(want, have):
                assert torch.equal(a, b), (case, key)


def test_hybrid_refuses_mpmd():
    cfg = _cfg("zamba2-1.2b")
    model = Model(cfg, device="cpu")
    pl = _plan(cfg, "1f1b", 1, 2)
    with pytest.raises(NotImplementedError, match="hybrid"):
        tps.make_ir_state(model, model.init(torch.Generator().manual_seed(0)),
                          plan=pl, execution="mpmd", group=object())
