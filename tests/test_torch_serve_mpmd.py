"""The pipelined ``ServeEngine`` under ``backend="mpmd"``: one process
per stage over gloo on the CPU, tiny granite and rwkv6 at S in {2, 4}.

The weights are the JAX model's (``from_jax_params``), the traces
``tests/test_serve.py``'s (one with page recycling: 2 slots, 2 pages).
The ranks are spawned once per S by a module-scoped fixture and serve
every case inside it; the assertions are parametrised over the cases.

Claims: every request's tokens equal the port's
``ServeEngine(backend="scan")``'s and the JAX ``ServeEngine(backend=
"scan")``'s exactly (the JAX engine's tokens do not depend on the stage
split, ``tests/test_torch_serve_engine.py``); only rank 0 returns them;
``restate`` under mpmd is refused.

JAX is imported inside the fixture: the spawned ranks import this
module and need only torch.
"""
import threading

import numpy as np

import pytest
import torch

from repro_torch.launch.mesh import run_stage_ranks
from repro_torch.models import Model
from repro_torch.models.layers import tree_map
from repro_torch.planner import serve_plan
from repro_torch.serve import ServeEngine
from test_torch_threads import one_thread  # noqa: F401

PLAN_KW = dict(n_slots=4, max_prefill=2, prompt_budget=8, page_seq=32,
               n_layers=4)
# (id, arch, trace name, extra plan keywords)
CASES = [("granite-trace8", "granite-8b", "trace8", {}),
         ("granite-recycle", "granite-8b", "recycle",
          dict(n_slots=2, n_pages=2)),
         ("rwkv6-trace", "rwkv6-7b", "trace", {})]
STAGES = (2, 4)
IDS = [f"{c[0]}-S{S}" for S in STAGES for c in CASES]


def _rank_serve(group, inputs):
    """Every case on this rank: an mpmd engine over the case's weights,
    its run (rank 0's results), and whether restate is refused."""
    out = []
    for cfg, params, plan_kw, trace in inputs:
        model = Model(cfg, device="cpu")
        tp = tree_map(lambda _, a: torch.from_numpy(a.copy()), params)
        splan = serve_plan(None, n_stages=group.world, **plan_kw)
        eng = ServeEngine(model, tp, splan, backend="mpmd", group=group)
        res = eng.run(trace)
        refused = False
        try:
            eng.restate(splan)
        except NotImplementedError as e:
            refused = "mpmd" in str(e)
        out.append({"results": res, "refused": refused,
                    "waves": eng.n_waves, "lanes": eng.n_lanes})
    return out


@pytest.fixture(scope="module")
def served():
    from test_torch_serve_engine import _pair, _same_trace, _splans
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve import poisson_trace as jpoisson_trace

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pairs = {"granite-8b": _pair("granite-8b", 0),
                 "rwkv6-7b": _pair("rwkv6-7b", 1)}
        vocab = pairs["granite-8b"][0].cfg.vocab_size
        traces = {
            "trace8": jpoisson_trace(8, rate=0.7, seed=3,
                                     prompt_lens=(1, 8), gen_lens=(1, 6),
                                     vocab=vocab),
            "recycle": jpoisson_trace(10, rate=1.5, seed=8,
                                      prompt_lens=(1, 8), gen_lens=(1, 6),
                                      vocab=vocab),
            "trace": jpoisson_trace(6, rate=0.8, seed=5,
                                    prompt_lens=(1, 6), gen_lens=(1, 4),
                                    vocab=pairs["rwkv6-7b"][0].cfg
                                    .vocab_size)}
        want, scan, inputs = {}, {}, {S: [] for S in STAGES}
        for cid, arch, tname, kw in CASES:
            _, _, tm, tp = pairs[arch]
            for S in STAGES:
                inputs[S].append((tm.cfg, tree_map(
                    lambda _, a: a.numpy(), tp), dict(PLAN_KW, **kw),
                    _same_trace(traces[tname])))
        # the ranks run on a background thread while the references run
        ranks, errors = {}, []

        def spawn():
            try:
                for S in STAGES:
                    ranks[S] = run_stage_ranks(_rank_serve, S, "cpu",
                                               args=(inputs[S],),
                                               timeout_s=240.0)
            except Exception as e:          # re-raised below
                errors.append(e)
        th = threading.Thread(target=spawn, daemon=True)
        th.start()
        for cid, arch, tname, kw in CASES:
            jm, jp, tm, tp = pairs[arch]
            want[cid] = JServeEngine(jm, jp, _splans(**kw)[1],
                                     backend="scan").run(traces[tname])
            trace = _same_trace(traces[tname])
            for S in STAGES:
                scan[(cid, S)] = ServeEngine(
                    tm, tp, _splans(n_stages=S, **kw)[0]).run(trace)
        th.join(300.0)
        if errors:
            raise errors[0]
        assert not th.is_alive(), "the stage ranks did not finish"
    finally:
        torch.set_num_threads(threads)
    return {"want": want, "scan": scan, "ranks": ranks}


def _case(served, case_id):
    cid, S = case_id.rsplit("-S", 1)
    S = int(S)
    i = [c[0] for c in CASES].index(cid)
    return cid, S, [r[i] for r in served["ranks"][S]]


@pytest.mark.parametrize("case_id", IDS)
def test_mpmd_tokens_equal_scan_and_jax(served, case_id):
    cid, S, ranks = _case(served, case_id)
    got = ranks[0]["results"]
    assert got == served["scan"][(cid, S)]
    assert got == {int(k): tuple(v) for k, v in served["want"][cid].items()}
    assert all(r["results"] == {} for r in ranks[1:])
    # every rank ran each wave; lanes are counted where they enter
    assert len({r["waves"] for r in ranks}) == 1
    assert all(r["lanes"] == 0 for r in ranks[1:]) and ranks[0]["lanes"] > 0


@pytest.mark.parametrize("case_id", IDS)
def test_mpmd_restate_is_refused(served, case_id):
    _, _, ranks = _case(served, case_id)
    assert all(r["refused"] for r in ranks)


def test_recycle_trace_reuses_pages(served):
    """The recycling trace serves more requests than it has pages."""
    got = served["ranks"][2][0][1]["results"]      # rank 0, case 1
    assert len([r for r, t in got.items() if t]) > 2


def test_mpmd_needs_a_group_and_a_pageable_model():
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import MeshPlan
    z = smoke_config(get_config("zamba2-1.2b")).replace(
        n_layers=4, mesh_plan=MeshPlan(pipe=2, tensor=1,
                                       num_microbatches=2))
    zm = Model(z, device="cpu")
    splan = serve_plan(None, n_stages=2, **PLAN_KW)
    with pytest.raises(NotImplementedError, match="hybrid"):
        ServeEngine(zm, None, splan, backend="mpmd")
    g = smoke_config(get_config("granite-8b")).replace(n_layers=4)
    gm = Model(g, device="cpu")
    with pytest.raises(ValueError, match="group"):
        ServeEngine(gm, None, splan, backend="mpmd")


@pytest.mark.parametrize("sizes", [(2, 2), (3, 1, 2)])
def test_pack_serve_caches_matches_jax(sizes):
    """The port's packed paged caches (``[S, Lmax, n_pages + 1, ...]``)
    hold JAX ``pack_serve_caches``' values (``[S, n_pages + 1, Lmax, 1,
    ...]``, its chunk leaves page-first) with the two leading axes
    swapped, zero padding included, and unpack back exactly."""
    import jax.numpy as jnp
    from repro.serve import engine as jengine
    from repro_torch.serve.engine import pack_serve_caches, \
        unpack_serve_caches
    rng = torch.Generator().manual_seed(sum(sizes))
    caches = tuple({"layers": {"k": torch.randn((n, 5, 4, 2, 3),
                                                generator=rng),
                               "v": torch.randn((n, 5, 4, 2, 3),
                                                generator=rng)}}
                   for n in sizes)
    packed = pack_serve_caches(caches, sizes)
    jcaches = tuple({"layers": {k: jnp.asarray(
        a.transpose(0, 1).numpy()[:, :, None]) for k, a in
        c["layers"].items()}} for c in caches)
    jpacked = jengine.pack_serve_caches(jcaches, sizes)
    for k in ("k", "v"):
        want = torch.from_numpy(
            np.asarray(jpacked["layers"][k]))[:, :, :, 0]
        assert torch.equal(packed["layers"][k].transpose(1, 2), want)
    back = unpack_serve_caches(packed, sizes)
    for b, c in zip(back, caches):
        for k in ("k", "v"):
            assert torch.equal(b["layers"][k], c["layers"][k])
