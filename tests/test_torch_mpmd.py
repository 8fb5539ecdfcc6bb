"""Stage-local (MPMD) execution of the port's IR round schedules: one
process per stage over gloo on the CPU, against the port's SPMD
interpreter and the JAX package's ``make_ir_train_step``.

The ranks are spawned once per stage count S by a module-scoped fixture
(``repro_torch.launch.mesh.run_stage_ranks``); every case of that S runs
inside the same ranks and the assertions are parametrised over the
cases.  The weights are the JAX model's (``from_jax_params``), the
batches numpy draws from a seed; everything is fp32, one intra-op thread
a process (the ranks run one by design, the references here are taken
under the same setting).

Claims:
  * the streams alone: every send has its receive on the neighbour's
    row of the same tick, and a round moves exactly the payloads the
    round program implies (every schedule, S in {2, 3, 4}, ragged dp
    splits);
  * MPMD equals the port's SPMD interpreter bit for bit over 3 rounds:
    the losses and every state leaf (params, momentum, the 2bw stash),
    gathered from the ranks and unpacked, at S in {1, 2, 3, 4};
  * it is within rtol 1e-4 / atol 1e-5 of JAX's round (JAX
    ``execution="mpmd"`` at S = 1, the one CPU device; its
    ``backend="unrolled"`` elsewhere), losses within rtol 1e-5;
  * the payloads each rank sent and received equal the streams'
    prediction, in count and bytes;
  * MPMD checkpoints are the JAX packed layout both ways; elastic
    restate round-trips between SPMD and MPMD;
  * the gates (clip, hybrid, the stream schedule, ``--mode sync``)
    refuse in three parts, and a rank that raises fails the run.

JAX is imported inside the functions that use it: the spawned ranks
import this module and need only torch.
"""
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import pipeline_stream as tps
from repro_torch.launch.mesh import run_stage_ranks
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import pack_chunk_params, unpack_chunk_params
from repro_torch.planner import plan as tplan
from repro_torch.planner import synthetic_profile as tsynthetic
from repro_torch.runtime import checkpoint as tckpt
from repro_torch.runtime import elastic
from repro_torch.runtime import sharding as rsh
from test_torch_threads import one_thread  # noqa: F401

LR = 0.05
ROUNDS = 3
STATE_RTOL, STATE_ATOL, LOSS_RTOL = 1e-4, 1e-5, 1e-5

# (id, schedule, S, n_layers, v, mode, batch, round size, dp costs, tied)
CASES = [
    ("1f1b-S4-dp", "1f1b", 4, 7, 1, "spectrain", 4, 4,
     [3, 1, 1, 1, 1, 1, 1], False),
    ("gpipe-S4-dp", "gpipe", 4, 6, 1, "vanilla", 4, 4,
     [1, 1, 1, 1, 1, 4], False),
    ("2bw-S2-spectrain", "2bw", 2, 4, 1, "spectrain", 4, 2, None, False),
    ("2bw-S2-vanilla", "2bw", 2, 4, 1, "vanilla", 4, 2, None, False),
    ("2bw-S2-pipedream-dp", "2bw", 2, 5, 1, "pipedream", 4, 2,
     [1, 1, 1, 1, 3], False),
    ("interleaved-S2-v2", "interleaved", 2, 4, 2, "spectrain", 4, 2, None,
     False),
    ("1f1b-S2-tied", "1f1b", 2, 4, 1, "spectrain", 4, 2, None, True),
    ("1f1b-S3-dp", "1f1b", 3, 7, 1, "spectrain", 3, 3,
     [3, 1, 1, 1, 1, 1, 1], False),
    ("1f1b-S1", "1f1b", 1, 2, 1, "spectrain", 4, 2, None, False),
]
IDS = [c[0] for c in CASES]
# the case whose ranks also write, and resume, a checkpoint
CKPT_CASE = "2bw-S2-pipedream-dp"


def _np(tree):
    return tree_map(lambda _, a: a.detach().numpy().copy()
                    if isinstance(a, torch.Tensor) else a, tree)


def _torch(tree):
    return tree_map(lambda _, a: torch.from_numpy(np.array(a))
                    if isinstance(a, np.ndarray) else a, tree)


def _batches(vocab, n, batch, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, size=(batch, seq + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


def _tplan(cfg, spec):
    _, schedule, S, _, v, _, _, M, costs, _ = spec
    kw = dict(n_stages=S, schedule=schedule, virtual_stages=v,
              n_microbatches=M, partitioner="dp")
    if costs is not None:
        kw["profile"] = tsynthetic(costs)
    return tplan(cfg, **kw)


# ------------------------------------------------------------- the ranks
def _rank_cases(group, inputs):
    """Every case of this stage count on this rank: 3 MPMD rounds from
    the case's numpy weights, the payload counters of each round, the
    state gathered to rank 0; for the checkpoint case, a save of the
    final state and a resume from the JAX-written checkpoint; the
    elastic restate of the initial weights into MPMD and back."""
    out = []
    for spec, cfg, params, batches, dirs in inputs:
        mode = spec[5]
        model = Model(cfg, device="cpu")
        pl = _tplan(cfg, spec)
        full = _torch(params)
        state = tps.make_ir_state(model, full, plan=pl, mode=mode,
                                  execution="mpmd", group=group)
        step = tps.make_ir_train_step(model, plan=pl, mode=mode, lr=LR,
                                      execution="mpmd", group=group)
        losses, counters = [], []
        for b in batches:
            group.reset_counters()
            state, met = step(state, b)
            counters.append(group.counters())
            losses.append(None if met["loss"] is None
                          else float(met["loss"]))
        rec = {"losses": losses, "counters": counters,
               "pred": tps.mpmd_transfers(pl.device_streams())[group.rank],
               "n_params": sum(t.numel() for t in
                               tree_leaves(state["params"]))}
        gathered = elastic.gather_mpmd_state(state, model, pl, group)
        rec["state"] = None if gathered is None else _np(gathered)
        if dirs:
            tckpt.save_mpmd(dirs["port"], state, ROUNDS - 1, model, pl,
                            group)
            resumed, at = tckpt.restore_mpmd(dirs["jax"], state, model,
                                             pl, group)
            g = elastic.gather_mpmd_state(resumed, model, pl, group)
            rec["resumed"] = None if g is None else (_np(g), at)
        # elastic restate: the whole initial SPMD state into MPMD, back
        spmd = tps.make_ir_state(model, _torch(params), plan=pl, mode=mode)
        for i, m in enumerate(tree_leaves(spmd["momentum"])):
            m.copy_(torch.full_like(m, 0.01 * (i + 1)))
        spmd["step"] = 5
        local = elastic.elastic_restate(model, model, spmd, plan=pl,
                                        mode=mode, execution="mpmd",
                                        group=group)
        g = elastic.gather_mpmd_state(local, model, pl, group)
        rec["restated"] = None if g is None else (_np(spmd), _np(g))
        out.append(rec)
    return out


# ------------------------------------------------------------ references
def _spmd_rounds(cfg, spec, params, batches):
    model = Model(cfg, device="cpu")
    pl = _tplan(cfg, spec)
    state = tps.make_ir_state(model, _torch(params), plan=pl, mode=spec[5])
    step = tps.make_ir_train_step(model, plan=pl, mode=spec[5], lr=LR)
    losses = []
    for b in batches:
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    return losses, _np(state)


def _jax_rounds(jm, jparams, spec, batches):
    """JAX's 3 rounds (MPMD at S = 1, else the unrolled oracle) and its
    final state, ragged."""
    import jax
    from repro.core import pipeline_stream as jps
    from repro.planner import plan as jplan
    from repro.planner import synthetic_profile as jsynthetic
    from repro.runtime import elastic as jelastic
    _, schedule, S, _, v, mode, _, M, costs, _ = spec
    kw = dict(n_stages=S, schedule=schedule, virtual_stages=v,
              n_microbatches=M, partitioner="dp")
    if costs is not None:
        kw["profile"] = jsynthetic(costs)
    jp = jplan(jm.cfg, **kw)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       batches[0])
    ex = "mpmd" if S == 1 else None
    js = jps.make_ir_state(jm, jparams, sds, plan=jp, mode=mode,
                           **({"execution": ex} if ex else {}))
    jstep = jax.jit(jps.make_ir_train_step(
        jm, plan=jp, mode=mode, lr=LR, backend="unrolled",
        **({"execution": ex} if ex else {})))
    losses = []
    for b in batches:
        js, met = jstep(js, b)
        losses.append(float(met["loss"]))
    if ex:
        js = jelastic.unpack_mpmd_state(js)
    return losses, jax.tree.map(np.asarray, js), jp


def _jax_packed_ckpt(path, jm, js, jp, S):
    """Write the JAX state ``js`` (ragged) as a JAX packed MPMD
    checkpoint at step 7."""
    import jax
    import jax.numpy as jnp
    from repro.models.model import pack_chunk_params as jpack
    from repro.runtime import checkpoint as jckpt

    def jax_tree(t):
        return jax.tree.map(jnp.asarray, t)

    def pack(t):
        p, sizes = jpack([jax_tree(c) for c in t["stages"]], S)
        return {"outer": jax_tree(t["outer"]), "stages": p}, sizes
    st = {"params": pack(js["params"])[0],
          "momentum": pack(js["momentum"])[0], "step": jnp.int32(7)}
    if "stash" in js:
        st["stash"] = {"params": pack(js["stash"]["params"])[0],
                       "momentum": pack(js["stash"]["momentum"])[0]}
    st["chunk_sizes"] = jnp.asarray(pack(js["params"])[1], jnp.int32)
    jckpt.save(path, st, 7)
    return st


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the port's SPMD and JAX's rounds, and the MPMD ranks'
    results (one spawn per S).  The ranks run on background threads of
    this process while it compiles the JAX references (the checkpoint
    case's JAX rounds come first: its ranks resume from them)."""
    import threading
    import jax
    from conftest import tiny_cfg
    from repro.models import Model as JModel
    from repro_torch.models import from_jax_params
    from test_torch_model import port_cfg

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        by_s, out, made = {}, {}, {}
        for spec in CASES:
            cid, _, S, L, _, _, batch, _, _, tied = spec
            jc = tiny_cfg("granite-8b", n_layers=L, pipe=S, n_kv_heads=2,
                          tie_embeddings=tied)
            jm = JModel(jc)
            jparams = jm.init(jax.random.PRNGKey(0))
            cfg = port_cfg(jc)
            assert isinstance(cfg, ArchConfig)
            params = _np(from_jax_params(jax.tree.map(np.asarray, jparams),
                                         cfg, device="cpu"))
            bs = _batches(cfg.vocab_size, ROUNDS, batch)
            dirs = None
            if cid == CKPT_CASE:
                root = tmp_path_factory.mktemp("mpmd_ckpt")
                dirs = {"port": str(root / "port"),
                        "jax": str(root / "jax")}
                jl, js, jp = _jax_rounds(jm, jparams, spec, bs)
                out[cid] = {"jax": (jl, js)}
                out["jax_ckpt"] = (_jax_packed_ckpt(dirs["jax"], jm, js,
                                                    jp, S), js)
                out["ckpt_dirs"] = dirs
            made[cid] = (jm, jparams, cfg, params, bs)
            out.setdefault(cid, {}).update(
                spec=spec, bytes=4 * (batch // spec[7]) * 16 * cfg.d_model)
            by_s.setdefault(S, []).append((spec, cfg, params, bs, dirs))

        ranks, errors = {}, []

        def spawn():
            try:
                for S, inputs in by_s.items():
                    ranks[S] = run_stage_ranks(
                        _rank_cases, S, "cpu", args=(inputs,),
                        timeout_s=240.0)
            except Exception as e:          # re-raised below
                errors.append(e)
        th = threading.Thread(target=spawn, daemon=True)
        th.start()
        for spec in CASES:
            jm, jparams, cfg, params, bs = made[spec[0]]
            if "jax" not in out[spec[0]]:
                jl, js, _ = _jax_rounds(jm, jparams, spec, bs)
                out[spec[0]]["jax"] = (jl, js)
            out[spec[0]]["spmd"] = _spmd_rounds(cfg, spec, params, bs)
        th.join(300.0)
        if errors:
            raise errors[0]
        assert not th.is_alive(), "the stage ranks did not finish"
        for S, inputs in by_s.items():
            for i, (spec, *_rest) in enumerate(inputs):
                out[spec[0]]["ranks"] = [r[i] for r in ranks[S]]
    finally:
        torch.set_num_threads(threads)
    return out


def _head(case):
    S = case["spec"][2]
    C = S * case["spec"][4]
    return case["ranks"][rsh.head_rank(C, S)]


# -------------------------------------------------------- streams alone
@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("schedule,v", [("gpipe", 1), ("1f1b", 1),
                                        ("2bw", 1), ("interleaved", 2)])
@pytest.mark.parametrize("costs", [None, "ragged"])
def test_streams_pair_every_send_with_its_receive(S, schedule, v, costs):
    """Each send on a rank's row has its receive on the neighbour's row
    of the same tick, and a round moves M (C - 1) activations forward
    and as many cotangents back, chunk q's sends on rank q % S."""
    C, M = S * v, 2 * S
    L = C + 3
    kw = dict(n_stages=S, schedule=schedule, virtual_stages=v,
              n_microbatches=M, partitioner="dp", n_layers=L)
    if costs:
        kw["profile"] = tsynthetic([4] + [1] * (L - 1))
    pl = tplan(None, **kw)
    if costs:
        assert len(set(pl.stage_sizes)) > 1
    got = tps.mpmd_transfers(pl.device_streams())
    for d in range(S):
        n_q = sum(1 for q in range(C - 1) if q % S == d)
        n_b = sum(1 for q in range(1, C) if q % S == d)
        assert got[d]["fwd_sent"] == M * n_q
        assert got[d]["bwd_sent"] == M * n_b
        assert got[d]["fwd_recv"] == got[(d - 1) % S]["fwd_sent"]
        assert got[d]["bwd_recv"] == got[(d + 1) % S]["bwd_sent"]
    assert sum(g["fwd_sent"] for g in got) == M * (C - 1)


def test_streams_check_catches_an_unpaired_send():
    """A receive slot wiped from one row (the mutation) is reported."""
    import dataclasses
    pl = tplan(None, n_stages=3, schedule="1f1b", n_microbatches=3,
               n_layers=6)
    st = pl.device_streams()
    rows = st.rows.copy()
    t, d = map(int, np.argwhere(rows[:, :, 5] >= 0)[0])
    rows[t, d, 5] = -1
    bad = dataclasses.replace(st, rows=rows)
    with pytest.raises(ValueError, match=f"tick {t}: rank {(d - 1) % 3}"):
        tps.mpmd_transfers(bad)


def test_single_rank_moves_nothing():
    pl = tplan(None, n_stages=1, schedule="1f1b", n_microbatches=2,
               n_layers=2)
    assert tps.mpmd_transfers(pl.device_streams()) == (
        {"fwd_sent": 0, "fwd_recv": 0, "bwd_sent": 0, "bwd_recv": 0},)


# ------------------------------------------------------------ the ranks
@pytest.mark.parametrize("cid", IDS)
def test_mpmd_equals_spmd_bitwise(runs, cid):
    case = runs[cid]
    tl, ts = case["spmd"]
    assert _head(case)["losses"] == tl
    got = case["ranks"][0]["state"]
    assert got["step"] == ts["step"] == ROUNDS
    assert ("stash" in got) == ("stash" in ts)
    gl, wl = tree_leaves(got), tree_leaves(ts)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert np.array_equal(g, w), f"leaf {i}"


@pytest.mark.parametrize("cid", IDS)
def test_mpmd_matches_jax(runs, cid):
    import jax
    case = runs[cid]
    jl, js = case["jax"]
    np.testing.assert_allclose(_head(case)["losses"], jl, rtol=LOSS_RTOL)
    got = case["ranks"][0]["state"]
    for name in ("params", "momentum") + (("stash",) if "stash" in js
                                          else ()):
        gl, wl = tree_leaves(got[name]), jax.tree.leaves(js[name])
        assert len(gl) == len(wl)
        for i, (g, w) in enumerate(zip(gl, wl)):
            np.testing.assert_allclose(g, w, rtol=STATE_RTOL,
                                       atol=STATE_ATOL,
                                       err_msg=f"{name} leaf {i}")


@pytest.mark.parametrize("cid", IDS)
def test_transfers_match_the_streams(runs, cid):
    """Each round, each rank sent and received exactly the payloads its
    stream names, each ``[B/M, seq, d]`` fp32; the ranks hold disjoint
    chunk weights (every rank but one a strict part of the model)."""
    case = runs[cid]
    nbytes = case["bytes"]
    for rank in case["ranks"]:
        pred = rank["pred"]
        sent = pred["fwd_sent"] + pred["bwd_sent"]
        recv = pred["fwd_recv"] + pred["bwd_recv"]
        for c in rank["counters"]:
            assert (c["n_sent"], c["n_recv"]) == (sent, recv)
            assert (c["bytes_sent"], c["bytes_recv"]) == \
                (sent * nbytes, recv * nbytes)
            # only a tied embedding's gradient partials cross as control
            assert (c["n_ctl"] > 0) == (case["spec"][9]
                                        and case["spec"][2] > 1)
    total = sum(a.size for a in tree_leaves(case["spmd"][1]["params"]))
    if case["spec"][2] > 1:
        assert all(r["n_params"] < total for r in case["ranks"])


def test_port_mpmd_checkpoint_reads_in_jax(runs):
    """The port's MPMD save is the JAX packed layout: JAX ``restore``
    into a packed template, then ``unpack_mpmd_state``, gives the port's
    gathered leaves exactly."""
    import jax
    from repro.runtime import checkpoint as jckpt
    from repro.runtime import elastic as jelastic
    template, _ = runs["jax_ckpt"]
    restored, at = jckpt.restore(runs["ckpt_dirs"]["port"], template)
    assert at == ROUNDS - 1
    un = jax.tree.map(np.asarray, jelastic.unpack_mpmd_state(restored))
    got = runs[CKPT_CASE]["ranks"][0]["state"]
    assert int(un["step"]) == got["step"]
    for name in ("params", "momentum", "stash"):
        gl, wl = tree_leaves(got[name]), jax.tree.leaves(un[name])
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            assert np.array_equal(g, w)


def test_jax_packed_checkpoint_resumes_under_mpmd(runs):
    """A packed checkpoint written by JAX resumes into the ranks' MPMD
    states with the JAX leaves exactly, at its step."""
    import jax
    _, js = runs["jax_ckpt"]
    got, at = runs[CKPT_CASE]["ranks"][0]["resumed"]
    assert at == 7 and got["step"] == 7
    for name in ("params", "momentum", "stash"):
        gl, wl = tree_leaves(got[name]), jax.tree.leaves(js[name])
        for g, w in zip(gl, wl):
            assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("cid", ["2bw-S2-spectrain", "1f1b-S4-dp",
                                 "1f1b-S2-tied"])
def test_elastic_restate_round_trips(runs, cid):
    """SPMD -> MPMD (``elastic_restate(execution="mpmd")`` on every rank)
    -> gathered equals the SPMD state, 2bw's stash restarted from the
    carried weights; and back to SPMD by ``elastic_restate``."""
    spmd, got = runs[cid]["ranks"][0]["restated"]
    assert got["step"] == spmd["step"] == 5
    for name in ("params", "momentum"):
        for g, w in zip(tree_leaves(got[name]), tree_leaves(spmd[name])):
            assert np.array_equal(g, w)
    if "stash" in got:
        for name in ("params", "momentum"):
            for g, w in zip(tree_leaves(got["stash"][name]),
                            tree_leaves(spmd[name])):
                assert np.array_equal(g, w)
    spec = runs[cid]["spec"]
    cfg = _cfg_of(runs, cid)
    model = Model(cfg, device="cpu")
    pl = _tplan(cfg, spec)
    back = elastic.elastic_restate(model, model, _torch(got), plan=pl,
                                   mode=spec[5])
    for g, w in zip(tree_leaves(_np(back["params"])),
                    tree_leaves(spmd["params"])):
        assert np.array_equal(g, w)


def _cfg_of(runs, cid):
    from conftest import tiny_cfg
    from test_torch_model import port_cfg
    _, _, S, L, _, _, _, _, _, tied = runs[cid]["spec"]
    return port_cfg(tiny_cfg("granite-8b", n_layers=L, pipe=S,
                             n_kv_heads=2, tie_embeddings=tied))


# -------------------------------------------------------------- layouts
@pytest.mark.parametrize("S,v,sizes", [(2, 1, (3, 2)), (2, 2, (1, 2, 1, 1)),
                                       (3, 1, (3, 2, 2))])
def test_pack_chunk_params_matches_jax(S, v, sizes):
    import jax.numpy as jnp
    from repro.models.model import pack_chunk_params as jpack
    from repro.models.model import unpack_chunk_params as jun
    rng = np.random.default_rng(sum(sizes))
    chunks = [{"layers": {"w": rng.standard_normal((n, 3, 2)).astype(
        np.float32), "b": rng.standard_normal((n, 4)).astype(np.float32)}}
        for n in sizes]
    tp, ts = pack_chunk_params(_torch(chunks), S)
    jp, js = jpack([{"layers": {k: jnp.asarray(a) for k, a in
                                c["layers"].items()}} for c in chunks], S)
    assert ts == tuple(js) == sizes
    for k in ("b", "w"):
        assert tp["layers"][k].shape == (v, S, max(sizes)) + \
            chunks[0]["layers"][k].shape[1:]
        assert np.array_equal(tp["layers"][k].numpy(),
                              np.asarray(jp["layers"][k]))
    back = unpack_chunk_params(tp, ts)
    jback = jun(jp, js)
    for q, c in enumerate(chunks):
        for k in ("b", "w"):
            assert np.array_equal(back[q]["layers"][k].numpy(),
                                  c["layers"][k])
            assert np.array_equal(np.asarray(jback[q]["layers"][k]),
                                  c["layers"][k])


def test_pack_mpmd_state_round_trips():
    rng = np.random.default_rng(0)
    tree = lambda: {"outer": {"a": torch.from_numpy(
        rng.standard_normal(3).astype(np.float32))}, "stages": tuple(
        {"layers": {"w": torch.from_numpy(rng.standard_normal(
            (n, 2)).astype(np.float32))}} for n in (2, 1, 1, 3))}
    st = {"params": tree(), "momentum": tree(), "step": 4,
          "stash": {"params": tree(), "momentum": tree()}}
    packed = elastic.pack_mpmd_state(st, 2)
    assert packed["chunk_sizes"].tolist() == [2, 1, 1, 3]
    assert packed["params"]["stages"]["layers"]["w"].shape == (2, 2, 3, 2)
    back = elastic.unpack_mpmd_state(packed)
    assert back["step"] == 4 and "chunk_sizes" not in back
    for a, b in zip(tree_leaves(back), tree_leaves(st)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_restack_and_reshard():
    a = torch.arange(24.).reshape(2, 3, 4)
    assert elastic.restack_stages({"w": a}, 3)["w"].shape == (3, 2, 4)
    with pytest.raises(ValueError, match="divisible"):
        elastic.restack_stages({"w": a}, 4)
    st = {"stages": ({"layers": {"w": a[0]}}, {"layers": {"w": a[1]}})}
    out = elastic.reshard_params(st, new_pipe=2, sizes=(4, 2))
    assert [t["layers"]["w"].shape[0] for t in out["stages"]] == [4, 2]
    assert torch.equal(torch.cat([t["layers"]["w"] for t in out["stages"]]),
                       a.reshape(6, 4))
    with pytest.raises(ValueError, match="empty"):
        elastic.reshard_params(st, new_pipe=2, sizes=(6, 0))


def test_placement_rule():
    assert rsh.local_chunks(1, 8, 4) == (1, 5)
    assert rsh.head_rank(8, 4) == 3 and rsh.head_rank(6, 4) == 1
    outer = {"embed": {"tok": 1, "unembed": 2}, "ln_f": {"scale": 3}}
    assert rsh.local_outer(outer, 0, 4, 4, False) == {"embed": {"tok": 1}}
    assert rsh.local_outer(outer, 3, 4, 4, False) == {
        "embed": {"unembed": 2}, "ln_f": {"scale": 3}}
    assert rsh.local_outer(outer, 1, 4, 4, False) == {}
    assert rsh.outer_leaf_ranks(("embed", "tok"), 4, 4, True) == (0, 3)
    assert rsh.choose_transport("cpu", 4) == "gloo"


# ---------------------------------------------------------------- gates
def _three_part(msg: str) -> bool:
    return "unsupported combination:" in msg and \
        "supported alternative:" in msg and " — " in msg


def test_gates_refuse_in_three_parts():
    from repro_torch.api import RuntimeConfig
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import MeshPlan
    from repro_torch.launch import train as ttrain
    cfg = smoke_config(get_config("granite-8b")).replace(
        n_layers=4, mesh_plan=MeshPlan(pipe=2, tensor=1,
                                       num_microbatches=2),
        param_dtype="float32", compute_dtype="float32")
    m = Model(cfg, device="cpu")
    pl = tplan(cfg, n_stages=2, schedule="1f1b", n_microbatches=2)
    with pytest.raises(NotImplementedError) as e:
        tps.make_ir_train_step(m, plan=pl, lr=LR, execution="mpmd",
                               clip=1.0)
    assert _three_part(str(e.value)) and "clip" in str(e.value)
    for kw in (dict(execution="mpmd", clip=1.0),
               dict(execution="mpmd", schedule="stream")):
        with pytest.raises(ValueError) as e:
            RuntimeConfig(**kw)
        assert _three_part(str(e.value))
    z = smoke_config(get_config("zamba2-1.2b")).replace(
        n_layers=4, mesh_plan=MeshPlan(pipe=2, tensor=1,
                                       num_microbatches=2),
        param_dtype="float32", compute_dtype="float32")
    zm = Model(z, device="cpu")
    with pytest.raises(NotImplementedError) as e:
        tps.make_ir_state(zm, None, plan=pl, execution="mpmd")
    assert _three_part(str(e.value)) and "hybrid" in str(e.value)
    base = ["--smoke", "--device", "cpu", "--execution", "mpmd"]
    for argv, what in ((["--mode", "sync"], "--mode sync"),
                       (["--schedule", "stream"], "--schedule stream"),
                       (["--schedule", "1f1b", "--clip", "1.0"], "--clip")):
        with pytest.raises(SystemExit) as e:
            ttrain.main(base + argv)
        assert _three_part(str(e.value.code)) and what in str(e.value.code)


def _raise_on_rank_one(group):
    if group.rank == 1:
        raise RuntimeError("rank one fails on purpose")
    group.recv((4,), torch.float32, 1)      # waits for a send never made
    return "unreachable"


def _deadlock(group):
    group.recv((4,), torch.float32, group.next)


def test_a_failing_rank_fails_the_group_fast():
    """Rank 0 waits on a receive with a 120 s group timeout; rank 1's
    error ends the run at once (well before that timeout)."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        run_stage_ranks(_raise_on_rank_one, 2, "cpu", timeout_s=240.0,
                        pg_timeout_s=120.0)
    assert time.perf_counter() - t0 < 60.0


def test_a_deadlock_fails_within_the_timeout():
    """Both ranks wait on a receive: the group's timeout (or the
    parent's deadline) ends the run with an error, never a hang."""
    t0 = time.perf_counter()
    with pytest.raises((RuntimeError, TimeoutError)):
        run_stage_ranks(_deadlock, 2, "cpu", timeout_s=30.0,
                        pg_timeout_s=3.0)
    assert time.perf_counter() - t0 < 60.0


def test_launcher_runs_mpmd_and_matches_spmd(capfd, tmp_path):
    """``train.main --execution mpmd --device cpu`` prints the transport
    and the same losses as the SPMD run; a resumed run continues them."""
    import json
    from repro_torch.launch import train as ttrain
    base = ["--smoke", "--device", "cpu", "--pipe", "2", "--layers", "4",
            "--schedule", "2bw", "--batch", "4", "--seq", "16",
            "--log-every", "1", "--json", "--data-kind", "uniform"]

    def losses(out):
        return [json.loads(x)["loss"] for x in out.splitlines()
                if x.startswith("{")]
    assert ttrain.main(base + ["--steps", "3"]) == 0
    want = losses(capfd.readouterr().out)
    ck = ["--ckpt-dir", str(tmp_path), "--save-every", "2",
          "--execution", "mpmd"]
    assert ttrain.main(base + ["--steps", "2"] + ck) == 0
    out = capfd.readouterr().out
    assert "gloo on CPU tensors, 2 ranks on the CPU" in out
    assert os.path.isdir(tmp_path / "step_00000001")
    assert ttrain.main(base + ["--steps", "3", "--resume", "auto"] + ck) \
        == 0
    assert losses(capfd.readouterr().out) == want[2:]


@pytest.mark.parametrize("sizes,chunks,dtype", [
    ((2, 2), (1,), None), ((3, 1, 2), (0, 2), "bfloat16"),
    ((1, 1, 1, 1), (0, 1, 2, 3), None)])
def test_init_part_keeps_the_slices_of_the_whole_draw(sizes, chunks, dtype):
    """A rank's part drawn by ``Model.init_part`` is the whole draw's
    chunk rows and outer leaves, value for value."""
    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(get_config("granite-8b")).replace(
        n_layers=sum(sizes))
    m = Model(cfg, device="cpu")
    whole = m.init(torch.Generator().manual_seed(3), dtype=dtype)
    part = m.init_part(torch.Generator().manual_seed(3), sizes, chunks,
                       lambda path: path[:2] == ("embed", "tok"),
                       dtype=dtype)
    assert list(part["outer"]) == ["embed"] and \
        list(part["outer"]["embed"]) == ["tok"]
    assert torch.equal(part["outer"]["embed"]["tok"],
                       whole["outer"]["embed"]["tok"])
    split = m.partition_stage_params(whole["stages"], sizes,
                                     n_chunks=len(sizes))
    for q, t in enumerate(part["stages"]):
        if q not in chunks:
            assert t == {}
            continue
        for a, b in zip(tree_leaves(t), tree_leaves(split[q])):
            assert a.dtype == b.dtype and torch.equal(a, b)


_TORCHRUN_RANK = """
import sys, torch
from repro_torch.launch.mesh import run_stage_ranks

def fn(group):
    x = torch.full((3,), float(group.rank))
    (y,) = group.exchange([(x, group.next, 1)],
                          [((3,), torch.float32, group.prev, 1)])
    return group.rank, group.world, group.transport, float(y[0])

print("RESULT", run_stage_ranks(fn, 2, "cpu", pg_timeout_s=30.0))
"""


def test_run_stage_ranks_joins_a_torchrun_group(tmp_path):
    """With ``RANK`` / ``WORLD_SIZE`` set (as ``torchrun`` sets them, here
    by hand on a localhost port), each process joins that group and runs
    ``fn`` itself, returning ``[its result]``."""
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCHRUN_RANK], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=src, RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
        for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    got = [next(x for x in o.splitlines() if x.startswith("RESULT"))
           for o in outs]
    assert got == ["RESULT [(0, 2, 'gloo', 1.0)]",
                   "RESULT [(1, 2, 'gloo', 0.0)]"]
