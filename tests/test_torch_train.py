"""The port's streaming SpecTrain runtime against the JAX package's.

The same weights (the JAX model's, carried over by
``from_jax_params``) and the same numpy batches go through JAX's
``pipeline_stream.make_state`` / ``make_train_step(plan=None)`` and the
port's twins, tick by tick, on the CPU in fp32.  The port's attention
backward there is ``flash_bwd_ref`` (the kernels' formula), the JAX
side's autodiff of ``_attend``.

Tolerances: every loss within rtol 1e-5; every state leaf (params,
momentum, prediction, rings, weight stash) within rtol 1e-4 / atol 1e-5
after 2(S-1)+3 ticks: the two run the same fp32 arithmetic in another
summation order, compounded over the ticks' updates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core import pipeline_stream as jps
from repro.core import spectrain as jst
from repro.models import Model as JModel
from repro.planner import plan as jplan
from repro.planner import synthetic_profile as jsynthetic
from repro_torch.core import pipeline_stream as tps
from repro_torch.models import Model, from_jax_params
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.planner import plan as tplan
from repro_torch.planner import synthetic_profile as tsynthetic
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
LR = 0.05


def _batches(cfg, n, *, batch=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1))
        t = t.astype(np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    return out


def _pair(S, n_layers):
    """A tiny fp32 granite-8b on S stages: (JAX cfg, JAX model, JAX
    params, port model on the CPU, the same params in the port)."""
    cfg = tiny_cfg("granite-8b", n_layers=n_layers, pipe=S, n_kv_heads=2)
    jm = JModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_cfg(cfg), device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tm.cfg,
                              device="cpu")
    return cfg, jm, jparams, tm, tparams


def _close(got, want, rtol=STATE_RTOL, atol=STATE_ATOL, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=what)


def _close_trees(got, want, what):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert tuple(g.shape) == tuple(w.shape), (what, i)
        _close(g, w, what=f"{what} leaf {i}")


def _repair_pipedream(js):
    """The JAX state with the reference's pipedream fault repaired for
    the next tick: stages with fb_gap 0 (the last) read their backward
    weights from ring slot ``tick % R``, which the JAX step reads before
    it writes this tick's weights there; writing the current weights into
    it first gives the backward the weights its forward ran on, as the
    port does (ROADMAP §C).  The step then writes the same weights there
    itself, so the rest of the state is unchanged."""
    S = len(js["w_stash"])
    last = js["w_stash"][S - 1]
    R = jax.tree.leaves(last)[0].shape[0]
    slot = int(js["tick"]) % R
    fixed = jax.tree.map(lambda r, p: r.at[slot].set(p), last,
                         js["params"]["stages"][S - 1])
    return dict(js, w_stash=tuple(js["w_stash"][:S - 1]) + (fixed,))


def _run(S, n_layers, mode, *, ticks=None, fused_predict=False, clip=None,
         ticks_per_step=1, bwd_dtype=None, batch=4, repair_reference=True):
    """``repair_reference``: in pipedream mode, hold the port to the JAX
    runtime with its last-stage stash fault repaired (see
    ``_repair_pipedream``); False runs the JAX runtime as it is."""
    cfg, jm, jparams, tm, tparams = _pair(S, n_layers)
    n = ticks or 2 * (S - 1) + 3
    bs = _batches(cfg, n, batch=batch)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       bs[0])
    kw = dict(mode=mode, ticks_per_step=ticks_per_step)
    js = jps.make_state(jm, jparams, sds, fused_predict=fused_predict, **kw)
    ts = tps.make_state(tm, tparams, bs[0], fused_predict=fused_predict,
                        **kw)
    skw = dict(lr=LR, clip=clip, bwd_dtype=bwd_dtype, **kw)
    jstep = jax.jit(jps.make_train_step(jm, fused_predict=fused_predict,
                                        **skw))
    tstep = tps.make_train_step(tm, **skw)
    jl, tl = [], []
    for b in bs:
        if mode == "pipedream" and repair_reference:
            js = _repair_pipedream(js)
        js, jmet = jstep(js, b)
        ts, tmet = tstep(ts, b)
        jl.append((float(jmet["loss"]), float(jmet["loss_valid"])))
        tl.append((float(tmet["loss"]), float(tmet["loss_valid"])))
    return js, ts, jl, tl


def _check(js, ts, jl, tl, S, mode, fused_predict=False):
    assert [v for _, v in tl] == [v for _, v in jl]
    np.testing.assert_allclose([x for x, _ in tl], [x for x, _ in jl],
                               rtol=LOSS_RTOL)
    _close_trees(ts["params"], js["params"], "params")
    _close_trees(ts["momentum"], js["momentum"], "momentum")
    assert ts["tick"] == int(js["tick"]) and ts["step"] == int(js["step"])
    for key in ("fwd_buf", "bwd_buf", "stash_x"):
        _close(ts[key], js[key], what=key)
    for key in ("tokens", "targets"):
        np.testing.assert_array_equal(ts["batch_ring"][key].numpy(),
                                      np.asarray(js["batch_ring"][key]))
    if mode == "pipedream":
        _close_trees(ts["w_stash"], js["w_stash"], "w_stash")
    if mode == "spectrain":
        s_fwd = [2 * (S - 1 - k) for k in range(S)]
        if fused_predict:
            want_stages = js["pred"]["stages"]
            want_tok = js["pred"]["outer"]["embed"]["tok"]
        else:
            # what the JAX twin predicts at the start of the next tick
            want_stages = tuple(
                jst.predict_weights(w, v, LR, s) for w, v, s in zip(
                    js["params"]["stages"], js["momentum"]["stages"],
                    s_fwd))
            want_tok = jst.predict_weights(
                js["params"]["outer"], js["momentum"]["outer"], LR,
                s_fwd[0])["embed"]["tok"]
        _close_trees(ts["pred"]["stages"], want_stages, "pred stages")
        _close(ts["pred"]["outer"]["embed"]["tok"], want_tok,
               what="pred tok")


# S in {2, 3, 4} and the ragged 7-layer/3-stage split, all three modes
PARITY = [(S, L, mode) for S, L in ((2, 4), (3, 6), (4, 4), (3, 7))
          for mode in tps.MODES]


@pytest.mark.parametrize("S,L,mode", PARITY)
def test_tick_matches_jax(S, L, mode):
    js, ts, jl, tl = _run(S, L, mode)
    _check(js, ts, jl, tl, S, mode)


@pytest.mark.parametrize("S,L", [(2, 4), (4, 4)])
def test_fused_predict_matches_jax(S, L):
    js, ts, jl, tl = _run(S, L, "spectrain", fused_predict=True)
    assert ts["pred"]["stages"][0]["layers"]["attn"]["wq"].dtype == \
        torch.float32      # tiny_cfg computes in fp32
    _check(js, ts, jl, tl, S, "spectrain", fused_predict=True)


@pytest.mark.parametrize("mode", ["spectrain", "vanilla"])
def test_clip_matches_jax(mode):
    js, ts, jl, tl = _run(3, 6, mode, clip=0.5)
    _check(js, ts, jl, tl, 3, mode)


def test_ticks_per_step_matches_jax():
    js, ts, jl, tl = _run(2, 4, "spectrain", ticks=4, ticks_per_step=2,
                          batch=8)
    _check(js, ts, jl, tl, 2, "spectrain")


def test_bwd_dtype_matches_jax():
    """bf16 backward: gradients come back in bf16 on both sides (the
    weights are cast before the backward); held to the bf16 kernel
    tolerance, since the two frameworks round bf16 at other places."""
    js, ts, jl, tl = _run(2, 4, "spectrain", bwd_dtype="bfloat16")
    np.testing.assert_allclose([x for x, _ in tl], [x for x, _ in jl],
                               rtol=2e-2)
    for g, w in zip(tree_leaves(ts["params"]),
                    jax.tree.leaves(js["params"])):
        _close(g, w, rtol=2e-2, atol=2e-2)


def test_warmup_validity_and_frozen_stage0():
    """loss_valid turns 1 at tick S-1; stage 0's weights stay as they
    were until its first backward at tick 2(S-1) and move after it."""
    S = 4
    cfg, _, _, tm, tparams = _pair(S, 4)
    bs = _batches(cfg, 2 * (S - 1) + 2)
    ts = tps.make_state(tm, tparams, bs[0], mode="spectrain")
    step = tps.make_train_step(tm, mode="spectrain", lr=LR)
    first = ts["params"]["stages"][0]["layers"]["attn"]["wq"].clone()
    for t, b in enumerate(bs):
        ts, met = step(ts, b)
        assert met["loss_valid"] == (1.0 if t >= S - 1 else 0.0)
        now = ts["params"]["stages"][0]["layers"]["attn"]["wq"]
        assert torch.equal(now, first) == (t < 2 * (S - 1)), t


def test_degenerate_single_stage_matches_jax():
    """S == 1: one plain momentum-SGD step over the whole model, as the
    JAX runtime's degenerate step."""
    cfg, jm, jparams, tm, tparams = _pair(1, 2)
    bs = _batches(cfg, 3)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       bs[0])
    js = jps.make_state(jm, jparams, sds)
    ts = tps.make_state(tm, tparams, bs[0])
    jstep = jax.jit(jps.make_train_step(jm, lr=LR, clip=1.0))
    tstep = tps.make_train_step(tm, lr=LR, clip=1.0)
    for b in bs:
        js, jmet = jstep(js, b)
        ts, tmet = tstep(ts, b)
        _close(tmet["loss"], jmet["loss"], rtol=LOSS_RTOL, atol=0)
        assert tmet["loss_valid"] == 1.0
    _close_trees(ts["params"], js["params"], "params")
    _close_trees(ts["momentum"], js["momentum"], "momentum")


def test_spectrain_not_worse_than_vanilla():
    """The paper's central claim on the port's runtime (the JAX twin's
    ``test_spectrain_tracks_sync_better_than_vanilla``): on a fixed
    batch, after 40 ticks spectrain's loss is at most vanilla's."""
    finals = {}
    for mode in ("vanilla", "spectrain"):
        cfg, _, _, tm, tparams = _pair(4, 4)
        b = _batches(cfg, 1, batch=8)[0]
        ts = tps.make_state(tm, tparams, b, mode=mode)
        step = tps.make_train_step(tm, mode=mode, lr=0.08)
        for _ in range(40):
            ts, met = step(ts, b)
        finals[mode] = float(met["loss"])
    assert finals["spectrain"] <= finals["vanilla"] + 1e-3, finals


def test_pipedream_last_stage_reads_old_stash_slot():
    """Shows a fault of the reference that the port repairs: in
    ``pipedream`` mode the JAX runtime's last stage (fb_gap 0) reads its
    backward weights from the stash slot it is about to overwrite, i.e.
    the weights of tick t - R, not the current ones its forward used.
    After 2 ticks (the last stage updated once) the slot the next tick
    reads still holds the initial weights while the stage has moved.  The
    port takes that backward at the current weights, so after 2(S-1)+3
    ticks its last stage's momentum has left the unrepaired reference's
    (~4e-5 apart, ~1e-8 from the repaired one, which
    ``test_tick_matches_jax`` holds it to)."""
    S, R = 2, 3
    cfg, _, jparams, _, _ = _pair(S, 4)
    init = np.asarray(jparams["stages"][S - 1]["layers"]["attn"]["wq"])
    js, _, _, _ = _run(S, 4, "pipedream", ticks=2, repair_reference=False)
    t = int(js["tick"])                 # the next tick reads slot t % R
    read = np.asarray(js["w_stash"][S - 1]["layers"]["attn"]["wq"][t % R])
    cur = np.asarray(js["params"]["stages"][S - 1]["layers"]["attn"]["wq"])
    np.testing.assert_array_equal(read, init)
    assert not np.array_equal(cur, init)

    js, ts, _, _ = _run(S, 4, "pipedream", repair_reference=False)
    # the momentum holds the gradients the two backwards took
    got = tree_leaves(ts["momentum"]["stages"][S - 1])
    want = jax.tree.leaves(js["momentum"]["stages"][S - 1])
    assert not all(np.allclose(g.numpy(), np.asarray(w), rtol=STATE_RTOL,
                               atol=STATE_ATOL) for g, w in zip(got, want))


def test_plan_raises_not_ported():
    """``plan=`` runs (it used to raise, the planner not being ported): a
    stream plan whose dp split of 7 layers on 3 stages, over a skewed
    profile, differs from the model's own (3, 2, 2) drives the port's
    tick as the JAX plan drives JAX's (spectrain: the plan's prediction
    distances; pipedream: its ring offsets over the regrouped weight
    stash); a round-schedule plan is refused by both."""
    cfg, jm, jparams, tm, tparams = _pair(3, 7)
    kw = dict(n_stages=3, schedule="stream", partitioner="dp",
              profile=jsynthetic([3, 1, 1, 1, 1, 1, 1]))
    jp = jplan(cfg, **kw)
    tp = tplan(tm.cfg, **dict(kw, profile=tsynthetic([3, 1, 1, 1, 1, 1,
                                                      1])))
    assert tp.partition.sizes() == jp.partition.sizes() == (1, 3, 3)
    assert (tp.s_fwd, tp.bwd_lag, tp.fb_gap) == (
        tuple(jp.s_fwd), tuple(jp.bwd_lag), tuple(jp.fb_gap))
    bs = _batches(cfg, 2 * 2 + 3)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       bs[0])
    for mode in ("spectrain", "pipedream"):
        js = jps.make_state(jm, jparams, sds, mode=mode, plan=jp)
        ts = tps.make_state(
            tm, tree_map(lambda _, a: a.clone(), tparams), bs[0],
            mode=mode, plan=tp)
        assert [tree_leaves(t)[0].shape[0] for t in
                ts["params"]["stages"]] == [1, 3, 3]
        jstep = jax.jit(jps.make_train_step(jm, mode=mode, lr=LR, plan=jp))
        tstep = tps.make_train_step(tm, mode=mode, lr=LR, plan=tp)
        jl, tl = [], []
        for b in bs:
            if mode == "pipedream":
                js = _repair_pipedream(js)
            js, jmet = jstep(js, b)
            ts, tmet = tstep(ts, b)
            jl.append((float(jmet["loss"]), float(jmet["loss_valid"])))
            tl.append((float(tmet["loss"]), float(tmet["loss_valid"])))
        _check(js, ts, jl, tl, 3, mode)
    round_plan = tplan(tm.cfg, n_stages=3, schedule="1f1b")
    for make in (lambda: jps.make_state(jm, jparams, sds, plan=jplan(
            cfg, n_stages=3, schedule="1f1b")),
                 lambda: tps.make_state(tm, tparams, bs[0],
                                        plan=round_plan)):
        with pytest.raises(ValueError, match="stream schedule"):
            make()


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
    assert jnp.zeros(()).devices()
