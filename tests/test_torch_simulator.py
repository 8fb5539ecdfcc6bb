"""The port's paper-exact simulator against the JAX package's.

The same weights (JAX ``make_mlp_staged``'s, or a JAX granite's carried
over by ``from_jax_params``) and the same numpy batches go through
``repro.core.simulator.Simulator`` and ``repro_torch.core.simulator.
Simulator`` step by step, on the CPU in fp32.  Compared: every metric
of every step (loss and the Fig. 8 RMSEs) and the final parameter tree,
within rtol 1e-5 / atol 1e-6 over 10 steps: the two run the same fp32
arithmetic in another summation order.

Then the JAX test file's claims (``tests/test_simulator.py``), on the
port alone at the JAX sizes, and the port's own mechanics: the
copy-on-write history and the update in N + 1 groups.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core import simulator as jsim
from repro.models import Model as JModel
from repro.planner import plan as jplan
from repro_torch.core import simulator as tsim
from repro_torch.kernels import ops
from repro_torch.models import Model, from_jax_params
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import sgd
from repro_torch.planner import plan as tplan
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
STEPS = 10
IN_DIM, CLASSES = 16, 8


def _to_port(tree):
    """A JAX tree (dicts, lists, tuples of arrays) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_port(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _mlp_pair(n_stages, depth, width=32, sizes=None, seed=0):
    jfns, jparams = jsim.make_mlp_staged(
        jax.random.PRNGKey(seed), in_dim=IN_DIM, width=width, depth=depth,
        n_classes=CLASSES, n_stages=n_stages, sizes=sizes)
    tfns, _ = tsim.make_mlp_staged(
        torch.Generator().manual_seed(seed), in_dim=IN_DIM, width=width,
        depth=depth, n_classes=CLASSES, n_stages=n_stages, sizes=sizes,
        device="cpu")
    return jfns, jparams, tfns, _to_port(jax.tree.map(np.asarray, jparams))


def _teacher(n, *, batch=32, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((IN_DIM, CLASSES)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.standard_normal((batch, IN_DIM)).astype(np.float32)
        out.append({"x": x, "y": (x @ w_true).argmax(-1).astype(np.int32)})
    return out


def _close_trees(got, want, what):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} leaf {i}")


def _run_pair(jfns, jparams, tfns, tparams, batches, *, jkw=None, tkw=None,
              **kw):
    """Both simulators over ``batches``; every metric of every step and
    the final parameters compared.  Returns the port's metrics."""
    js = jsim.Simulator(jfns, jparams, **kw, **(jkw or {}))
    ts = tsim.Simulator(tfns, tparams, **kw, **(tkw or {}))
    tms = []
    for i, b in enumerate(batches):
        jm, tm = js.step(b), ts.step(b)
        assert jm.keys() == tm.keys(), i
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
        tms.append(tm)
    assert js.latest == ts.latest
    _close_trees(ts.params, js.params, "final params")
    return tms


# ---------------------------------------------------------------------------
# parity with the JAX simulator


@pytest.mark.parametrize("n_stages", [1, 2, 4])
@pytest.mark.parametrize("scheme", tsim.Simulator.SCHEMES)
def test_schemes_match_jax(scheme, n_stages):
    """Every scheme on 1, 2 and 4 stages, Fig. 8's RMSEs on."""
    jf, jp, tf, tp = _mlp_pair(n_stages, 4)
    ms = _run_pair(jf, jp, tf, tp, _teacher(STEPS), n_stages=n_stages,
                   scheme=scheme, lr=0.05, rmse_s=(1, 2, 3))
    assert "rmse_pred_s3" in ms[-1]


@pytest.mark.parametrize("scheme", tsim.Simulator.SCHEMES)
def test_ragged_stages_match_jax(scheme):
    jf, jp, tf, tp = _mlp_pair(2, 4, sizes=(1, 3))
    _run_pair(jf, jp, tf, tp, _teacher(STEPS), n_stages=2, scheme=scheme,
              lr=0.05)


@pytest.mark.parametrize("scheme", ["vanilla", "spectrain"])
def test_clip_matches_jax(scheme):
    jf, jp, tf, tp = _mlp_pair(4, 4)
    _run_pair(jf, jp, tf, tp, _teacher(STEPS), n_stages=4, scheme=scheme,
              lr=0.2, clip=0.5)


@pytest.mark.parametrize("scheme", ["pipedream", "spectrain"])
def test_plan_staleness_matches_jax(scheme):
    """The port's own stream plan (s_fwd = 2(N-1-k), s_bwd = 0) against
    the JAX simulator given the JAX plan."""
    p = jplan(n_layers=4, n_stages=4, schedule="stream")
    tp_plan = tplan(n_layers=4, n_stages=4, schedule="stream")
    assert tp_plan.s_fwd == tuple(p.s_fwd) == (6, 4, 2, 0)
    assert tp_plan.s_bwd == tuple(p.s_bwd)
    jf, jp, tf, tp = _mlp_pair(4, 4)
    _run_pair(jf, jp, tf, tp, _teacher(STEPS), jkw={"plan": p},
              tkw={"plan": tp_plan}, scheme=scheme, lr=0.05, rmse_s=(1, 2))


@pytest.mark.parametrize("schedule,v", [("1f1b_rr", 1), ("2bw", 1),
                                        ("interleaved", 2)])
def test_port_plans_match_jax(schedule, v):
    """The port's round-robin, 2BW and interleaved chunk plans (4 chunk
    stages) drive the port's simulator as the JAX plans drive JAX's."""
    kw = dict(n_layers=4, n_stages=4 // v, schedule=schedule,
              virtual_stages=v)
    p, t = jplan(**kw), tplan(**kw)
    assert (t.n_chunks, t.s_fwd, t.s_bwd) == (p.n_chunks, tuple(p.s_fwd),
                                              tuple(p.s_bwd))
    jf, jp, tf, tp = _mlp_pair(4, 4)
    _run_pair(jf, jp, tf, tp, _teacher(STEPS), jkw={"plan": p},
              tkw={"plan": t}, scheme="spectrain", lr=0.05)


def test_staged_from_model_interleaved_chunks_match_jax():
    """An interleaved plan's 4 chunk trees of a 4-layer granite on 2
    devices, through ``staged_from_model(partition=...)`` on both
    sides."""
    cfg = tiny_cfg("granite-8b", n_layers=4, pipe=2, n_kv_heads=2)
    jm = JModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_cfg(cfg), device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tm.cfg,
                              device="cpu")
    kw = dict(n_stages=2, schedule="interleaved", virtual_stages=2,
              n_layers=4)
    p, t = jplan(**kw), tplan(**kw)
    jf, jrepack = jsim.staged_from_model(jm, p.partition)
    tf, trepack = tsim.staged_from_model(tm, t.partition)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
        batches.append({"tokens": tok[:, :-1], "targets": tok[:, 1:]})
    _run_pair(jf, jrepack(jparams), tf, trepack(tparams), batches,
              jkw={"plan": p}, tkw={"plan": t}, scheme="spectrain",
              lr=0.05)


@pytest.mark.parametrize("scheme", tsim.Simulator.SCHEMES)
def test_staged_from_model_matches_jax(scheme):
    """A 4-layer narrow granite on 2 stages through ``staged_from_model``
    (the flash attention's plain forward and backward on the port's
    side, autodiff of ``_attend`` on JAX's)."""
    cfg = tiny_cfg("granite-8b", n_layers=4, pipe=2, n_kv_heads=2)
    jm = JModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_cfg(cfg), device="cpu")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tm.cfg,
                              device="cpu")
    jf, jrepack = jsim.staged_from_model(jm)
    tf, trepack = tsim.staged_from_model(tm)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(STEPS):
        t = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    _run_pair(jf, jrepack(jparams), tf, trepack(tparams), batches,
              n_stages=2, scheme=scheme, lr=0.05, rmse_s=(1,))


def test_constructor_checks_match_jax():
    jf, jp, tf, tp = _mlp_pair(4, 4)
    two = jplan(n_layers=4, n_stages=2)
    for sim, fns, params in ((jsim.Simulator, jf, jp),
                             (tsim.Simulator, tf, tp)):
        with pytest.raises(ValueError):
            sim(fns, params, n_stages=4, plan=two)
        with pytest.raises(ValueError):
            sim(fns, params)            # neither n_stages nor plan
    with pytest.raises(ValueError, match="scheme"):
        tsim.Simulator(tf, tp, n_stages=4, scheme="gpipe")
    # a chunk count that disagrees with the partition: both refuse
    jm = JModel(tiny_cfg("granite-8b", n_layers=4, pipe=2))
    tm = Model(port_cfg(jm.cfg), device="cpu")
    for m in (jm, tm):
        with pytest.raises(ValueError, match="partition stages for"):
            m.partition_stage_params(({"layers": {}},), (2, 2), n_chunks=4)


# ---------------------------------------------------------------------------
# the JAX test file's claims, on the port at the JAX sizes


def _port_run(scheme, steps=120, lr=0.05, n_stages=4, rmse_s=(), seed=0):
    fns, params = tsim.make_mlp_staged(
        torch.Generator().manual_seed(seed), in_dim=IN_DIM, width=32,
        depth=4, n_classes=CLASSES, n_stages=n_stages, device="cpu")
    sim = tsim.Simulator(fns, params, n_stages=n_stages, scheme=scheme,
                         lr=lr, gamma=0.9, rmse_s=rmse_s)
    return sim, [sim.step(b) for b in _teacher(steps, seed=seed)]


def test_all_schemes_converge():
    for scheme in tsim.Simulator.SCHEMES:
        _, ms = _port_run(scheme)
        losses = [m["loss"] for m in ms]
        assert np.isfinite(losses).all(), scheme
        assert np.mean(losses[-20:]) < np.mean(losses[:20]), scheme


def test_sync_is_exact_sgd():
    """scheme=sync equals a plain momentum-SGD loop over the whole model
    (autograd of the composed loss, ``sgd.update`` of the whole tree)."""
    fns, params = tsim.make_mlp_staged(
        torch.Generator().manual_seed(0), in_dim=IN_DIM, width=32, depth=4,
        n_classes=CLASSES, n_stages=2, device="cpu")
    sim = tsim.Simulator(fns, params, n_stages=2, scheme="sync", lr=0.05)

    def loss_fn(p, batch):
        x = fns.embed(p["outer"]["in"], batch)
        for k in range(2):
            x = fns.stage(p["stages"][k], x)
        return fns.head_loss(p["outer"]["out"], x, batch)

    ref = tree_map(lambda _, a: a.clone(), params)
    mom = sgd.init(ref)
    for b in _teacher(5):
        sim.step(b)
        tb = tsim._batch_on(b, "cpu")
        leaves = tree_leaves(ref)
        for t in leaves:
            t.requires_grad_()
        gs = iter(torch.autograd.grad(loss_fn(ref, tb), leaves))
        grads = tree_map(lambda _, a: next(gs), ref)
        ref = tree_map(lambda _, a: a.detach(), ref)
        sgd.update(ref, mom, grads, lr=0.05, gamma=0.9)
    for a, b in zip(tree_leaves(sim.params), tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_single_stage_pipeline_equals_sync():
    """N=1 pipelining has no staleness: any scheme == sync."""
    for scheme in ("vanilla", "pipedream", "spectrain"):
        fns, params = tsim.make_mlp_staged(
            torch.Generator().manual_seed(0), in_dim=IN_DIM, width=32,
            depth=2, n_classes=CLASSES, n_stages=1, device="cpu")
        sim = tsim.Simulator(fns, params, n_stages=1, scheme=scheme,
                             lr=0.05)
        ref = tsim.Simulator(fns, params, n_stages=1, scheme="sync",
                             lr=0.05)
        for b in _teacher(5):
            sim.step(b)
            ref.step(b)
        for a, b in zip(tree_leaves(sim.params), tree_leaves(ref.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL)


def test_pred_beats_stale():
    """Fig. 8: prediction RMSE < stale-weight RMSE for s in {1,2,3}."""
    _, ms = _port_run("spectrain", steps=150, rmse_s=(1, 2, 3))
    for s in (1, 2, 3):
        pred = np.mean([m[f"rmse_pred_s{s}"] for m in ms[20:]])
        stale = np.mean([m[f"rmse_stale_s{s}"] for m in ms[20:]])
        assert pred < stale, (s, pred, stale)


def test_stale_rmse_grows_with_s():
    _, ms = _port_run("spectrain", steps=150, rmse_s=(1, 3))
    s1 = np.mean([m["rmse_stale_s1"] for m in ms[20:]])
    s3 = np.mean([m["rmse_stale_s3"] for m in ms[20:]])
    assert s3 > s1


def test_final_loss_ordering():
    """Table 1 / Fig. 11 at the JAX test's sizes, lr and bounds: the
    median over three fixed seeds of the last 40 steps' mean loss."""
    finals = {}
    for scheme in tsim.Simulator.SCHEMES:
        per_seed = [np.mean([m["loss"] for m in _port_run(
            scheme, steps=250, lr=0.12, seed=seed)[1][-40:]])
            for seed in (0, 1, 2)]
        finals[scheme] = float(np.median(per_seed))
    assert finals["spectrain"] <= finals["vanilla"] * 1.05, finals
    assert finals["spectrain"] <= finals["pipedream"] * 1.05, finals
    assert finals["spectrain"] <= finals["sync"] * 1.25 + 0.05, finals


# ---------------------------------------------------------------------------
# the port's mechanics


@pytest.mark.parametrize("scheme", ["sync", "spectrain"])
def test_history_is_copy_on_write(scheme):
    """The in-place update writes only the version it creates: every
    stored version, the caller's parameters among them, stays bit for
    bit as it was when written, and versions no step wrote alias the
    one before them."""
    fns, params = tsim.make_mlp_staged(
        torch.Generator().manual_seed(0), in_dim=IN_DIM, width=32, depth=4,
        n_classes=CLASSES, n_stages=4, device="cpu")
    given = [t.clone() for t in tree_leaves(params)]
    sim = tsim.Simulator(fns, params, n_stages=4, scheme=scheme, lr=0.05)
    snaps = {}
    for b in _teacher(12):
        v = sim.step(b)["version"]
        snaps[v] = ([t.clone() for t in tree_leaves(sim.hist[v])],
                    [t.clone() for t in tree_leaves(sim.mhist[v])])
        for u in sim.hist:
            if u in snaps:
                assert all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(sim.hist[u]), snaps[u][0])), (v, u)
                assert all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(sim.mhist[u]), snaps[u][1])), (v, u)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 given))
    if scheme == "spectrain":
        fresh = tsim.Simulator(fns, params, n_stages=4, scheme=scheme)
        fresh._ensure(3)
        assert fresh.hist[3] is fresh.hist[0]
        assert fresh.mhist[3] is fresh.mhist[0]


def test_update_runs_one_group_per_stage_and_outer(monkeypatch):
    """The full-width SNN's layout (32 layers on 4 stages, 68 leaves) at
    a narrow width: each step updates in N + 1 = 5 groups, none over the
    kernel's 64 tensors."""
    fns, params = tsim.make_mlp_staged(
        torch.Generator().manual_seed(0), in_dim=12, width=8, depth=32,
        n_classes=10, n_stages=4, device="cpu")
    assert len(tree_leaves(params)) == 68
    groups = []
    real = ops.fused_update

    def counting(ws, *a, **kw):
        groups.append(len(ws))
        return real(ws, *a, **kw)

    monkeypatch.setattr(ops, "fused_update", counting)
    sim = tsim.Simulator(fns, params, n_stages=4, scheme="spectrain",
                         lr=0.05)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.standard_normal((4, 12)).astype(np.float32)
        sim.step({"x": x, "y": rng.integers(0, 10, 4)})
    assert groups == [4, 16, 16, 16, 16] * 3
