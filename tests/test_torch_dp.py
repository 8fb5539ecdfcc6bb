"""The data-parallel baseline of the port, held to the JAX package on the
CPU: the rank grids and the data rules (``runtime/mesh_utils.py``,
``launch/mesh.py``, ``runtime/sharding.py``), the host-level pod
references (``core/async_dp.py``), the paper's Data-P figure twins
(``bench/{_timeline,throughput,breakdown,comm_time,comm_volume}.py``)
and ``launch/train.py --data 2`` (two gloo replicas).

Claims:
  * every spec function (``logical_rules``, ``decode_rules``,
    ``spec_for_leaf``, ``shardings_for``, ``momentum_rules``,
    ``batch_specs``) gives JAX's specs, as tuples, on granite-8b's and
    rwkv6-7b's full-size param, momentum and batch trees, at
    test_sharding.py's sizes (data 16, pipe 4, tensor 4) and on the
    production and smoke grids; ``refine_mesh`` / ``axis_sizes`` as
    JAX's, the ``ValueError`` included;
  * ``SyncPodDP`` and ``AsyncPodDP`` (predict on and off, delay 1 and 8,
    remote_scale 0.5) within rtol 1e-5 / atol 1e-6 of the JAX classes
    over 20 steps at lr 0.5 on test_async_pod.py's problem (numpy
    draws), and the twins of its convergence claims at its learning
    rates (0.2 to 5.0);
  * the figure twins' lines string-equal to the JAX scripts';
  * ``--data 2`` on the CPU, smoke granite, ``--pipe`` 1 and 2, 3 steps:
    the replicas bit-equal, and within rtol 1e-4 / atol 1e-5 of JAX
    ``SyncPodDP(pipeline_sync.pipeline_loss, n_pods=2)`` fed the same
    two shards; all-reduce bytes and calls as the buckets predict;
  * ``all_reduce_mean`` over buckets smaller than a leaf equals the mean
    computed in one process, bit for bit at 2 ranks.

JAX is imported inside the functions that use it: the spawned replicas
import this module and need only torch.  The file takes ~25 s.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import arch_config, get_config, smoke_config
from repro_torch.core import async_dp
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.runtime import mesh_utils, sharding as rsh
from test_torch_threads import one_thread  # noqa: F401

POD_RTOL, POD_ATOL = 1e-5, 1e-6
DP_RTOL, DP_ATOL = 1e-4, 1e-5

# (id, axis names, shape): test_sharding.py's sizes, the production
# grids refined as each arch's mesh plan refines them, the smoke grid
GRIDS = [
    ("sizes-16x4x4", ("data", "pipe", "tensor"), (16, 4, 4)),
    ("production-refined", ("data", "pipe", "tensor"), None),
    ("production-multipod-refined", ("pod", "data", "pipe", "tensor"),
     None),
    ("smoke-refined", ("data", "pipe", "tensor"), (2, 2, 2)),
    ("smoke", ("data", "model"), (2, 4)),
]
ARCHS = ("granite-8b", "rwkv6-7b")


class _FakeMesh:
    """What JAX's logical_rules reads: axis names and a device array."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, object)


def _grid(gid, arch):
    """(port RankMesh, axis names, shape) of grid ``gid`` for ``arch``."""
    plan = get_config(arch).mesh_plan
    names, shape = next((n, s) for g, n, s in GRIDS if g == gid)
    if gid == "production-refined":
        m = mesh_utils.refine_mesh(tmesh.make_production_mesh(), plan.pipe,
                                   plan.tensor)
    elif gid == "production-multipod-refined":
        m = mesh_utils.refine_mesh(
            tmesh.make_production_mesh(multi_pod=True), plan.pipe,
            plan.tensor)
    elif gid == "smoke-refined":
        m = mesh_utils.refine_mesh(tmesh.make_smoke_mesh(), 2, 2)
    elif gid == "smoke":
        m = tmesh.make_smoke_mesh()
    else:
        m = mesh_utils.RankMesh(np.arange(int(np.prod(shape))).reshape(
            shape), names)
    return m, m.axis_names, tuple(m.devices.shape)


def _jax_mesh(names, shape):
    """A JAX mesh of the grid's shape over the one CPU device, repeated:
    enough for NamedSharding, which the JAX spec functions return."""
    import jax
    from jax.sharding import Mesh
    devs = np.empty(int(np.prod(shape)), object)
    devs[:] = [jax.devices()[0]] * devs.size
    return Mesh(devs.reshape(shape), names)


def _jax_specs(tree):
    import jax
    return jax.tree.map(lambda s: tuple(s.spec), tree)


def _port_spec_list(tree):
    out = []
    rsh._spec_leaves(tree, lambda _, sp: out.append(sp))
    return out


# ------------------------------------------------------------ the grids
def test_rank_grids_have_jax_shapes():
    prod = tmesh.make_production_mesh()
    assert (prod.axis_names, prod.devices.shape) == (("data", "model"),
                                                     (16, 16))
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (multi.axis_names, multi.devices.shape) == (
        ("pod", "data", "model"), (2, 16, 16))
    smoke = tmesh.make_smoke_mesh(data=2, model=4)
    assert (smoke.axis_names, smoke.devices.shape) == (("data", "model"),
                                                       (2, 4))
    for m in (prod, multi, smoke):
        assert np.array_equal(m.devices.reshape(-1), np.arange(m.size))


@pytest.mark.parametrize("gid", [g for g, _, _ in GRIDS
                                 if g.endswith("refined")])
def test_refine_mesh_and_axis_sizes_match_jax(gid):
    from repro.runtime import mesh_utils as jmu
    base = {"production-refined": tmesh.make_production_mesh(),
            "production-multipod-refined":
                tmesh.make_production_mesh(multi_pod=True),
            "smoke-refined": tmesh.make_smoke_mesh()}[gid]
    pipe, tensor = (2, 2) if gid.startswith("smoke") else (4, 4)
    jbase = _jax_mesh(base.axis_names, base.devices.shape)
    got = mesh_utils.refine_mesh(base, pipe, tensor)
    want = jmu.refine_mesh(jbase, pipe, tensor)
    assert got.axis_names == tuple(want.axis_names)
    assert mesh_utils.axis_sizes(got) == jmu.axis_sizes(want)
    assert np.array_equal(got.devices, base.devices.reshape(
        got.devices.shape))
    with pytest.raises(ValueError) as e_port:
        mesh_utils.refine_mesh(base, pipe, tensor + 1)
    with pytest.raises(ValueError) as e_jax:
        jmu.refine_mesh(jbase, pipe, tensor + 1)
    assert str(e_port.value) == str(e_jax.value)


def test_axis_groups_and_coords():
    smoke = tmesh.make_smoke_mesh()           # ranks [[0 1 2 3] [4 5 6 7]]
    assert mesh_utils.axis_groups(smoke, "data") == [(0, 4), (1, 5),
                                                     (2, 6), (3, 7)]
    assert mesh_utils.axis_groups(smoke, "model") == [(0, 1, 2, 3),
                                                      (4, 5, 6, 7)]
    assert mesh_utils.rank_coords(smoke, 6) == {"data": 1, "model": 2}
    with pytest.raises(ValueError):
        mesh_utils.axis_groups(smoke, "pipe")


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("gid", [g for g, _, _ in GRIDS])
def test_spec_functions_match_jax(arch, gid):
    """Rules, param and momentum specs (ZeRO-1 and not), batch specs and
    decode rules, leaf for leaf."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import Model as JModel
    from repro.runtime import sharding as jsh
    mesh, names, shape = _grid(gid, arch)
    jfake, jmesh = _FakeMesh(names, shape), _jax_mesh(names, shape)
    tcfg, jcfg = get_config(arch), jget(arch)
    rules = rsh.logical_rules(tcfg, mesh)
    assert rules == jsh.logical_rules(jcfg, jfake)
    for gb in (256, 32, 1):
        assert rsh.decode_rules(tcfg, mesh, global_batch=gb) == \
            jsh.decode_rules(jcfg, jfake, global_batch=gb)
    tm, jm = Model(tcfg, device="cpu"), JModel(jcfg)
    t_axes, t_sds = tm.param_axes(), tm.param_specs()
    j_axes, j_sds = jm.param_axes(), jm.param_sds()
    mom = rsh.momentum_rules(tcfg, rules, mesh)
    assert mom == jsh.momentum_rules(jcfg, jsh.logical_rules(jcfg, jfake),
                                     jfake)
    for r in (rules, mom):
        got = _port_spec_list(rsh.shardings_for(t_axes, t_sds, mesh, r))
        want = [tuple(sh.spec) for sh in jax.tree.leaves(
            jsh.shardings_for(j_axes, j_sds, jmesh, r))]
        assert got == want
        assert len(got) == len(tree_leaves(t_sds))
    for B, s in ((256, 4096), (32, 32768), (1, 8), (6, 16)):
        tb = {"tokens": torch.zeros((B, s), dtype=torch.int64),
              "targets": torch.zeros((B, s), dtype=torch.int64)}
        jb = {k: jax.ShapeDtypeStruct((B, s), np.int32) for k in tb}
        for r in (rules, rsh.decode_rules(tcfg, mesh, global_batch=B)):
            assert rsh.batch_specs(tcfg, tb, mesh, r) == _jax_specs(
                jsh.batch_specs(jcfg, jb, jmesh, r))


def test_spec_for_leaf_cases_match_jax():
    """test_sharding.py's five spec_for_leaf cases, and a pod batch."""
    from repro.runtime.sharding import spec_for_leaf as jspec
    sizes = {"data": 16, "pipe": 4, "tensor": 4}
    rules = {"stage": "pipe", "embed": None, "heads": "tensor",
             "mlp": "tensor", "expert": "tensor", "vocab": "tensor",
             "act_batch": ("data",), "layer": None}
    cases = [(("stage", "layer", "embed", "mlp"), (4, 9, 4096, 14336)),
             (("embed", "mlp"), (4096, 14338)),
             (("expert", "embed", "mlp"), (8, 4096, 32768)),
             (("act_batch", None, None), (256, 128, 64)),
             (("heads",), (2,))]
    for axes, shape in cases:
        assert rsh.spec_for_leaf(axes, shape, rules, sizes) == \
            tuple(jspec(axes, shape, rules, sizes))
    pod = dict(sizes, pod=2)
    prules = dict(rules, act_batch=("pod", "data"))
    for B in (64, 32, 16):
        assert rsh.spec_for_leaf(("act_batch",), (B,), prules, pod) == \
            tuple(jspec(("act_batch",), (B,), prules, pod))


def test_data_rows_follow_the_batch_spec():
    """``local_rows`` cuts contiguous blocks of B / N rows, the block a
    ``data``-sharded leading dim places on each rank."""
    mesh = rsh.data_mesh(4)
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3),
             "targets": -np.arange(8 * 3).reshape(8, 3)}
    cfg = get_config("granite-8b")
    specs = rsh.batch_specs(cfg, batch, mesh, rsh.logical_rules(cfg, mesh))
    assert specs == {"targets": ("data",), "tokens": ("data",)}
    for r in range(4):
        got = rsh.local_rows(batch, specs, mesh, r)
        for k in batch:
            assert np.array_equal(got[k], batch[k][2 * r:2 * r + 2])
    with pytest.raises(ValueError):
        rsh.local_rows({"tokens": np.zeros((6, 3))},
                       {"tokens": ("data",)}, mesh, 0)


def test_fsdp_is_refused_in_three_parts():
    cfg = get_config("granite-8b")
    m = Model(cfg, device="cpu")
    mesh = rsh.data_mesh(2)
    assert rsh.check_data_replicated(cfg, m.param_axes(), m.param_specs(),
                                     mesh) == len(tree_leaves(
                                         m.param_specs()))
    fsdp = cfg.replace(mesh_plan=dataclasses.replace(cfg.mesh_plan,
                                                     fsdp=True))
    with pytest.raises(ValueError, match=r"fsdp=True.*not supported.*"
                       r"replicas.*use a config with fsdp=False"):
        rsh.check_data_replicated(fsdp, m.param_axes(), m.param_specs(),
                                  mesh)
    z = rsh.zero1_layout(cfg, m.param_axes(), m.param_specs(), mesh)
    assert z["sharded"] == z["leaves"] and \
        z["zero1_bytes"] * 2 == z["replicated_bytes"]


@pytest.mark.parametrize("extra,match", [
    (["--mode", "spectrain", "--schedule", "2bw", "--batch", "12"],
     "--data 2 with --schedule 2bw and --batch 12"),
    (["--mode", "sync", "--execution", "mpmd"],
     "--data 2 with --execution mpmd"),
    (["--arch", "deepseek-moe-16b", "--mode", "sync", "--batch", "4",
      "--seq", "8"],
     "--data 2 with deepseek-moe-16b's routing of microbatches of 4 x 8 "
     "tokens"),
    (["--mode", "vanilla", "--batch", "8", "--ticks", "3"],
     "--data 2 with --batch 8 and --ticks 3"),
    (["--mode", "sync", "--batch", "6", "--ticks", "2"],
     "--data 2 with --batch 6 and --ticks 2"),
])
def test_data_gates_refuse_in_three_parts(extra, match):
    with pytest.raises(SystemExit) as e:
        train.main(["--smoke", "--device", "cpu", "--data", "2"] + extra)
    msg = str(e.value)
    assert msg.startswith(f"unsupported combination: {match} — ") and \
        "; supported alternative: " in msg


# ------------------------------------------------------ the pod references
def _pod_problem(seed=0, dim=24, classes=6):
    """test_async_pod.py's problem, drawn with numpy: a teacher W_true,
    small initial weights, per-pod batches of 32."""
    rng = np.random.default_rng(99)
    wtrue = rng.standard_normal((dim, classes)).astype(np.float32)
    w0 = {"w": (np.random.default_rng(seed).standard_normal(
        (dim, classes)) * 0.01).astype(np.float32),
        "b": np.zeros((classes,), np.float32)}

    def batches(step, n_pods=2, bs=32):
        out = []
        for p in range(n_pods):
            x = np.random.default_rng(step * 17 + p).standard_normal(
                (bs, dim)).astype(np.float32)
            out.append({"x": x, "y": (x @ wtrue).argmax(-1)})
        return out

    return w0, batches


def _torch_loss(p, batch):
    logits = torch.as_tensor(batch["x"]) @ p["w"] + p["b"]
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, torch.as_tensor(batch["y"])[:, None])[:, 0]
    return (lse - gold).mean()


def _jax_loss(p, batch):
    import jax
    import jax.numpy as jnp
    logits = batch["x"] @ p["w"] + p["b"]
    lse = jax.nn.logsumexp(logits, -1)
    gold = jnp.take_along_axis(logits, batch["y"][:, None], -1)[:, 0]
    return jnp.mean(lse - gold)


def _port_run(cls, steps, **kw):
    w0, batches = _pod_problem()
    algo = cls(_torch_loss, tree_map(lambda _, a: torch.from_numpy(a), w0),
               **kw)
    return algo, np.asarray([algo.step(batches(s))["loss"]
                             for s in range(steps)])


POD_CASES = [
    ("sync", "SyncPodDP", {}),
    ("async-predict-d1", "AsyncPodDP", {"predict": True, "delay": 1}),
    ("async-stale-d1", "AsyncPodDP", {"predict": False, "delay": 1}),
    ("async-predict-d8", "AsyncPodDP", {"predict": True, "delay": 8}),
    ("async-stale-d8", "AsyncPodDP", {"predict": False, "delay": 8}),
    ("async-scale-0.5", "AsyncPodDP", {"predict": False,
                                       "remote_scale": 0.5}),
    ("async-predict-3pods", "AsyncPodDP", {"predict": True, "n_pods": 3}),
]


@pytest.mark.parametrize("name,cls,kw", POD_CASES,
                         ids=[c[0] for c in POD_CASES])
def test_pod_references_match_jax(name, cls, kw):
    """20 steps at lr 0.5: the loss every step and the final params."""
    import jax
    import jax.numpy as jnp
    from repro.core import async_dp as jdp
    steps, n = 20, kw.get("n_pods", 2)
    w0, batches = _pod_problem()
    jalgo = getattr(jdp, cls)(_jax_loss, jax.tree.map(jnp.asarray, w0),
                              lr=0.5, **kw)
    talgo = getattr(async_dp, cls)(
        _torch_loss, tree_map(lambda _, a: torch.from_numpy(a), w0),
        lr=0.5, **kw)
    for s in range(steps):
        b = batches(s, n_pods=n)
        jl = jalgo.step([jax.tree.map(jnp.asarray, x) for x in b])["loss"]
        tl = talgo.step(b)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=POD_RTOL, atol=POD_ATOL,
                                   err_msg=f"{name} step {s}")
    pairs = ([(talgo.params, jalgo.params)] if cls == "SyncPodDP"
             else list(zip(talgo.params, jalgo.params)))
    for t_tree, j_tree in pairs:
        for k in ("b", "w"):
            np.testing.assert_allclose(t_tree[k].numpy(),
                                       np.asarray(j_tree[k]),
                                       rtol=POD_RTOL, atol=POD_ATOL,
                                       err_msg=f"{name} {k}")


def test_pods_hold_their_own_copies():
    """The update is in place: each pod (and SyncPodDP) works on its own
    copy of the parameters, never the caller's."""
    w0, batches = _pod_problem()
    p0 = tree_map(lambda _, a: torch.from_numpy(a.copy()), w0)
    algo = async_dp.AsyncPodDP(_torch_loss, p0, lr=0.3)
    sync = async_dp.SyncPodDP(_torch_loss, p0, lr=0.3)
    for s in range(3):
        algo.step(batches(s))
        sync.step(batches(s))
    assert np.array_equal(p0["w"].numpy(), w0["w"])
    assert algo.params[0]["w"].data_ptr() != algo.params[1]["w"].data_ptr()
    assert not torch.equal(algo.params[0]["w"], algo.params[1]["w"])


def test_all_variants_converge():
    for cls, kw in [(async_dp.SyncPodDP, {}),
                    (async_dp.AsyncPodDP, {"predict": True}),
                    (async_dp.AsyncPodDP, {"predict": False})]:
        _, losses = _port_run(cls, 150, lr=0.3, **kw)
        assert np.isfinite(losses).all()
        assert losses[-20:].mean() < losses[:10].mean()


def test_prediction_compensates_when_staleness_bites():
    sync = _port_run(async_dp.SyncPodDP, 150, lr=5.0)[1][-25:].mean()
    pred = _port_run(async_dp.AsyncPodDP, 150, lr=5.0, predict=True,
                     delay=8)[1][-25:].mean()
    stale = _port_run(async_dp.AsyncPodDP, 150, lr=5.0, predict=False,
                      delay=8)[1][-25:].mean()
    assert stale > sync + 1e-3
    assert pred < stale - 1e-3
    assert abs(pred - sync) < abs(stale - sync)


def test_benign_regime_prediction_is_neutral():
    sync = _port_run(async_dp.SyncPodDP, 150, lr=0.5)[1][-25:].mean()
    pred = _port_run(async_dp.AsyncPodDP, 150, lr=0.5, predict=True,
                     delay=1)[1][-25:].mean()
    stale = _port_run(async_dp.AsyncPodDP, 150, lr=0.5, predict=False,
                      delay=1)[1][-25:].mean()
    assert abs(pred - sync) < 0.02
    assert abs(stale - sync) < 0.02


def test_pods_stay_close():
    algo, _ = _port_run(async_dp.AsyncPodDP, 60, lr=0.2, predict=True)
    d = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(algo.params[0]), tree_leaves(algo.params[1])))
    assert d < 1.0, d


def test_staleness_aware_lr_scaling():
    _, losses = _port_run(async_dp.AsyncPodDP, 150, lr=0.3, predict=False,
                          remote_scale=0.5)
    assert np.isfinite(losses).all()


# ------------------------------------------------------- the figure twins
@pytest.mark.parametrize("name", ["throughput", "breakdown", "comm_time",
                                  "comm_volume"])
def test_figure_lines_equal_jax(name):
    import importlib
    jmod = importlib.import_module(f"benchmarks.{name}")
    tmod = importlib.import_module(f"repro_torch.bench.{name}")
    assert tmod.main() == jmod.main()


def test_timeline_models_equal_jax():
    from benchmarks import _timeline as jt
    from repro_torch.bench import _timeline as tt
    for tm, jm in zip(tt.paper_models() + tt.lm_models(),
                      jt.paper_models() + jt.lm_models()):
        assert dataclasses.astuple(tm) == dataclasses.astuple(jm)
        for n in (1, 2, 4):
            assert tt.dp_step_time(tm, n) == jt.dp_step_time(jm, n)
            assert tt.pipeline_step_time(tm, n) == \
                jt.pipeline_step_time(jm, n)
    assert [m.name for m in tt.lm_models()] == [
        "whisper-base", "pixtral-12b", "granite-8b", "granite-20b",
        "starcoder2-15b", "minicpm3-4b", "grok-1-314b", "deepseek-moe-16b",
        "rwkv6-7b", "zamba2-1.2b"]


def test_cost_only_configs_equal_jax_and_stay_refused():
    """Every architecture's config equals JAX's in cost; the two that
    were read for their cost only (whisper-base, pixtral-12b) are ported
    now: ``arch_config`` is ``get_config`` and their models build (the
    name is kept from when they were refused)."""
    from repro.configs import get_config as jget
    from repro.configs import list_archs as jlist
    for name in jlist():
        t, j = arch_config(name), jget(name)
        assert (t.param_count(), t.active_param_count()) == \
            (j.param_count(), j.active_param_count())
        assert t.name == j.name and t.n_layers == j.n_layers
    for name in ("whisper-base", "pixtral-12b"):
        assert arch_config(name) == get_config(name)
        Model(smoke_config(arch_config(name)), device="cpu")


# --------------------------------------------------------- the replicas
class DpProbe:
    """``on_step`` of a ``--data`` run, in every replica: its losses and
    all-reduce counters every step; after the last step its params and
    momentum leaves, to ``<out>/replica<r>.npz`` and ``.json``."""

    def __init__(self, out: str, steps: int):
        self.out, self.steps = out, steps
        self.losses, self.xfer = [], []

    def __call__(self, s, state, metrics):
        from repro_torch.runtime import checkpoint as ckpt
        g = rsh.current_group()
        self.losses.append(float(metrics["loss"]))
        self.xfer.append(g.counters())
        # ZeRO-1: the replica's momentum pieces, gathered whole
        state = ckpt.whole_state(state, g)
        g.reset_counters()
        if s == self.steps - 1:
            arrs = {}
            for key in ("params", "momentum"):
                for i, a in enumerate(tree_leaves(state[key])):
                    arrs[f"{key}{i}"] = a.detach().numpy()
            np.savez(os.path.join(self.out, f"replica{g.rank}.npz"),
                     **arrs)
            with open(os.path.join(self.out, f"replica{g.rank}.json"),
                      "w") as f:
                json.dump({"losses": self.losses, "xfer": self.xfer,
                           "transport": g.transport}, f)


DP_STEPS, DP_BATCH, DP_SEQ = 3, 8, 16


@pytest.mark.parametrize("pipe", [1, 2])
def test_data_replicas_match_jax_sync_pod_dp(pipe, tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import smoke_config as jsmoke
    from repro.core import async_dp as jdp
    from repro.core import pipeline_sync as jsync
    from repro.models import Model as JModel
    from repro_torch.data import DataConfig, SyntheticLM
    argv = ["--smoke", "--device", "cpu", "--pipe", str(pipe), "--data",
            "2", "--mode", "sync", "--steps", str(DP_STEPS), "--batch",
            str(DP_BATCH), "--seq", str(DP_SEQ), "--log-every", "1"]
    assert train.main(argv, on_step=DpProbe(str(tmp_path), DP_STEPS)) == 0
    reps = [(json.loads((tmp_path / f"replica{r}.json").read_text()),
             np.load(tmp_path / f"replica{r}.npz")) for r in range(2)]
    assert all(m["transport"] == "gloo" for m, _ in reps)
    # the two replicas bit-equal, every params and momentum leaf
    (_, a0), (_, a1) = reps
    assert sorted(a0.files) == sorted(a1.files)
    for k in a0.files:
        assert np.array_equal(a0[k], a1[k]), k
    # the reference: JAX SyncPodDP on the same weights and shards
    tcfg = train.build(train.parse_args(argv))
    js = jsmoke(jget("granite-8b"))
    jcfg = js.replace(mesh_plan=dataclasses.replace(
        js.mesh_plan, pipe=pipe, tensor=1, num_microbatches=1),
        param_dtype="float32", compute_dtype="float32")
    assert all(getattr(tcfg, f.name) == getattr(jcfg, f.name)
               for f in dataclasses.fields(jcfg)
               if f.name not in ("mesh_plan", "moe", "mla", "ssm"))
    tparams = Model(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    jm = JModel(jcfg)
    shape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    leaves = tree_leaves(tparams)
    assert [tuple(x.shape) for x in jax.tree.leaves(shape)] == \
        [tuple(x.shape) for x in leaves]
    jparams = jax.tree.unflatten(jax.tree.structure(shape),
                                 [jnp.asarray(x.numpy()) for x in leaves])
    ref = jdp.SyncPodDP(lambda p, b: jsync.pipeline_loss(jm, p, b, 1),
                        jparams, n_pods=2, lr=1e-2, gamma=0.9)
    data = SyntheticLM(DataConfig(tcfg.vocab_size, DP_SEQ, DP_BATCH,
                                  seed=0))
    half = DP_BATCH // 2
    for s in range(DP_STEPS):
        b = data.batch_at(s)
        shards = [{k: jnp.asarray(v[r * half:(r + 1) * half], jnp.int32)
                   for k, v in b.items()} for r in range(2)]
        want = ref.step(shards)["loss"]
        got = (reps[0][0]["losses"][s] + reps[1][0]["losses"][s]) / 2
        np.testing.assert_allclose(got, want, rtol=DP_RTOL, atol=DP_ATOL)
    n_leaves = len(leaves)
    for key, tree in (("params", ref.params), ("momentum", ref.mom.v)):
        for i, w in enumerate(jax.tree.leaves(tree)):
            np.testing.assert_allclose(a0[f"{key}{i}"], np.asarray(w),
                                       rtol=DP_RTOL, atol=DP_ATOL,
                                       err_msg=f"{key} leaf {i}")
        assert i == n_leaves - 1
    # one bucket a step holds the whole smoke gradient: ZeRO-1's
    # reduce-scatter (every leaf in two pieces, padded to even length),
    # then the weights' all-gather
    padded = sum(2 * -(-x.numel() // 2) for x in leaves)
    for m, _ in reps:
        for x in m["xfer"]:
            assert (x["n_reduce"], x["n_rs"], x["bytes_rs"]) == \
                (0, 1, 4 * padded)
            assert (x["n_ag"], x["bytes_ag"]) == (1, 4 * padded)
            assert x["n_sent"] == x["n_ctl"] == 0


def _reduce_rank(group, trees, bucket_bytes):
    """Each rank's tree, averaged by ``all_reduce_mean`` over tiny
    buckets; returns the result and the counters."""
    mine = tree_map(lambda _, a: torch.from_numpy(a.copy()),
                    trees[group.rank])
    group.all_reduce_mean(mine, bucket_bytes=bucket_bytes)
    return (tree_map(lambda _, a: a.numpy(), mine), group.counters())


def test_all_reduce_mean_over_small_buckets():
    """Buckets of 1,000 B (250 floats) split every leaf but the scalar
    one; the mean equals ``(a + b) / 2`` computed in one process, bit for
    bit, on both ranks; calls and bytes as the buckets predict."""
    rng = np.random.default_rng(0)

    def draw():
        f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
        return {"a": f(7, 90), "b": f(3), "c": {"d": f(1000),
                                                "e": f()}}
    trees = [draw(), draw()]
    from repro_torch.launch.mesh import run_stage_ranks
    outs = run_stage_ranks(_reduce_rank, 2, "cpu", args=(trees, 1000),
                           timeout_s=120.0)
    want = [(torch.from_numpy(x) + torch.from_numpy(y)) / 2
            for x, y in zip(tree_leaves(trees[0]), tree_leaves(trees[1]))]
    n = sum(w.numel() for w in want)
    for tree, counters in outs:
        got = tree_leaves(tree)
        assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
        assert counters["n_reduce"] == -(-4 * n // 1000)
        assert counters["bytes_reduce"] == 4 * n
