"""The tensor axis (``--tensor T``: Megatron-style heads, KV heads, MLP
and vocabulary sharding, the port's form of the JAX package's rules
over ``tensor``) held on the CPU to the JAX package's unsharded steps.

Two gloo tensor ranks each hold their blocks of the leaves
``spec_for_leaf(logical_rules)`` shards at tensor 2; GSPMD computes the
unsharded step for that layout, so the reference is JAX's one-device
step on the same weights (the port's draw from ``--seed``, carried over
leaf by leaf) in fp32.

Claims (rtol 1e-4 / atol 1e-5):
  * granite-8b, granite-20b (one KV head: ``wk`` / ``wv`` replicated,
    their gradient summed over the ranks) and starcoder2-15b smokes at
    ``--tensor 2``: the streaming SpecTrain tick against JAX
    ``pipeline_stream.make_train_step``, ``--mode sync`` against
    ``pipeline_sync.make_train_step`` and the 1f1b round against
    ``make_ir_train_step(backend="unrolled")``: the losses step by step
    and every leaf gathered over the ranks at the end; the tensor
    all-reduces a tick counted exactly;
  * the vocab-parallel embedding equals the one-process port's bit for
    bit;
  * each rank's leaf shapes are JAX's ``spec_for_leaf(logical_rules)``
    blocks at tensor 2, at smoke and at full size;
  * ``--data 2 --tensor 2`` (4 ranks) through the launcher against the
    one-process run; its checkpoint restores under ``--data 1 --tensor
    1`` equal to the gathered state, and a resume continues bit-equal;
  * the refusals' three-part messages (the encoder-decoder and the
    vision frontend; the MoE, SSM and MLA decoders split since, held in
    ``test_torch_tensor_{moe,ssm,mla}.py`` through this file's
    harness).

JAX is imported inside the functions: the spawned ranks import this
module and need only torch.
"""
import concurrent.futures as cf
import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import sharding as rsh
from test_torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
LR = 1e-2
STEPS = 3
ARCHS = ("granite-8b", "granite-20b", "starcoder2-15b")
BASE = ["--smoke", "--device", "cpu", "--pipe", "2", "--layers", "4",
        "--batch", "8", "--seq", "16", "--partitioner", "uniform",
        "--seed", "0", "--log-every", "1"]
SCHEDULES = {"tick": ["--mode", "spectrain"],
             "sync": ["--mode", "sync", "--ticks", "2"],
             "1f1b": ["--schedule", "1f1b"]}
RINGS = ("fwd_buf", "bwd_buf", "stash_x", "batch_ring")


def _argv(arch, sched):
    return BASE + ["--arch", arch] + SCHEDULES[sched]


def _leaf_dict(tree):
    out = {}
    tree_map(lambda p, a: out.__setitem__("/".join(p), a.detach().numpy()
                                          .copy())
             if p[0] not in RINGS and isinstance(a, torch.Tensor) else None,
             tree)
    return out


# ------------------------------------------------------ the tensor ranks
def _tp_case(group, argv):
    """One tensor rank's run of ``argv`` (its blocks drawn from the
    seed): (losses, every non-ring leaf gathered over the ranks, the
    rank's param shapes, the tensor group's all-reduces and their bytes
    a step)."""
    from repro_torch.api import Runtime, runtime_config_from_args
    from repro_torch.core import pipeline_sync
    from repro_torch.data import DataConfig, SyntheticLM
    args = train.parse_args(argv)
    cfg = train.build(args)
    model = Model(cfg, device="cpu")
    tg = group.tensor
    blk = (tg.rank, tg.world)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed, kind=args.data_kind))
    gen = torch.Generator().manual_seed(args.seed)
    if args.mode == "sync":
        state = pipeline_sync.init_state(model, gen, tensor=blk)
        fn = pipeline_sync.make_train_step(
            model, lr=args.lr, gamma=args.gamma,
            num_microbatches=cfg.mesh_plan.num_microbatches, tensor=tg)
    else:
        pplan, _ = train.run_plan(args, cfg, model.device)
        rt = Runtime(pplan, model, runtime_config_from_args(
            args, ticks_per_step=1), tensor=tg)
        state = rt.init_state(model.init(gen, tensor=blk), data.batch_at(0))
        fn = rt.train_step
    losses, n_tp, b_tp = [], [], []
    for s in range(STEPS):
        tg.reset_counters()
        state, met = fn(state, data.batch_at(s))
        losses.append(float(met["loss"]))
        n_tp.append(tg.counters()["n_tp"])
        b_tp.append(tg.counters()["bytes_tp"])
    shapes = [tuple(a.shape) for a in tree_leaves(state["params"])]
    dims = rsh.tensor_leaf_dims(cfg, model, tg.world)
    whole = ckpt.whole_state(state, group.data, tensor=tg, tensor_dims=dims)
    return losses, _leaf_dict(whole), shapes, n_tp, b_tp


def _embed_bits(group, argv):
    """Whether the vocab-parallel embedding equals the one-process one
    bit for bit."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import tensor_axis as tp
    args = train.parse_args(argv)
    cfg = train.build(args)
    model = Model(cfg, device="cpu")
    whole = model.init(torch.Generator().manual_seed(0))
    mine = model.init(torch.Generator().manual_seed(0),
                      tensor=(group.tensor.rank, group.tensor.world))
    b = {k: torch.as_tensor(v) for k, v in SyntheticLM(DataConfig(
        cfg.vocab_size, args.seq, args.batch, seed=0)).batch_at(0).items()}
    with tp.tensor_axis(group.tensor):
        got = model.embed(mine["outer"], b)
    return torch.equal(got, model.embed(whole["outer"], b))


def tp_cases(group, archs):
    """Every (arch, schedule) of ``archs`` on the two tensor ranks of
    ``group`` (:func:`_tp_case`)."""
    rsh.init_grid(group, 1, 2)
    return {(a, s): _tp_case(group, _argv(a, s)) for a in archs
            for s in SCHEDULES}


def _all_tp(group):
    out = tp_cases(group, ARCHS)
    out["embed"] = all(_embed_bits(group, _argv(a, "tick")) for a in ARCHS)
    return out


def rank_runs(fn):
    """A module fixture's body: ``fn`` on two gloo ranks, spawned at once
    on a thread (the JAX compiles overlap them); yields the result's
    getter (each rank's return value)."""
    from repro_torch.launch.mesh import run_stage_ranks
    pool = cf.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(run_stage_ranks, fn, 2, "cpu", timeout_s=600.0)
    yield fut.result
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def tp_runs():
    yield from rank_runs(_all_tp)


# ------------------------------------------------------------ the JAX side
def _cfgs(argv):
    """(args, the port cfg, the JAX cfg equal to it but for the mesh's
    tensor axis, which GSPMD leaves out of the numbers)."""
    from repro.configs import get_config as jget
    from repro.configs import smoke_config as jsmoke
    args = train.parse_args(argv)
    tcfg = train.build(args)
    js = jsmoke(jget(args.arch))
    jcfg = js.replace(n_layers=args.layers, mesh_plan=dataclasses.replace(
        js.mesh_plan, pipe=args.pipe, tensor=args.tensor,
        num_microbatches=args.ticks), param_dtype="float32",
        compute_dtype="float32")
    for f in dataclasses.fields(jcfg):
        a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    return args, tcfg, jcfg


def _jax_params(tcfg, jm):
    import jax
    import jax.numpy as jnp
    leaves = tree_leaves(Model(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    shape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jax.tree.unflatten(jax.tree.structure(shape),
                              [jnp.asarray(x.numpy()) for x in leaves])


def _batches(args, tcfg):
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(tcfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed, kind=args.data_kind))
    return [{k: np.asarray(v, np.int32) for k, v in
             data.batch_at(s).items()} for s in range(STEPS)]


def jax_run(arch, sched):
    """JAX's unsharded step on the whole batches: (losses, state)."""
    import jax
    import jax.numpy as jnp
    from repro.core import pipeline_stream as jps
    from repro.core import pipeline_sync as jsync
    from repro.models import Model as JModel
    from repro.planner import plan as jplan
    args, tcfg, jcfg = _cfgs(_argv(arch, sched) + ["--tensor", "2"])
    jm = JModel(jcfg)
    jp = _jax_params(tcfg, jm)
    bs = _batches(args, tcfg)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       bs[0])
    if sched == "sync":
        js = {"params": jp, "momentum": jax.tree.map(jnp.zeros_like, jp),
              "step": jnp.zeros((), jnp.int32)}
        step = jsync.make_train_step(jm, lr=LR, num_microbatches=args.ticks)
    elif sched == "tick":
        js = jps.make_state(jm, jp, sds, mode=args.mode)
        step = jps.make_train_step(jm, lr=LR, mode=args.mode)
    else:
        M = train.round_size(args.schedule, args.batch, args.pipe, 1,
                             args.ticks)
        pl = jplan(jcfg, n_stages=args.pipe, schedule=args.schedule,
                   n_microbatches=M, partitioner="uniform")
        js = jps.make_ir_state(jm, jp, sds, plan=pl, mode=args.mode)
        step = jps.make_ir_train_step(jm, plan=pl, mode=args.mode, lr=LR,
                                      backend="unrolled")
    step = jax.jit(step)
    losses = []
    for b in bs:
        js, met = step(js, b)
        losses.append(float(met["loss"]))
    return losses, js


def _tp_ar_per_tick(cfg, L: int, S: int) -> int:
    """The tensor all-reduces of one spectrain tick: the inject's
    embedding and each layer's two row-parallel outputs, forward and in
    the backward's recompute; each layer's two column-parallel inputs'
    cotangents (and a replicated ``wk`` / ``wv``'s gradients) backward;
    the head's max, sum of exponentials and gold logit, and its
    column-parallel input's cotangent; the embedding backward's
    lookup."""
    kv_rep = cfg.n_kv_heads % 2 != 0
    return 1 + 2 * L + 2 * L + (2 + 2 * kv_rep) * L + 3 + 1 + 1


def check_against_jax(arch, sched, runs, n_tp=None, b_tp=None,
                      leaf_tol=None):
    """The ranks' losses (each rank's alike) step by step and every leaf
    gathered at the end against JAX's unsharded step; the two ranks'
    gathered leaves bit-equal; on the tick, ``n_tp`` tensor all-reduces
    a tick (of ``b_tp`` bytes, where given).  ``leaf_tol(want)``: a
    leaf's (rtol, atol) where the family's arithmetic is held to another
    envelope than rtol 1e-4 / atol 1e-5 (rwkv6's)."""
    import jax
    losses, js = jax_run(arch, sched)
    r0, r1 = (runs[r][(arch, sched)] for r in range(2))
    assert r0[0] == r1[0]
    np.testing.assert_allclose(r0[0], losses, rtol=RTOL, atol=ATOL)
    for k in r0[1]:
        assert np.array_equal(r0[1][k], r1[1][k]), k
    keys = ("params", "momentum") + (("pred",) if sched == "tick" else ())
    for key in keys:
        got = [a for k, a in r0[1].items() if k.split("/")[0] == key]
        want = js.get(key)
        if key == "pred":   # JAX's Eq. 4 of its final state
            from repro.core import spectrain as jst
            want = {"stages": [jst.predict_weights(w, v, LR, s) for w, v, s
                               in zip(js["params"]["stages"],
                                      js["momentum"]["stages"], (2, 0))]}
            got = [a for k, a in r0[1].items()
                   if k.startswith("pred/stages/")]
        want = jax.tree.leaves(want)
        assert len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w, np.float32)
            rtol, atol = (RTOL, ATOL) if leaf_tol is None else leaf_tol(w)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{arch} {sched} {key} {i}")
    if sched == "tick":
        assert r0[3] == r1[3] == [n_tp] * STEPS
        if b_tp is not None:
            assert r0[4] == r1[4] == [b_tp] * STEPS


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_two_matches_jax_unsharded(arch, sched, tp_runs):
    """The ranks' losses (each rank's alike) step by step and every leaf
    gathered at the end against JAX's unsharded step; the two ranks'
    gathered leaves bit-equal; the tick's tensor all-reduces exact."""
    args = train.parse_args(_argv(arch, sched))
    cfg = train.build(args)
    check_against_jax(arch, sched, tp_runs(),
                      _tp_ar_per_tick(cfg, args.layers, args.pipe))


def test_vocab_parallel_embedding_is_bit_equal(tp_runs):
    assert tp_runs()[0]["embed"] and tp_runs()[1]["embed"]


def check_leaf_split(arch, shapes, T: int = 2):
    """A rank's smoke leaf shapes ``shapes``, and the full-size leaves cut
    by ``tensor_leaf_dims``, are JAX's ``spec_for_leaf(logical_rules)``
    blocks on a (data 1, pipe 1, tensor T) mesh."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import Model as JModel
    from repro.runtime import sharding as jsh
    from test_torch_dp import _FakeMesh, _jax_mesh
    names, shape = ("data", "pipe", "tensor"), (1, 1, T)

    def blocks(jcfg):
        jm = JModel(jcfg)
        specs = jax.tree.leaves(jsh.shardings_for(
            jm.param_axes(), jm.param_sds(), _jax_mesh(names, shape),
            jsh.logical_rules(jcfg, _FakeMesh(names, shape))))
        return [tuple(n // (T if "tensor" in ((e,) if isinstance(e, str)
                                              else (e or ())) else 1)
                      for n, e in zip(sds.shape, tuple(sp.spec)
                                      + (None,) * len(sds.shape)))
                for sds, sp in zip(jax.tree.leaves(jm.param_sds()), specs)]
    if shapes is not None:
        _, _, jcfg = _cfgs(_argv(arch, "sync") + ["--tensor", str(T)])
        assert shapes == blocks(jcfg)
    # full size: the port's cut of every leaf by name
    from repro_torch.configs import get_config
    tcfg = get_config(arch)
    tm = Model(tcfg, device="cpu")
    dims = rsh.tensor_leaf_dims(tcfg, tm, T)
    cut = []
    tree_map(lambda p, sp: cut.append(tuple(
        n // T if (p[-1] in dims and i == len(sp.shape) + dims[p[-1]])
        else n for i, n in enumerate(sp.shape))), tm.param_specs())
    assert cut == blocks(jget(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_split_is_jax_spec_for_leaf(arch, tp_runs):
    """Each rank's smoke leaf shapes, and the full-size leaves cut by
    ``tensor_leaf_dims``, are JAX's ``spec_for_leaf(logical_rules)``
    blocks on a (data 1, pipe 1, tensor 2) mesh."""
    check_leaf_split(arch, tp_runs()[0][(arch, "sync")][2])


# ------------------------------------------ the grid through the launcher
class GridProbe:
    """``on_step`` of a launcher run, in every rank: losses, the whole
    state (momentum gathered over the replicas, blocks over the tensor
    ranks) digested every step and dumped at the steps in ``dump``."""

    def __init__(self, out, argv, steps, dump=()):
        self.out, self.argv, self.steps = out, list(argv), steps
        self.dump = tuple(dump)
        self.rec = {"steps": [], "loss": [], "whole": []}
        self.arrs = {}

    def __call__(self, s, state, metrics):
        g = rsh.current_group()
        self.rec["steps"].append(s)
        self.rec["loss"].append(float(metrics["loss"]))
        if g is not None:
            cfg = train.build(train.parse_args(self.argv))
            dims = (rsh.tensor_leaf_dims(cfg, Model(cfg, device="cpu"),
                                         g.tensor.world)
                    if g.tensor is not None else None)
            state = ckpt.whole_state(state, g.data, tensor=g.tensor,
                                     tensor_dims=dims)
        h = hashlib.sha1()
        flat = []
        tree_map(lambda p, a: flat.append(("/".join(p), a)), state)
        for k, a in flat:
            a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
            h.update(k.encode() + a.detach().numpy().tobytes())
            if s in self.dump or s == self.steps - 1:
                self.arrs[f"{s}:{k}"] = a.detach().numpy().copy()
        self.rec["whole"].append(h.hexdigest())
        if s == self.steps - 1:
            r = 0 if g is None else g.rank
            np.savez(os.path.join(self.out, f"rank{r}.npz"), **self.arrs)
            with open(os.path.join(self.out, f"rank{r}.json"), "w") as f:
                json.dump(self.rec, f)


def _launch(argv, out, steps, dump=()):
    os.makedirs(out, exist_ok=True)
    assert train.main(argv + ["--steps", str(steps)],
                      on_step=GridProbe(out, argv, steps, dump)) == 0
    got = []
    for r in range(8):
        p = os.path.join(out, f"rank{r}.json")
        if os.path.exists(p):
            with open(p) as f:
                got.append((json.load(f), np.load(os.path.join(
                    out, f"rank{r}.npz"))))
    return got


GRID = ["--mode", "spectrain", "--data", "2", "--tensor", "2"]


def check_grid(tmp_path, base, *, resume: bool = True):
    """``base + --data 2 --tensor 2``: the replicas' mean loss and every
    leaf at the end within rtol 1e-4 / atol 1e-5 of the one-process run;
    the four ranks' whole states bit-equal (rings aside); its step-1
    checkpoint restored onto the one-process state equals the gathered
    state (rings: the replicas' rows in order); with ``resume``, a
    ``--data 2 --tensor 2`` resume from it runs steps 2-3 bit-equal to
    the uninterrupted run."""
    from repro_torch.core import pipeline_stream as tps
    steps = 4
    ck = str(tmp_path / "ck")
    grid = _launch(base + GRID + ["--ckpt-dir", ck, "--save-every", "2"],
                   str(tmp_path / "grid"), steps, dump=(1,))
    (one, a1), = _launch(base + ["--mode", "spectrain"],
                         str(tmp_path / "one"), steps)
    assert len(grid) == 4
    mean = [(a + b) / 2 for a, b in zip(grid[0][0]["loss"],
                                       grid[2][0]["loss"])]
    np.testing.assert_allclose(mean, one["loss"], rtol=RTOL, atol=ATOL)
    a0 = grid[0][1]
    last = f"{steps - 1}:"
    for k in a1.files:
        if k.startswith(last) and k[len(last):].split("/")[0] not in RINGS:
            np.testing.assert_allclose(a0[k], a1[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    for _, arrs in grid[1:]:
        for k in a0.files:
            if k.split(":")[1].split("/")[0] not in RINGS:
                assert np.array_equal(arrs[k], a0[k]), k
    # --data 1 --tensor 1: restore onto the one-process state
    assert ckpt.all_steps(ck) == [1, 3]
    args = train.parse_args(base + ["--mode", "spectrain"])
    cfg = train.build(args)
    model = Model(cfg, device="cpu")
    tmpl = tps.make_state(model, model.init(torch.Generator().manual_seed(
        0)), _batches(args, cfg)[0], mode="spectrain")
    whole, step = ckpt.restore(ck, tmpl, step=1)
    for k, leaf in _leaf_dict(whole).items():
        assert np.array_equal(leaf, a0[f"1:{k}"]), k
    r2 = grid[2][1]          # replica 1's rows
    for name, d in ckpt.RING_ROW_DIMS.items():
        got = []
        tree_map(lambda p, a: got.append(("/".join(p), a)), whole[name],
                 path=(name,))
        for k, a in got:
            want = np.concatenate([a0[f"1:{k}"], r2[f"1:{k}"]], axis=d)
            assert np.array_equal(a.numpy(), want), k
    if not resume:
        return
    # resume under the grid from step 1
    res_ck = tmp_path / "res_ck"
    shutil.copytree(os.path.join(ck, "step_00000001"),
                    res_ck / "step_00000001")
    res = _launch(base + GRID + ["--ckpt-dir", str(res_ck), "--resume",
                                 "auto"], str(tmp_path / "res"), steps)
    assert len(res) == 4
    for (rec, _), (want, _) in zip(res, grid):
        assert rec["steps"] == [2, 3]
        assert rec["whole"] == want["whole"][2:]


def test_grid_matches_one_process_and_checkpoints_move(tmp_path):
    """``--data 2 --tensor 2`` against one process, its checkpoint across
    (D, T) and a bit-equal resume (:func:`check_grid`)."""
    check_grid(tmp_path, BASE)


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch,what", [
    ("whisper-base", "an encoder-decoder"),
    ("pixtral-12b", "the vision frontend"),
])
def test_tensor_refusals_in_three_parts(arch, what):
    with pytest.raises(SystemExit) as e:
        train.main(["--smoke", "--device", "cpu", "--arch", arch,
                    "--tensor", "2", "--pipe", "2", "--layers", "2"])
    msg = str(e.value)
    assert msg.startswith(f"unsupported combination: --tensor 2 with ") \
        and what in msg and "; supported alternative: " in msg, msg


def test_tensor_refused_under_mpmd_and_in_serving():
    with pytest.raises(SystemExit) as e:
        train.main(["--smoke", "--device", "cpu", "--tensor", "2",
                    "--execution", "mpmd", "--schedule", "1f1b"])
    msg = str(e.value)
    assert msg.startswith("unsupported combination: --tensor 2 with "
                          "--execution mpmd — ") and \
        "pure pipeline parallelism" in msg
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--smoke", "--device", "cpu", "--tensor", "2"])
    msg = str(e.value)
    assert msg.startswith("unsupported combination: --tensor 2 with "
                          "serving — ") and "; supported alternative: " \
        in msg, msg
