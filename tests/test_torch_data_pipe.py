"""The data axis under the pipelines (the JAX package's GSPMD hybrid):
``launch/train.py --data 2`` with the streaming SpecTrain tick, held on
the CPU to the JAX package's step on the **whole** batch.

Two gloo replicas (spawned by the launcher, one process each, every
stage on each) take their block of every microbatch's rows, average
their gradients once a tick (or once a step for sync) and update; the
JAX side runs the same weights (the port's draw from ``--seed``, carried
over leaf by leaf) on the whole batch in fp32, which is what GSPMD
computes for a batch sharded over ``data``.

Claims (rtol 1e-4 / atol 1e-5 unless stated):
  * the tick, granite smoke at ``--pipe 2``: spectrain, vanilla (traced:
    replica 0's trace validates) and pipedream over 5 ticks (pipedream against the JAX tick with its
    stash fault repaired, as ``test_torch_train.py`` holds it), and
    spectrain at ``--ticks 2``: the replicas' mean loss tick by tick,
    every params / momentum (/ ``pred``) leaf at the end, the two
    replicas bit-equal (ZeRO-1's momentum pieces gathered whole), one
    gradient reduction a tick of the whole fp32 gradient (ZeRO-1's
    reduce-scatter, then the weights' all-gather);
  * MoE (deepseek smoke, 8 rows x 16 tokens, 4 experts: 16 dispatch
    groups a microbatch, 8 a replica): the tick, and ``--mode sync`` at
    2 microbatches against JAX ``pipeline_sync.make_train_step`` (the
    repair: each replica routes its half of the whole microbatch's 16
    groups and averages the expert fractions, one ``[E]`` reduction a
    MoE layer a forward; before it, a replica routed its rows as a
    microbatch of its own);
  * SSM: rwkv6 and the zamba2 hybrid (its tied ``shared`` block averaged
    as any leaf) on the tick; rwkv6 against JAX at its documented
    tolerance (``test_torch_ssm_train.py``: XLA's CPU ``tanh`` / ``exp``
    ulps) and against the one-process port run at rtol 1e-4 / atol 1e-5;
  * ``--data 2`` against the one-process port run on the same tokens;
    a ``bwd_dtype="bfloat16"`` tick's gradients widened to fp32 for the
    reduction;
  * checkpoints in the one-process layout: replica 0 writes the rings'
    rows gathered in rank order; restored under ``--data 1`` they equal
    the replicas' state bit for bit, and a ``--data 2`` resume continues
    bit-equal to the uninterrupted run;
  * the gates' three-part messages.

The round schedules and the trace: ``test_torch_data_rounds.py``.  JAX
is imported inside the functions that use it: the spawned replicas
import this module and need only torch.  Launcher runs go two at a
time on a thread pool, overlapping the JAX compiles.
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
RWKV_RTOL, RWKV_ATOL = 1e-3, 2e-3      # test_torch_ssm_train.py's
LR = 1e-2
# the stream state's rings, which hold each replica's own rows
RINGS = ("fwd_buf", "bwd_buf", "stash_x", "batch_ring")
BASE = ["--smoke", "--device", "cpu", "--pipe", "2", "--layers", "4",
        "--batch", "8", "--seq", "16", "--partitioner", "uniform",
        "--seed", "0", "--log-every", "1"]


# ----------------------------------------------------------------- probe
def _key_leaves(state):
    out = []
    tree_map(lambda p, a: out.append(("/".join(p), a)), state)
    return out


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 \
            else a.detach().numpy()
    return np.asarray(a)


class Probe:
    """``on_step`` of a run, in every replica (it pickles) or in this
    process: each step's loss (and aux), reduction counters, a digest of
    the bits of the leaves every replica holds alike (``digest``: all
    but the rings' rows) and one of every leaf (``whole``); every leaf at the steps in
    ``dump`` and at the last, to ``<out>/rank<r>.npz`` (keys
    ``<step>:<path>``) and ``.json``."""

    def __init__(self, out: str, steps: int, dump=()):
        self.out, self.steps, self.dump = out, steps, tuple(dump)
        self.rec = {"steps": [], "loss": [], "aux": [], "xfer": [],
                    "digest": [], "whole": []}
        self.arrs = {}

    def __call__(self, s, state, metrics):
        g = rsh.current_group()
        rank = 0 if g is None else g.rank
        rec = self.rec
        rec["steps"].append(s)
        rec["loss"].append(float(metrics["loss"]))
        if "aux" in metrics:
            rec["aux"].append(float(metrics["aux"]))
        if g is not None:
            rec["xfer"].append(g.counters())
            # ZeRO-1: the replica's momentum pieces, gathered whole
            state = ckpt.whole_state(state, g.data)
            g.reset_counters()
        h, w = hashlib.sha1(), hashlib.sha1()
        for k, a in _key_leaves(state):
            b = k.encode() + np.ascontiguousarray(_np(a)).tobytes()
            w.update(b)
            if k.split("/")[0] not in RINGS:
                h.update(b)
        rec["digest"].append(h.hexdigest())
        rec["whole"].append(w.hexdigest())
        if s in self.dump or s == self.steps - 1:
            for k, a in _key_leaves(state):
                self.arrs[f"{s}:{k}"] = np.array(_np(a))
        if s == self.steps - 1:
            np.savez(os.path.join(self.out, f"rank{rank}.npz"), **self.arrs)
            with open(os.path.join(self.out, f"rank{rank}.json"), "w") as f:
                json.dump(rec, f)


def launch(argv, out, steps, dump=()):
    """``train.main(argv)`` with a :class:`Probe`; returns the ranks'
    (record, arrays)."""
    os.makedirs(out, exist_ok=True)
    assert train.main(argv + ["--steps", str(steps)],
                      on_step=Probe(out, steps, dump)) == 0
    got = []
    for r in range(8):
        p = os.path.join(out, f"rank{r}.json")
        if not os.path.exists(p):
            break
        with open(p) as f:
            rec = json.load(f)
        got.append((rec, np.load(os.path.join(out, f"rank{r}.npz"))))
    return got


# (name, argv beyond BASE, steps, dumped steps)
RUNS = {
    "spectrain": (["--mode", "spectrain", "--data", "2", "--ckpt-dir",
                   "{out}/ck", "--save-every", "3"], 5, (2,)),
    "vanilla": (["--mode", "vanilla", "--data", "2", "--trace",
                 "{out}/trace.json"], 5, ()),
    "pipedream": (["--mode", "pipedream", "--data", "2"], 5, ()),
    "ticks2": (["--mode", "spectrain", "--ticks", "2", "--data", "2"], 3,
               ()),
    "moe-tick": (["--arch", "deepseek-moe-16b", "--mode", "spectrain",
                  "--data", "2"], 4, ()),
    "moe-sync": (["--arch", "deepseek-moe-16b", "--mode", "sync",
                  "--ticks", "2", "--data", "2"], 3, ()),
    "rwkv6": (["--arch", "rwkv6-7b", "--mode", "spectrain", "--data", "2"],
              4, ()),
    "rwkv6-one": (["--arch", "rwkv6-7b", "--mode", "spectrain"], 4, ()),
    "zamba2": (["--arch", "zamba2-1.2b", "--mode", "spectrain", "--data",
                "2"], 4, ()),
    "one": (["--mode", "spectrain"], 5, ()),
}


def _bwd_dtype_rank(group, steps):
    """One replica (``group`` None: the one process) of the spectrain
    tick with ``bwd_dtype="bfloat16"`` through ``make_state`` /
    ``make_train_step(data=)``, on BASE's model and batches, with the
    momentum replicated (``zero1=False``: the all-reduce path; ZeRO-1's
    widening is ``test_torch_zero1.py``'s): its params / momentum leaves
    and reduction counters."""
    from repro_torch.core import pipeline_stream as tps
    args = train.parse_args(BASE)
    cfg = train.build(args)
    model = Model(cfg, device="cpu")
    bs = _batches(args, cfg, steps)
    state = tps.make_state(model, model.init(torch.Generator().manual_seed(
        0)), bs[0], mode="spectrain", data=group, zero1=False)
    step = tps.make_train_step(model, mode="spectrain", lr=LR,
                               bwd_dtype="bfloat16", data=group)
    xfer = []
    for b in bs:
        state, _ = step(state, b)
        if group is not None:
            xfer.append(group.counters())
            group.reset_counters()
    return xfer, [_np(a) for key in ("params", "momentum")
                  for a in tree_leaves(state[key])]


def _bwd_dtype_runs(steps):
    from repro_torch.launch.mesh import run_stage_ranks
    return (run_stage_ranks(_bwd_dtype_rank, 2, "cpu", args=(steps,),
                            timeout_s=300.0),
            _bwd_dtype_rank(None, steps))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launcher run of the module, two at a time in the
    background from the module's start: ``runs(name)`` waits for one."""
    root = tmp_path_factory.mktemp("data_pipe")
    pool = cf.ThreadPoolExecutor(max_workers=2)
    futs = {}
    for name, (extra, steps, dump) in RUNS.items():
        out = str(root / name)
        argv = BASE + [a.format(out=out) for a in extra]
        futs[name] = pool.submit(launch, argv, out, steps, dump)
    futs["bwd_dtype"] = pool.submit(_bwd_dtype_runs, 3)

    def get(name):
        return futs[name].result()
    get.root = root
    yield get
    pool.shutdown(wait=True)


# ------------------------------------------------------------- reference
def _plain(extra):
    """A run's flags without its checkpoint and trace ones."""
    out, skip = [], False
    for a in extra:
        if skip:
            skip = False
        elif a in ("--ckpt-dir", "--save-every", "--trace"):
            skip = True
        else:
            out.append(a)
    return out


def _cfgs(argv):
    """(the launcher's port cfg, the JAX cfg equal to it)."""
    from repro.configs import get_config as jget
    from repro.configs import smoke_config as jsmoke
    args = train.parse_args(argv)
    tcfg = train.build(args)
    js = jsmoke(jget(args.arch))
    jcfg = js.replace(n_layers=args.layers, mesh_plan=dataclasses.replace(
        js.mesh_plan, pipe=args.pipe, tensor=1,
        num_microbatches=args.ticks), param_dtype="float32",
        compute_dtype="float32")
    for f in dataclasses.fields(jcfg):
        a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    return args, tcfg, jcfg


def _jax_params(tcfg, jm, seed=0):
    """The port's draw from ``--seed`` as a JAX tree (leaf by leaf)."""
    import jax
    import jax.numpy as jnp
    leaves = tree_leaves(Model(tcfg, device="cpu").init(
        torch.Generator().manual_seed(seed)))
    shape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in jax.tree.leaves(shape)] == \
        [tuple(x.shape) for x in leaves]
    return jax.tree.unflatten(jax.tree.structure(shape),
                              [jnp.asarray(x.numpy()) for x in leaves])


def _batches(args, tcfg, steps):
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(tcfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed, kind=args.data_kind))
    return [{k: np.asarray(v, np.int32) for k, v in
             data.batch_at(s).items()} for s in range(steps)]


def _repair_pipedream(js):
    from test_torch_train import _repair_pipedream as fix
    return fix(js)


def jax_stream(name):
    """JAX ``pipeline_stream.make_train_step`` on the whole batches of
    run ``name``: (losses a step, final state)."""
    import jax
    from repro.core import pipeline_stream as jps
    from repro.models import Model as JModel
    extra, steps, _ = RUNS[name]
    args, tcfg, jcfg = _cfgs(BASE + _plain(extra))
    jm = JModel(jcfg)
    bs = _batches(args, tcfg, steps)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       bs[0])
    kw = dict(mode=args.mode, ticks_per_step=max(args.ticks, 1))
    js = jps.make_state(jm, _jax_params(tcfg, jm), sds, **kw)
    jstep = jax.jit(jps.make_train_step(jm, lr=LR, **kw))
    losses = []
    for b in bs:
        if args.mode == "pipedream":
            js = _repair_pipedream(js)
        js, met = jstep(js, b)
        losses.append(float(met["loss"]))
    return losses, js, args


def jax_sync(name):
    """JAX ``pipeline_sync.make_train_step`` on the whole batches."""
    import jax
    import jax.numpy as jnp
    from repro.core import pipeline_sync as jsync
    from repro.models import Model as JModel
    extra, steps, _ = RUNS[name]
    args, tcfg, jcfg = _cfgs(BASE + extra)
    jm = JModel(jcfg)
    jp = _jax_params(tcfg, jm)
    js = {"params": jp, "momentum": jax.tree.map(jnp.zeros_like, jp),
          "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jsync.make_train_step(jm, lr=LR,
                                          num_microbatches=args.ticks))
    losses = []
    for b in _batches(args, tcfg, steps):
        js, met = jstep(js, b)
        losses.append(float(met["loss"]))
    return losses, js, args


# ---------------------------------------------------------------- checks
def _last(arrs, steps, prefix):
    s = f"{steps - 1}:{prefix}/"
    return [(k[len(s):], arrs[k]) for k in sorted(arrs.files)
            if k.startswith(s)]


def _leaves_at(arrs, step, prefix):
    """The dumped leaves under ``prefix`` at ``step``, in tree order."""
    keys = [k for k in arrs.files if k.startswith(f"{step}:{prefix}/")]
    order = {k: i for i, k in enumerate(arrs.files)}
    return [arrs[k] for k in sorted(keys, key=order.get)]


def _check_replicas(reps, steps, per_step=1):
    """Bit-equal replicas every step (the momentum gathered whole);
    ``per_step`` gradient reductions a step, each ZeRO-1's: one
    reduce-scatter of the whole fp32 gradient in one bucket (every leaf
    cut in two pieces, padded to even length) and the weights
    all-gathered after the update."""
    (r0, a0), (r1, a1) = reps
    assert r0["digest"] == r1["digest"]
    assert sorted(a0.files) == sorted(a1.files)
    padded = sum(2 * -(-a0[k].size // 2) for k in a0.files
                 if k.startswith(f"{steps - 1}:params/"))
    for rec, _ in reps:
        assert len(rec["xfer"]) == steps
        for x in rec["xfer"]:
            assert (x["n_reduce"], x["n_rs"], x["bytes_rs"]) == \
                (0, per_step, per_step * 4 * padded)
            assert x["n_ag"] >= per_step
            assert x["bytes_ag"] >= per_step * 4 * padded
            assert x["n_sent"] == 0


def _close_leaves(got, want, what, rtol=RTOL, atol=ATOL, scaled=False):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, i)
        a = max(atol, RWKV_ATOL * float(np.abs(w).max())) if scaled \
            else atol
        np.testing.assert_allclose(g, w, rtol=rtol, atol=a,
                                   err_msg=f"{what} leaf {i}")


def _mean_losses(reps):
    return [(a + b) / 2 for a, b in zip(reps[0][0]["loss"],
                                       reps[1][0]["loss"])]


def _check_against_jax(reps, losses, js, steps, *, rtol=RTOL, atol=ATOL,
                       scaled=False):
    import jax
    np.testing.assert_allclose(_mean_losses(reps), losses, rtol=rtol,
                               atol=atol)
    a0 = reps[0][1]
    for key in ("params", "momentum"):
        _close_leaves(_leaves_at(a0, steps - 1, key),
                      jax.tree.leaves(js[key]), key, rtol, atol, scaled)


@pytest.mark.parametrize("name", ["spectrain", "vanilla", "pipedream",
                                  "ticks2"])
def test_tick_replicas_match_jax_whole_batch(name, runs):
    """The tick over ``data``: replicas bit-equal, one reduction a tick,
    losses and every params / momentum leaf (spectrain: ``pred`` too,
    JAX's Eq. 4 of its final state) as JAX's on the whole batch; the
    vanilla run is traced, and replica 0's trace validates."""
    losses, js, args = jax_stream(name)
    steps = RUNS[name][1]
    reps = runs(name)
    _check_replicas(reps, steps, per_step=max(args.ticks, 1))
    for rec, _ in reps:
        assert rec["xfer"][0]["n_stat"] == 0      # no MoE layer
    _check_against_jax(reps, losses, js, steps)
    if args.mode == "spectrain":
        import jax
        from repro.core import spectrain as jst
        S = 2
        s_fwd = [2 * (S - 1 - k) for k in range(S)]
        want = [jst.predict_weights(w, v, LR, s) for w, v, s in zip(
            js["params"]["stages"], js["momentum"]["stages"], s_fwd)]
        _close_leaves(_leaves_at(reps[0][1], steps - 1, "pred/stages"),
                      jax.tree.leaves(want), "pred stages")
    if "--trace" in RUNS[name][0]:
        from repro_torch.obs import validate_trace
        with open(runs.root / name / "trace.json") as f:
            assert validate_trace(json.load(f)) == []


def test_moe_tick_routes_the_whole_microbatch(runs):
    """deepseek smoke on the tick: the replicas' mean loss and every leaf
    as JAX's on the whole batch, bit-equal replicas, and one ``[E]``
    fp32 expert-fraction mean a MoE forward (two forwards a stage a
    tick: the inject and the backward's recompute)."""
    losses, js, args = jax_stream("moe-tick")
    steps = RUNS["moe-tick"][1]
    reps = runs("moe-tick")
    _check_replicas(reps, steps)
    _check_against_jax(reps, losses, js, steps)
    for rec, _ in reps:
        for x in rec["xfer"]:
            assert x["n_stat"] == 2 * 4 and x["bytes_stat"] == 8 * 4 * 4


def test_moe_sync_routes_the_whole_microbatch(runs):
    """The repair, on ``--mode sync --data 2`` (2 microbatches of 4 rows
    x 16 tokens on 2 stages): against JAX ``pipeline_sync`` on the whole
    batch, losses and every leaf, and the aux the replicas report is
    JAX's whole-microbatch aux.  Before the repair each replica routed
    its rows in groups of its own (here one group of 32 tokens)."""
    losses, js, args = jax_sync("moe-sync")
    steps = RUNS["moe-sync"][1]
    reps = runs("moe-sync")
    _check_replicas(reps, steps)
    _check_against_jax(reps, losses, js, steps)
    for rec, _ in reps:
        assert all(x["n_stat"] > 0 for x in rec["xfer"])


@pytest.mark.parametrize("name", ["rwkv6", "zamba2"])
def test_ssm_ticks_match_jax(name, runs):
    """The SSM families on the tick: zamba2 (its shared block averaged
    as any leaf) at rtol 1e-4 / atol 1e-5; rwkv6 at its documented
    tolerance against JAX and at rtol 1e-4 / atol 1e-5 against the
    one-process port run on the same tokens."""
    losses, js, args = jax_stream(name)
    steps = RUNS[name][1]
    reps = runs(name)
    _check_replicas(reps, steps)
    if name == "rwkv6":
        _check_against_jax(reps, losses, js, steps, rtol=RWKV_RTOL,
                           scaled=True)
        (one, a1), = runs("rwkv6-one")
        np.testing.assert_allclose(_mean_losses(reps), one["loss"],
                                   rtol=RTOL, atol=ATOL)
        for key in ("params", "momentum", "pred"):
            _close_leaves(_leaves_at(reps[0][1], steps - 1, key),
                          _leaves_at(a1, steps - 1, key), key)
    else:
        _check_against_jax(reps, losses, js, steps)
        assert any("shared" in k for k in reps[0][1].files)


def test_bf16_backward_gradients_reduce_in_fp32(runs):
    """A ``bwd_dtype="bfloat16"`` tick hands the reduction bf16
    gradients: widened to fp32 first (4 B a parameter reduced, one
    reduction a tick), the replicas bit-equal, and within bf16's
    tolerance (2e-2 of each leaf's scale) of the one-process run."""
    reps, (_, one) = runs("bwd_dtype")
    (x0, l0), (x1, l1) = reps
    n = sum(a.size for a in l0[:len(l0) // 2])
    for x in x0 + x1:
        assert (x["n_reduce"], x["bytes_reduce"]) == (1, 4 * n)
    for a, b, c in zip(l0, l1, one):
        assert np.array_equal(a, b)
        assert np.abs(a - c).max() <= 2e-2 * max(np.abs(c).max(), 1e-6)


def test_data_two_matches_the_one_process_run(runs):
    """``--data 2`` against the one-process port run on the same tokens:
    losses and every params / momentum / pred leaf."""
    reps = runs("spectrain")
    (one, a1), = runs("one")
    np.testing.assert_allclose(_mean_losses(reps), one["loss"], rtol=RTOL,
                               atol=ATOL)
    for key in ("params", "momentum", "pred"):
        _close_leaves(_leaves_at(reps[0][1], 4, key),
                      _leaves_at(a1, 4, key), key)


def test_checkpoint_keeps_the_one_process_layout(runs, tmp_path):
    """Replica 0 writes the one-process layout (rings' rows gathered in
    rank order): the checkpoint of step 2 restored under ``--data 1``
    (``checkpoint.restore`` onto a one-process state) equals the replicas'
    state bit for bit, leaf by leaf; a ``--data 2`` resume from it runs
    steps 3 and 4 bit-equal to the uninterrupted run."""
    from repro_torch.core import pipeline_stream as tps
    reps = runs("spectrain")
    extra, steps, _ = RUNS["spectrain"]
    src = str(runs.root / "spectrain" / "ck")
    assert ckpt.all_steps(src) == [2, 4]
    # --data 1: restore onto the one-process state's structure
    args = train.parse_args(BASE + ["--mode", "spectrain"])
    cfg = train.build(args)
    model = Model(cfg, device="cpu")
    data_b = _batches(args, cfg, 1)[0]
    tmpl = tps.make_state(model, model.init(torch.Generator().manual_seed(
        0)), data_b, mode="spectrain")
    whole, step = ckpt.restore(src, tmpl, step=2)
    assert step == 2
    (r0, a0), (r1, a1) = reps
    for k, leaf in _key_leaves(whole):
        d = ckpt.RING_ROW_DIMS.get(k.split("/")[0])
        got = _np(leaf)
        if d is None:
            want = a0[f"2:{k}"]
        else:
            want = np.concatenate([a0[f"2:{k}"], a1[f"2:{k}"]], axis=d)
        assert got.shape == want.shape and np.array_equal(got, want), k
    # --data 2: resume from step 2
    ck = tmp_path / "ck"
    shutil.copytree(os.path.join(src, "step_00000002"),
                    ck / "step_00000002")
    res = launch(BASE + _plain(extra)
                 + ["--ckpt-dir", str(ck), "--resume", "auto"],
                 str(tmp_path / "res"), steps)
    assert len(res) == 2
    for (rec, _), (want, _) in zip(res, reps):
        assert rec["steps"] == [3, 4]
        assert rec["whole"] == want["whole"][3:]


def test_replica_rows_cut_every_microbatch():
    """``replica_rows``: the replica's block of every unit, units in
    order (never a block of the global batch); one unit is
    ``local_rows``' block; tensors as numpy arrays; a batch that does not
    split raises."""
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3),
             "targets": -np.arange(8 * 3).reshape(8, 3)}
    mesh = rsh.data_mesh(2)
    specs = {"targets": ("data",), "tokens": ("data",)}
    for r in range(2):
        got = rsh.replica_rows(batch, 2, r, 2)
        rows = [2 * r, 2 * r + 1, 4 + 2 * r, 5 + 2 * r]
        for k in batch:
            assert np.array_equal(got[k], batch[k][rows])
        one = rsh.replica_rows(batch, 1, r, 2)
        want = rsh.local_rows(batch, specs, mesh, r)
        assert all(np.array_equal(one[k], want[k]) for k in batch)
        t = rsh.replica_rows({k: torch.from_numpy(v) for k, v in
                              batch.items()}, 2, r, 2)
        assert all(np.array_equal(t[k].numpy(), got[k]) for k in batch)
    with pytest.raises(ValueError):
        rsh.replica_rows(batch, 3, 0, 2)
    with pytest.raises(ValueError):
        rsh.replica_rows(batch, 4, 0, 4)


@pytest.mark.parametrize("extra,match", [
    (["--mode", "spectrain", "--execution", "mpmd", "--schedule", "1f1b"],
     "--data 2 with --execution mpmd"),
    (["--mode", "spectrain", "--batch", "6", "--ticks", "2"],
     "--data 2 with --batch 6 and --ticks 2"),
    (["--mode", "spectrain", "--schedule", "1f1b", "--batch", "12"],
     "--data 2 with --schedule 1f1b and --batch 12"),
    (["--arch", "deepseek-moe-16b", "--mode", "spectrain", "--batch", "4",
      "--seq", "8"],
     "--data 2 with deepseek-moe-16b's routing of microbatches of 4 x 8 "
     "tokens"),
])
def test_gates_refuse_in_three_parts(extra, match):
    """``--execution mpmd`` with JAX's reason; a batch the replicas
    cannot split by microbatch (tick, round); MoE groups a replica
    cannot hold whole, with a batch that splits."""
    with pytest.raises(SystemExit) as e:
        train.main(["--smoke", "--device", "cpu", "--data", "2"] + extra)
    msg = str(e.value)
    assert msg.startswith(f"unsupported combination: {match} — ") and \
        "; supported alternative: " in msg, msg
    if "mpmd" in match:
        assert "pure pipeline parallelism" in msg and "not ported" not in msg
    if "routing" in match:
        assert "microbatches of a multiple of 8 rows at --seq 8" in msg
