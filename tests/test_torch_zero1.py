"""ZeRO-1 momentum over the data replicas (the JAX package's default
``momentum_rules`` layout), held on the CPU to the replicated run.

Each of two gloo replicas holds its piece of every momentum leaf (the
leaf's flat elements cut in two, ``runtime.sharding.shard_range``),
reduce-scatters the fp32 gradient, runs the fused update on its pieces
of w, v and ŵ and all-gathers w and ŵ.  The sum of two replicas' values
is one commutative addition either way, so the bar is bit-equality with
the replicated run (``zero1=False``: ``all_reduce_mean`` and the whole
update).

Claims:
  * bit-equal to ``zero1=False``, every loss and every params /
    momentum (gathered) / ``pred`` / stash leaf, both replicas alike:
    the tick (spectrain, pipedream, a ``bwd_dtype="bfloat16"`` tick whose
    gradients are widened to fp32), the 1f1b and 2bw rounds (2bw's
    spectrain reads predict the pieces, then gather), ``--mode sync``,
    an MoE tick (deepseek) and an rwkv6 tick;
  * ``--clip``: within rtol 1e-5 / atol 1e-6 (the norm sums the
    pieces' squares in another order);
  * a replica's momentum bytes are ``zero1_layout``'s ``zero1_bytes``;
    one reduce-scatter a reduction, no all-reduce;
  * ``reduce_scatter_mean`` / ``all_gather`` over 1,000-byte buckets:
    each piece the slice of ``(a + b) / 2`` bit for bit, the gather
    whole, calls and bytes as ``shard_buckets`` predicts;
  * the fused update on pieces at odd offsets spanning leaves equals the
    whole update's slices.

All cases run in one pair of spawned replicas (the module fixture).
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.runtime import sharding as rsh
from test_torch_threads import one_thread  # noqa: F401

BASE = ["--smoke", "--device", "cpu", "--pipe", "2", "--layers", "4",
        "--batch", "8", "--seq", "16", "--partitioner", "uniform",
        "--seed", "0", "--log-every", "1"]
STEPS = 3
# name -> (flags beyond BASE, bwd_dtype)
CASES = {
    "spectrain": (["--mode", "spectrain"], None),
    "pipedream": (["--mode", "pipedream"], None),
    "bf16-bwd": (["--mode", "spectrain"], "bfloat16"),
    "1f1b": (["--schedule", "1f1b"], None),
    "2bw": (["--schedule", "2bw"], None),
    "sync": (["--mode", "sync", "--ticks", "2"], None),
    "moe": (["--arch", "deepseek-moe-16b", "--mode", "spectrain"], None),
    "rwkv6": (["--arch", "rwkv6-7b", "--mode", "spectrain"], None),
    "clip": (["--mode", "spectrain", "--clip", "0.05"], None),
}
RINGS = ("fwd_buf", "bwd_buf", "stash_x", "batch_ring")


def _case(group, argv, zero1: bool, bwd_dtype):
    """One replica's run of ``argv`` for STEPS steps: (losses, the
    non-ring leaves with the momentum gathered whole, the momentum bytes
    it held, the data group's counters)."""
    from repro_torch.api import Runtime, runtime_config_from_args
    from repro_torch.core import pipeline_stream as tps
    from repro_torch.core import pipeline_sync
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.runtime import checkpoint as ckpt
    args = train.parse_args(argv)
    cfg = train.build(args)
    model = Model(cfg, device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed, kind=args.data_kind))
    gen = torch.Generator().manual_seed(args.seed)
    if args.mode == "sync":
        state = pipeline_sync.init_state(model, gen, data=group,
                                         zero1=zero1)
        step = pipeline_sync.make_train_step(
            model, lr=args.lr, gamma=args.gamma,
            num_microbatches=cfg.mesh_plan.num_microbatches, group=group)
        units = train._forward_units(args, model.n_stages)

        def fn(st, b):
            return step(st, rsh.replica_rows(b, units, group.rank,
                                             group.world))
    elif bwd_dtype is not None:
        state = tps.make_state(model, model.init(gen), data.batch_at(0),
                               mode=args.mode, data=group, zero1=zero1)
        fn = tps.make_train_step(model, mode=args.mode, lr=args.lr,
                                 bwd_dtype=bwd_dtype, data=group)
    else:
        pplan, _ = train.run_plan(args, cfg, model.device)
        rc = runtime_config_from_args(args, ticks_per_step=1)
        rt = Runtime(pplan, model, rc, data=group, zero1=zero1)
        state = rt.init_state(model.init(gen), data.batch_at(0))
        fn = rt.train_step
    group.reset_counters()
    losses = []
    for s in range(STEPS):
        state, met = fn(state, data.batch_at(s))
        losses.append(float(met["loss"]))
    counters = group.counters()
    held = sum(v.numel() * 4 for v in tree_leaves(state["momentum"]))
    whole = ckpt.whole_state(state, group)
    leaves = {}
    tree_map(lambda p, a: leaves.__setitem__("/".join(p), a.numpy().copy())
             if p[0] not in RINGS and isinstance(a, torch.Tensor) else None,
             whole)
    return losses, leaves, held, counters


def _all_cases(group):
    out = {}
    for name, (extra, bdt) in CASES.items():
        for zero1 in (True, False):
            out[(name, zero1)] = _case(group, BASE + extra, zero1, bdt)
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import run_stage_ranks
    return run_stage_ranks(_all_cases, 2, "cpu", timeout_s=600.0)


@pytest.mark.parametrize("name", [n for n in CASES if n != "clip"])
def test_zero1_is_bit_equal_to_the_replicated_run(name, runs):
    """Every loss and leaf bit-equal to ``zero1=False`` on both replicas;
    the replicas alike; one reduce-scatter a reduction (none replicated)
    and no all-reduce."""
    for r in range(2):
        lz, az, _, cz = runs[r][(name, True)]
        lr_, ar, _, cr = runs[r][(name, False)]
        assert lz == lr_
        assert sorted(az) == sorted(ar)
        for k in az:
            assert np.array_equal(az[k], ar[k]), (name, r, k)
        assert cz["n_reduce"] == 0 and cz["n_rs"] > 0 and cz["n_ag"] > 0
        assert cr["n_rs"] == cr["n_ag"] == 0 and cr["n_reduce"] > 0
        assert cz["bytes_rs"] >= cr["bytes_reduce"]
    for k, a in runs[0][(name, True)][1].items():
        assert np.array_equal(a, runs[1][(name, True)][1][k]), (name, k)


def test_clip_norm_within_tolerance(runs):
    """``--clip``: the ZeRO-1 norm sums the pieces' squares over the
    replicas (one scalar all-reduce a tick) in another order than the
    replicated norm: every leaf within rtol 1e-5 / atol 1e-6, and the
    clip binds (the run differs from the unclipped one)."""
    lz, az, _, cz = runs[0][("clip", True)]
    lr_, ar, _, _ = runs[0][("clip", False)]
    np.testing.assert_allclose(lz, lr_, rtol=1e-5, atol=1e-6)
    for k in az:
        np.testing.assert_allclose(az[k], ar[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert cz["n_stat"] == STEPS
    free = runs[0][("spectrain", True)][1]
    assert any(not np.allclose(az[k], free[k]) for k in az)


def test_momentum_bytes_are_the_rules_layout(runs):
    """A replica holds exactly ``zero1_layout``'s ``zero1_bytes`` of
    momentum (every smoke leaf shards over ``data``), half the
    replicated bytes."""
    from repro_torch.models import Model
    args = train.parse_args(BASE + ["--mode", "spectrain"])
    cfg = train.build(args)
    model = Model(cfg, device="cpu")
    z = rsh.zero1_layout(cfg, model.param_axes(), model.param_specs(),
                         rsh.data_mesh(2))
    assert z["sharded"] == z["leaves"]
    for r in range(2):
        assert runs[r][("spectrain", True)][2] == z["zero1_bytes"]
        assert runs[r][("spectrain", False)][2] == z["replicated_bytes"]


def test_shard_ranges_and_buckets():
    """Pieces tile a leaf and differ by at most one element; buckets
    hold ``ceil(n / N)`` columns a leaf, at most ``cap / N`` a bucket,
    in leaf order."""
    for n in (0, 1, 7, 64, 1001):
        for N in (1, 2, 3, 4):
            cuts = [rsh.shard_range(n, r, N) for r in range(N)]
            assert cuts[0][0] == 0 and cuts[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
            lens = [hi - lo for lo, hi in cuts]
            assert max(lens) - min(lens) <= 1
    bks = rsh.shard_buckets([7, 90, 3], 2, 40)
    assert [w for w, _ in bks] == [20, 20, 11]
    cols = {}
    for _, segs in bks:
        for i, j0, take, col in segs:
            cols.setdefault(i, []).append((j0, take))
    assert cols == {0: [(0, 4)], 1: [(0, 16), (16, 20), (36, 9)],
                    2: [(0, 2)]}


def _collective_rank(group, trees):
    mine = [torch.from_numpy(a.copy()) for a in trees[group.rank]]
    pieces = group.reduce_scatter_mean(mine, bucket_bytes=1000)
    whole = [torch.zeros_like(t) for t in mine]
    for w, p in zip(whole, pieces):
        lo, hi = rsh.shard_range(w.numel(), group.rank, group.world)
        w.view(-1)[lo:hi].copy_(p)
    group.all_gather(whole, bucket_bytes=1000)
    return ([p.numpy() for p in pieces], [w.numpy() for w in whole],
            group.counters())


def test_reduce_scatter_and_all_gather_over_small_buckets():
    """Each rank's pieces are the slices of ``(a + b) / 2`` bit for bit;
    the all-gather rebuilds the whole mean on both; one call a bucket,
    bytes the padded rows."""
    from repro_torch.launch.mesh import run_stage_ranks
    rng = np.random.default_rng(0)

    def draw():
        return [rng.standard_normal(s).astype(np.float32)
                for s in ((7, 90), (3,), (1001,), ())]
    trees = [draw(), draw()]
    outs = run_stage_ranks(_collective_rank, 2, "cpu", args=(trees,),
                           timeout_s=120.0)
    want = [((torch.from_numpy(a) + torch.from_numpy(b)) / 2).numpy()
            for a, b in zip(*trees)]
    sizes = [w.size for w in want]
    for r, (pieces, whole, c) in enumerate(outs):
        for p, w in zip(pieces, want):
            lo, hi = rsh.shard_range(w.size, r, 2)
            assert np.array_equal(p, w.reshape(-1)[lo:hi])
        assert all(np.array_equal(a, b) for a, b in zip(whole, want))
        bks = rsh.shard_buckets(sizes, 2, 250)
        assert c["n_rs"] == c["n_ag"] == len(bks)
        assert c["bytes_rs"] == c["bytes_ag"] == \
            4 * 2 * sum(w for w, _ in bks)


def test_fused_update_on_pieces_spanning_leaves():
    """The fused update on views at odd offsets (a piece that ends one
    leaf and starts the next) writes exactly the whole update's
    elements there."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(3)
    shapes = [(5, 7), (13,), (3, 3, 3)]
    mk = lambda: [torch.randn(s, generator=g) for s in shapes]
    w, v, gr = mk(), mk(), mk()
    wh = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    ref_w, ref_v = [x.clone() for x in w], [x.clone() for x in v]
    ref_wh = [x.clone() for x in wh]
    ops.fused_update(ref_w, ref_v, gr, lr=0.1, gamma=0.9, s=2.0,
                     whats=ref_wh)
    # the flat range [17, 60) of the three leaves' concatenation
    views, offs = [], 0
    for i, s in enumerate(shapes):
        n = int(np.prod(s))
        lo, hi = max(17, offs) - offs, min(60, offs + n) - offs
        if lo < hi:
            views.append((i, lo, hi))
        offs += n
    ops.fused_update([w[i].view(-1)[lo:hi] for i, lo, hi in views],
                     [v[i].view(-1)[lo:hi] for i, lo, hi in views],
                     [gr[i].view(-1)[lo:hi] for i, lo, hi in views],
                     lr=0.1, gamma=0.9, s=2.0,
                     whats=[wh[i].view(-1)[lo:hi] for i, lo, hi in views])
    for i, lo, hi in views:
        for got, want in ((w, ref_w), (v, ref_v), (wh, ref_wh)):
            assert torch.equal(got[i].view(-1)[lo:hi],
                               want[i].view(-1)[lo:hi])
