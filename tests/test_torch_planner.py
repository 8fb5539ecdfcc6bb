"""The port's planner against the JAX package's, exactly.

Pure Python and numpy on both sides, so everything is held to equality
(modelled stage costs to a relative 1e-12): for every emitter x S in
{1..4} x v in {1, 2} x {uniform, dp} x {a skewed synthetic profile, the
analytic profile of a tiny granite and of the full granite-8b}, the
``plan()`` fields, the emitted ``Schedule`` events and metrics, the
lowered ``EventTable`` and ``DeviceStreams``, the verifier's reports and
the mutation harness's catch counts and failure names; plus partition,
profiler (analytic; the timed method on the CPU; hlo, counted on the meta
device, against JAX's compiled block), the verifier's CLI
and its error cases.
"""
import dataclasses

import numpy as np
import pytest

from conftest import tiny_cfg
from repro.configs import get_config as jget_config
from repro.planner import api as japi
from repro.planner import partition as jpt
from repro.planner import profiler as jpf
from repro.planner import schedule_ir as jir
from repro.planner import verify as jpv
from repro_torch.configs import get_config as tget_config
from repro_torch.planner import api as tapi
from repro_torch.planner import partition as tpt
from repro_torch.planner import profiler as tpf
from repro_torch.planner import schedule_ir as tir
from repro_torch.planner import verify as tpv
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401

EMITTERS = tuple(jir.EMITTERS)
COSTS = [1.0 + 0.5 * (i % 3) + (2.0 if i == 0 else 0.0) for i in range(9)]


def _profiles():
    """(label, JAX kwargs, port kwargs) for the three profile kinds."""
    tiny = tiny_cfg("granite-8b", n_layers=9, pipe=2)
    full = jget_config("granite-8b")
    assert tget_config("granite-8b").param_count() == full.param_count()
    return [
        ("synthetic", dict(profile=jpf.synthetic_profile(
            COSTS, act_bytes=3e5)), dict(profile=tpf.synthetic_profile(
                COSTS, act_bytes=3e5))),
        ("tiny", dict(config=tiny, batch=4, seq=16),
         dict(config=port_cfg(tiny), batch=4, seq=16)),
        ("granite-8b", dict(config=full, batch=8, seq=512),
         dict(config=tget_config("granite-8b"), batch=8, seq=512)),
    ]


def _either(fn):
    try:
        return fn(), None
    except Exception as e:      # the twins must fail alike
        return None, type(e)


def _same_profile(t, j):
    assert (t.arch, t.method, t.batch, t.seq) == (j.arch, j.method, j.batch,
                                                  j.seq)
    assert [dataclasses.astuple(x) for x in t.layers] == \
        [dataclasses.astuple(x) for x in j.layers]


def _same_events(t, j):
    assert [dataclasses.astuple(e) for e in t.events] == \
        [dataclasses.astuple(e) for e in j.events]
    assert (t.name, t.n_stages, t.n_devices, t.round_microbatches) == \
        (j.name, j.n_stages, j.n_devices, j.round_microbatches)
    assert t.render() == j.render()


def _same_plan(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name == "profile":
            _same_profile(a, b)
        elif f.name == "ir":
            _same_events(a, b)
        elif f.name == "partition":
            assert a.boundaries == b.boundaries
        elif f.name in ("bottleneck_s", "uniform_bottleneck_s"):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
        elif f.name == "stage_costs_s":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
        else:
            assert a == b, f.name
    assert t.summary() == j.summary()
    assert (t.n_chunks, t.n_devices, t.stage_ranges, t.stage_sizes) == \
        (j.n_chunks, j.n_devices, j.stage_ranges, j.stage_sizes)


def _same_reports(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert (a.artifact, a.schedule, a.n_events, a.ok) == \
            (b.artifact, b.schedule, b.n_events, b.ok)
        assert [dataclasses.astuple(v) for v in a.violations] == \
            [dataclasses.astuple(v) for v in b.violations]
        assert a.stats == b.stats


@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("schedule", EMITTERS)
def test_plan_and_artifacts_equal_jax(schedule, S, v):
    for label, jkw, tkw in _profiles():
        for part in ("uniform", "dp"):
            kw = dict(n_stages=S, schedule=schedule, virtual_stages=v,
                      partitioner=part)
            j, jerr = _either(lambda: japi.plan(**jkw, **kw))
            t, terr = _either(lambda: tapi.plan(**tkw, **kw))
            assert terr == jerr, (label, part, terr, jerr)
            if j is None:
                continue
            _same_plan(t, j)
            tapi.check_against_closed_forms(t)
            if schedule not in tir.ROUND_SCHEDULES:
                _same_reports(tpv.verify_plan(t), jpv.verify_plan(j))
                continue
            assert t.round_program() == j.round_program()
            te, je = t.event_table(), j.event_table()
            assert te.branches == je.branches
            np.testing.assert_array_equal(te.rows, je.rows)
            assert (te.n_val_slots, te.n_cot_slots) == (je.n_val_slots,
                                                        je.n_cot_slots)
            ts, js = t.device_streams(), j.device_streams()
            assert ts.branches == js.branches
            np.testing.assert_array_equal(ts.rows, js.rows)
            assert (ts.n_val_slots, ts.n_cot_slots, ts.n_devices) == \
                (js.n_val_slots, js.n_cot_slots, js.n_devices)
            _same_reports(tpv.verify_plan(t), jpv.verify_plan(j))
            t.verify()
            if label != "synthetic":
                continue        # the artifacts depend on schedule/S/v/M
            got, gerr = _either(lambda: tpv.self_test(t))
            want, werr = _either(lambda: jpv.self_test(j))
            assert gerr == werr and got == want
            if want is not None:
                assert want[0] >= 18 and want[1] == []
                names_t = [(n, c) for n, c, _ in tpv.mutation_catalog(
                    te, ts)]
                names_j = [(n, c) for n, c, _ in jpv.mutation_catalog(
                    je, js)]
                assert names_t == names_j


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "2bw",
                                      "interleaved"])
@pytest.mark.parametrize("M", [2, 3, 4, 6, 8])
def test_round_sizes_equal_jax(schedule, M):
    """The launcher's round sizes (and the ones the emitters refuse)."""
    v = 2 if schedule == "interleaved" else 1
    kw = dict(n_layers=8, n_stages=2, schedule=schedule, virtual_stages=v,
              n_microbatches=M)
    j, jerr = _either(lambda: japi.plan(**kw))
    t, terr = _either(lambda: tapi.plan(**kw))
    assert terr == jerr
    if j is not None:
        _same_plan(t, j)
        np.testing.assert_array_equal(t.event_table().rows,
                                      j.event_table().rows)
        _same_reports(tpv.verify_plan(t), jpv.verify_plan(j))


def test_emitters_and_metrics_equal_jax():
    for name in EMITTERS:
        for S in (1, 2, 3, 5):
            kw = {"v": 3} if name == "interleaved" else {}
            j, jerr = _either(lambda: jir.emit(name, S, **kw))
            t, terr = _either(lambda: tir.emit(name, S, **kw))
            assert terr == jerr
            if j is None:
                continue
            _same_events(t, j)
            t.validate()
            assert t.bubble_fraction() == j.bubble_fraction()
            assert t.minibatches() == j.minibatches()
            assert t.complete_minibatches() == j.complete_minibatches()
            mb = j.steady_minibatch()
            assert t.steady_minibatch() == mb
            for k in range(t.n_stages):
                for phase in ("forward", "backward"):
                    assert t.staleness(k, phase) == j.staleness(k, phase)
                assert (t.bwd_lag(k), t.fwd_bwd_gap(k),
                        t.peak_activation_stash(k),
                        t.weight_stash_depth(k)) == \
                    (j.bwd_lag(k), j.fwd_bwd_gap(k),
                     j.peak_activation_stash(k), j.weight_stash_depth(k))
    with pytest.raises(KeyError):
        tir.emit("zigzag", 2)
    with pytest.raises(ValueError):
        tir.pipedream_2bw(4, n_microbatches=2)
    with pytest.raises(ValueError):
        tir.interleaved_1f1b(2, n_microbatches=3)


def test_partition_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(40):
        L = int(rng.integers(1, 14))
        S = int(rng.integers(1, 6))
        compute = list(rng.uniform(0.1, 3.0, L))
        cut = list(rng.uniform(0.0, 0.5, L - 1 if rng.random() < .5 else L))
        for fn in (lambda m: m.dp_split(compute, cut, S),
                   lambda m: m.uniform(L, S)):
            j, jerr = _either(lambda: fn(jpt))
            t, terr = _either(lambda: fn(tpt))
            assert terr == jerr
            if j is None:
                continue
            assert t.boundaries == j.boundaries
            assert (t.sizes(), t.stages(), t.n_stages, t.n_layers) == \
                (j.sizes(), j.stages(), j.n_stages, j.n_layers)
            assert tpt.bottleneck(compute, cut, t) == \
                jpt.bottleneck(compute, cut, j)
            assert [t.stage_of(i) for i in range(L)] == \
                [j.stage_of(i) for i in range(L)]
    prof_t = tpf.synthetic_profile(COSTS, act_bytes=1e6)
    prof_j = jpf.synthetic_profile(COSTS, act_bytes=1e6)
    for S in (1, 2, 4):
        pt_, pj = (tpt.partition_profile(prof_t, S),
                   jpt.partition_profile(prof_j, S))
        assert pt_.boundaries == pj.boundaries
        assert tpt.profile_stage_costs(prof_t, pt_) == \
            jpt.profile_stage_costs(prof_j, pj)
        assert tpt.profile_bottleneck(prof_t, pt_) == \
            jpt.profile_bottleneck(prof_j, pj)
        assert tpt._costs_from_profile(prof_t) == \
            jpt._costs_from_profile(prof_j)
    with pytest.raises(ValueError):
        tpt.partition_profile(prof_t, 2, method="zigzag")


def test_profiler_equal_jax():
    for name in ("granite-8b", "rwkv6-7b", "zamba2-1.2b", "granite-20b",
                 "starcoder2-15b", "deepseek-moe-16b", "grok-1-314b"):
        for jcfg, tcfg in ((jget_config(name), tget_config(name)),):
            for b, s in ((1, 32), (8, 512)):
                _same_profile(
                    tpf.profile_model(tcfg, batch=b, seq=s,
                                      method="analytic"),
                    jpf.profile_model(jcfg, batch=b, seq=s,
                                      method="analytic"))
    scaled = [1.0, 2.0] * 18
    _same_profile(tpf.profile_model(tget_config("granite-8b"),
                                    method="analytic").scaled(scaled),
                  jpf.profile_model(jget_config("granite-8b"),
                                    method="analytic").scaled(scaled))
    with pytest.raises(ValueError):
        tpf.profile_model(tget_config("granite-8b"), method="guess")
    # "hlo" and "auto" (which takes "hlo" first): one block counted on
    # the meta device, held to JAX's profile_model(method="hlo")
    tiny = tiny_cfg("granite-8b", n_layers=9, pipe=2)
    for method in ("hlo", "auto"):
        _hlo_profile_against_jax(tiny, port_cfg(tiny), method, 4, 16)


# the port's total against JAX's compiled block: the attention products
# count the causal pairs (about half of JAX's masked s x s dots) and
# eager ops are counted one by one where XLA fuses; 6% covers the tiny
# block (5.2% apart), the full granite-8b block is 1.2% apart
HLO_TOTAL_RTOL = 0.06


def _jax_block_dots(jcfg, batch, seq):
    """The dot FLOPs of JAX's compiled block (``profiler._hlo_layer``'s
    function), summed with ``hlo_cost.parse_module`` and its 2·M·N·K
    rule: (the projections' dots, the batched attention dots)."""
    import re
    import jax
    from repro.runtime import hlo_cost
    f, params, x = jpf._block_fn_and_args(jcfg, batch, seq)
    text = jax.jit(f).lower(params, x).compile().as_text()
    plain = batched = 0.0
    for comp in hlo_cost.parse_module(text).values():
        for ins in comp.instrs:
            if ins.opcode != "dot":
                continue
            relems, _ = hlo_cost._shape_info(ins.rtype)
            lhs = comp.table[hlo_cost._operands(ins.rest)[0]]
            dims = [int(d) for d in
                    hlo_cost._SHAPE_RE.search(lhs).group(2).split(",")]
            cd = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", ins.rest)
            k = int(np.prod([dims[int(i)] for i in cd.group(1).split(",")]))
            if "lhs_batch_dims" in ins.rest:
                batched += 2.0 * relems * k
            else:
                plain += 2.0 * relems * k
    return plain, batched


def _hlo_profile_against_jax(jcfg, tcfg, method, batch, seq):
    """The port's ``hlo`` profile (``method`` "hlo" or "auto") against
    JAX's: the method recorded, the bytes exactly, the counted matrix
    FLOPs equal to JAX's dots (the projections' ``mm`` exactly, the flash
    kernels' ``cost()`` exactly the batched attention dots at the causal
    pairs' share), the total within ``HLO_TOTAL_RTOL``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import dtype_of, tree_map
    from repro_torch.models.transformer import block_apply, block_specs
    from repro_torch.runtime.op_cost import CostCounter
    t = tpf.profile_model(tcfg, batch=batch, seq=seq, method=method)
    j = jpf.profile_model(jcfg, batch=batch, seq=seq, method="hlo")
    assert (t.method, j.method) == ("hlo", "hlo")
    assert t.n_layers == j.n_layers == jcfg.n_layers
    for a, b in zip(t.layers, j.layers):
        assert (a.name, a.param_bytes, a.act_bytes, a.time_s) == \
            (b.name, b.param_bytes, b.act_bytes, b.time_s)
        assert a.flops == pytest.approx(b.flops, rel=HLO_TOTAL_RTOL)
    meta = torch.device("meta")
    params = tree_map(lambda _, sp: torch.empty(
        sp.shape, dtype=dtype_of(sp.dtype or tcfg.param_dtype),
        device=meta), block_specs(tcfg))
    x = torch.empty((batch, seq, tcfg.d_model),
                    dtype=dtype_of(tcfg.compute_dtype), device=meta)
    with torch.no_grad(), CostCounter() as c:
        block_apply(tcfg, params, x)
    r = c.result()
    plain, batched = _jax_block_dots(jcfg, batch, seq)
    assert r["matmul_flops"] == plain
    share = fa.pairs(seq, seq, True) / (seq * seq)
    assert r["kernels"]["flash_fwd"]["flops"] == batched * share
    assert r["flops"] == t.layers[0].flops


def test_hlo_profile_of_full_granite_matches_jax():
    """The planner tests' full-size configuration (granite-8b at 8 x
    512): the counted block against JAX's compiled one."""
    _hlo_profile_against_jax(jget_config("granite-8b"),
                             tget_config("granite-8b"), "hlo", 8, 512)


@pytest.mark.parametrize("schedule", ["stream", "1f1b"])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_hlo_plans_have_jax_stage_sizes(schedule, S):
    """``plan()`` with ``profile_method="hlo"`` splits the layers as the
    JAX planner does, for the planner tests' two configurations."""
    for label, jkw, tkw in _profiles()[1:]:
        kw = dict(n_stages=S, schedule=schedule, partitioner="dp",
                  profile_method="hlo")
        j = japi.plan(**jkw, **kw)
        t = tapi.plan(**tkw, **kw)
        assert t.partition.sizes() == j.partition.sizes(), label
        assert t.profile.method == j.profile.method == "hlo"


def test_timed_profile_on_the_cpu():
    """``timed`` runs one port block on the CPU (``perf_counter``) and
    back-fills the analytic FLOPs, as the JAX twin does."""
    cfg = port_cfg(tiny_cfg("granite-8b", n_layers=5, pipe=2))
    prof = tpf.profile_model(cfg, batch=2, seq=16, method="timed",
                             device="cpu")
    ana = tpf.profile_model(cfg, batch=2, seq=16, method="analytic")
    assert prof.method == "timed" and prof.n_layers == 5
    assert all(lp.time_s > 0 for lp in prof.layers)
    assert [lp.flops for lp in prof.layers] == [lp.flops
                                                for lp in ana.layers]
    p = tapi.plan(cfg, n_stages=2, schedule="1f1b", batch=2, seq=16,
                  profile_method="timed", device="cpu")
    assert p.profile.method == "timed" and sum(p.stage_sizes) == 5


def test_plan_errors_equal_jax():
    bad = [dict(schedule="zigzag"), dict(schedule="1f1b", virtual_stages=2),
           dict(schedule="interleaved", virtual_stages=0),
           dict(schedule="1f1b", n_layers=1, n_stages=2),
           dict(schedule="2bw", n_microbatches=1, n_stages=2)]
    for kw in bad:
        kw = dict({"n_stages": 2, "n_layers": 4}, **kw)
        _, jerr = _either(lambda: japi.plan(**kw))
        _, terr = _either(lambda: tapi.plan(**kw))
        assert jerr is not None and terr == jerr, kw
    stream = tapi.plan(n_layers=4, n_stages=2, schedule="stream")
    with pytest.raises(ValueError, match="not a round schedule"):
        stream.round_program()
    assert stream.ring_slots == japi.plan(n_layers=4, n_stages=2,
                                          schedule="stream").ring_slots


def test_keep_ir_false_reemits_the_same_round():
    for name, v in (("1f1b", 1), ("2bw", 1), ("interleaved", 2)):
        kw = dict(n_layers=8, n_stages=2, schedule=name, virtual_stages=v)
        a, b = tapi.plan(**kw), tapi.plan(keep_ir=False, **kw)
        assert b.ir is None
        np.testing.assert_array_equal(a.event_table().rows,
                                      b.event_table().rows)
        assert a.round_program() == b.round_program()


@pytest.mark.parametrize("argv", [
    ["--grid", "-q"], ["--self-test", "--schedule", "2bw", "--stages", "3"],
    ["--self-test", "--schedule", "interleaved", "--virtual-stages", "2",
     "--stages", "2", "--ragged"],
    ["--schedule", "gpipe", "--stages", "4", "--microbatches", "6"],
    ["--serve", "--stages", "3", "--self-test"]])
def test_verify_cli_equal_jax(argv, capsys):
    """``python -m repro_torch.planner.verify`` prints what the JAX CLI
    prints and exits 0."""
    assert tpv.main(argv) == 0
    got = capsys.readouterr().out
    assert jpv.main(argv) == 0
    want = capsys.readouterr().out
    assert got == want and got


def test_verifier_flags_a_corrupted_table():
    p = tapi.plan(n_layers=6, n_stages=3, schedule="1f1b")
    for name, check, bad in tpv.mutation_catalog(p.event_table(),
                                                 p.device_streams()):
        if isinstance(bad, tir.EventTable):
            rep = tpv.verify_event_table(bad, schedule="1f1b",
                                         act_stash=p.act_stash,
                                         w_stash_depth=p.w_stash_depth)
        else:
            rep = tpv.verify_device_streams(bad, schedule="1f1b",
                                            act_stash=p.act_stash,
                                            w_stash_depth=p.w_stash_depth)
        assert not rep.ok and check in {v.check for v in rep.violations}
        with pytest.raises(tpv.VerificationError):
            rep.raise_on_violation()
