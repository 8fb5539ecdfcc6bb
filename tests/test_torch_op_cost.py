"""The port's op-counting cost model (``runtime/op_cost.py``) on the CPU.

Its rules are held to hand counts (views free, 2·M·N·K products,
elementwise and transcendental weights, reductions over their inputs,
operand + result bytes, the memory high-water mark), its matrix FLOPs
to the dot FLOPs that the JAX package's ``runtime/hlo_cost.py`` finds in
the compiled HLO of the same small programs (exactly), its collectives
to ``StageGroup``'s own byte counter over two gloo ranks, and the
kernels' meta route to its ``cost()``: recorded, nothing launched, the
CPU route recording the plain version's ATen ops instead.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as r6
from repro_torch.runtime import op_cost
from repro_torch.runtime.op_cost import CostCounter
from test_torch_threads import one_thread  # noqa: F401

META = torch.device("meta")


def _count(fn, *args):
    with CostCounter() as c:
        out = fn(*args)
    return c, out


# ---------------------------------------------------------------- the rules
@pytest.mark.parametrize("view", [
    lambda x: x.view(6, 20), lambda x: x.reshape(24, 5),
    lambda x: x.transpose(0, 2), lambda x: x.permute(2, 0, 1),
    lambda x: x[:, 1:3], lambda x: x[1], lambda x: x[None].expand(3, 2, 3, 20),
    lambda x: x.as_strided((2, 3), (1, 2)), lambda x: x.detach(),
    lambda x: x.unsqueeze(0).squeeze(0), lambda x: x.chunk(2, -1)[1],
    lambda x: x.unbind(0)[0]])
def test_views_cost_nothing(view):
    x = torch.randn(2, 3, 20)
    c, _ = _count(view, x)
    r = c.result()
    assert (r["flops"], r["bytes"], r["by_op"]) == (0.0, 0.0, {})
    assert c.peak == 0


@pytest.mark.parametrize("name,fn,shapes,flops", [
    ("mm", lambda a, b: a @ b, ((5, 7), (7, 3)), 2 * 5 * 3 * 7),
    ("bmm", torch.bmm, ((4, 5, 7), (4, 7, 3)), 2 * 4 * 5 * 3 * 7),
    ("addmm", lambda a, b: torch.nn.functional.linear(
        a, b, torch.ones(b.shape[0])), ((5, 7), (3, 7)), 2 * 5 * 3 * 7),
    ("baddbmm", lambda a, b: torch.baddbmm(torch.zeros(4, 5, 3), a, b),
     ((4, 5, 7), (4, 7, 3)), 2 * 4 * 5 * 3 * 7),
    ("bmm", lambda a, b: torch.einsum("bqhd,bkhd->bhqk", a, b),
     ((2, 5, 3, 8), (2, 6, 3, 8)), 2 * 2 * 3 * 5 * 6 * 8),
])
def test_matrix_products_cost_2mnk(name, fn, shapes, flops):
    args = [torch.randn(*s) for s in shapes]
    c, out = _count(fn, *args)
    r = c.result()
    assert r["matmul_flops"] == flops
    assert r["by_op"][name][1] == flops


def test_elementwise_transcendental_and_reduction_weights():
    x = torch.randn(4, 10)
    y = torch.randn(4, 10)
    c, _ = _count(lambda: (x + y, x.clamp(-1, 1), torch.exp(x), torch.tanh(y),
                           x.sum(-1), torch.where(x > 0, x, y)))
    by = c.result()["by_op"]
    n = 40.0
    assert by["add"][1] == n and by["clamp"][1] == 2 * n
    assert by["exp"][1] == by["exp"][3] == n
    assert by["tanh"][1] == by["tanh"][3] == n
    assert by["sum"][1] == n                   # a reduction: its input
    assert by["gt"][1] == n and by["where"][1] == n
    assert c.result()["transcendentals"] == 2 * n


def test_bytes_are_operands_and_results():
    x, y = torch.randn(8, 16), torch.randn(8, 16)
    c, _ = _count(lambda: x + y)
    assert c.result()["bytes"] == 3 * 8 * 16 * 4
    dst = torch.empty(8, 16)
    c, _ = _count(lambda: dst.copy_(x))
    assert c.result()["bytes"] == 2 * 8 * 16 * 4    # read x, write dst
    h = x.to(torch.bfloat16)
    c, _ = _count(lambda: h.float())
    assert c.result()["bytes"] == 8 * 16 * (2 + 4)
    r = c.result()
    assert r["bytes_fused"] == r["bytes"]        # eager: no fusion


def test_memory_high_water_mark():
    def f():
        a = torch.empty(1000)                  # 4,000 B
        b = torch.empty(500)                   # 2,000 B: 6,000 live
        del a                                  # 2,000 live
        c = torch.empty(250)                   # 3,000 live
        return b, c
    x = torch.randn(10)
    with CostCounter() as c:
        out = f()
    mem = c.memory(arguments=(x,), outputs=out)
    assert mem == {"argument_bytes": 40.0, "output_bytes": 3000.0,
                   "temp_bytes": 6000.0, "alias_bytes": 0.0}
    with CostCounter() as c:
        x.add_(1.0)                            # in place: no allocation
    assert c.memory(arguments=(x,), outputs=(x,)) == {
        "argument_bytes": 40.0, "output_bytes": 40.0, "temp_bytes": 0.0,
        "alias_bytes": 40.0}


def test_meta_and_cpu_count_alike():
    """The same code on meta tensors and on CPU tensors: the same ops,
    FLOPs, bytes and memory."""
    def f(a, w):
        h = torch.nn.functional.silu(a @ w)
        return torch.softmax(h, -1).sum()
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((16, 32), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 8), dtype=np.float32))
    c1, _ = _count(f, a, w)
    c2, _ = _count(f, a.to(META), w.to(META))
    assert op_cost.op_differences(c1.result(), c2.result()) == []
    assert c1.peak == c2.peak > 0


# ---------------------------------------------------------- against hlo_cost
def _dot_flops(text: str) -> float:
    """2·M·N·K of every dot in a compiled HLO module, by ``hlo_cost``'s
    parser and rule (the small programs here have no loops)."""
    from repro.runtime import hlo_cost
    total = 0.0
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
            total += 2.0 * relems * k
    return total


PROGRAMS = {
    "mlp": (lambda np_, x, w1, w2: np_.tanh(x @ w1) @ w2,
            ((6, 16), (16, 32), (32, 8))),
    "attention": (lambda np_, q, k, v: np_.einsum(
        "bhqk,bkhd->bqhd", np_.einsum("bqhd,bkhd->bhqk", q, k), v),
        ((2, 5, 3, 8), (2, 7, 3, 8), (2, 7, 3, 8))),
    "gated": (lambda np_, x, wg, w1: (x @ wg) * (x @ w1),
              ((4, 3, 16), (16, 24), (16, 24))),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_matrix_flops_equal_hlo_cost_dot_flops(name):
    import jax
    import jax.numpy as jnp
    fn, shapes = PROGRAMS[name]
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    text = jax.jit(lambda *a: fn(jnp, *a)).lower(*arrs).compile().as_text()
    c, _ = _count(lambda *a: fn(torch, *a),
                  *[torch.from_numpy(a) for a in arrs])
    assert c.result()["matmul_flops"] == _dot_flops(text) > 0


# ------------------------------------------------------------- collectives
def _counted_reduce_rank(group, tree, bucket_bytes):
    from repro_torch.models.layers import tree_map
    mine = tree_map(lambda _, a: torch.from_numpy(a.copy()), tree)
    with CostCounter() as c:
        group.all_reduce_mean(mine, bucket_bytes=bucket_bytes)
    return c.result()["collectives"], group.counters(), group.world


def test_counted_all_reduce_bytes_equal_the_groups_counter():
    """Two gloo ranks: the counter sees each bucket's ``c10d`` all-reduce,
    its bytes equal to ``StageGroup.counters()["bytes_reduce"]`` and its
    wire bytes the ring model's 2 (n - 1) / n of them."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 90), dtype=np.float32),
            "b": rng.standard_normal(1000, dtype=np.float32)}
    from repro_torch.launch.mesh import run_stage_ranks
    outs = run_stage_ranks(_counted_reduce_rank, 2, "cpu",
                           args=(tree, 1000), timeout_s=120.0)
    for coll, counters, world in outs:
        ar = coll["all-reduce"]
        assert ar["count"] == counters["n_reduce"] == -(-4 * 1630 // 1000)
        assert ar["result_bytes"] == counters["bytes_reduce"] == 4 * 1630
        assert ar["wire_bytes"] == 2.0 * 4 * 1630 * (world - 1) / world


# ------------------------------------------------------- the kernels' routes
def _flash_args(dev, dtype=torch.float32, b=2, sq=8, sk=8, H=4, KV=2, d=16):
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype).to(dev)
    return mk(b, sq, H, d), mk(b, sk, KV, d), mk(b, sk, KV, d)


def test_meta_route_records_cost_and_launches_nothing():
    """Each kernel on meta tensors: its outputs' shapes, one record of
    its ``cost()`` a call, no launch counted."""
    ops.reset_launch_counts()
    q, k, v = _flash_args(META, torch.bfloat16)
    with CostCounter() as c:
        o = ops.flash_attention(q.requires_grad_(), k.requires_grad_(),
                                v.requires_grad_(), True)
        o.float().sum().backward()
    assert o.shape == q.shape and o.device.type == "meta"
    kern = c.result()["kernels"]
    want = {w: fa.cost(w, 2, 8, 4, 2, 16, 16, kv_len=8, causal=True, el=2)
            for w in ("fwd", "dq", "dkv")}
    assert kern["flash_fwd"] == {"calls": 1, "flops": want["fwd"][0],
                                 "bytes": want["fwd"][1]}
    assert kern["flash_bwd_dq"]["bytes"] == want["dq"][1]
    assert kern["flash_bwd_dkv"]["flops"] == want["dkv"][0]
    # the scans and the update
    r, kk, vv = (torch.empty(1, 70, 2, 16, device=META) for _ in range(3))
    w = torch.empty(1, 70, 2, 16, device=META)
    u, S0 = torch.empty(2, 16, device=META), torch.empty(1, 2, 16, 16,
                                                           device=META)
    x = torch.empty(1, 70, 4, 16, device=META)
    dt = torch.empty(1, 70, 4, device=META)
    B = torch.empty(1, 70, 2, 16, device=META)
    S0m = torch.empty(1, 4, 16, 16, device=META)
    ws = [torch.empty(5, 3, device=META), torch.empty(0, device=META)]
    vs = [torch.empty_like(t) for t in ws]
    with CostCounter() as c:
        y, sT = ops.rwkv6_scan(r, kk, vv, w, u, S0)
        ym, sTm = ops.mamba2_scan(x, dt, dt, B, B, S0m)
        ops.fused_update(ws, vs, [t.clone() for t in ws], lr=0.1, gamma=0.9)
    kern = c.result()["kernels"]
    assert y.shape == r.shape and sTm.shape == S0m.shape
    assert kern["rwkv6_scan"]["flops"] == r6.cost(1, 70, 2, 16, el=4)[0]
    assert kern["mamba2_scan"]["bytes"] == m2.cost(1, 70, 4, 16, 16, 2,
                                                   el=4)[1]
    assert kern["fused_update"] == {"calls": 1, "flops": fu.cost(15)[0],
                                    "bytes": fu.cost(15)[1]}
    assert all(n == 0 for n in ops.launch_counts().values())
    assert all(n == 0 for n in ops.variant_counts().values())


def test_cpu_route_records_the_plain_versions_ops():
    q, k, v = _flash_args("cpu")
    with CostCounter() as c:
        ops.flash_attention(q, k, v, True)
    r = c.result()
    assert r["kernels"] == {}
    assert r["matmul_flops"] > 0 and "bmm" in r["by_op"]


def test_other_devices_still_raise():
    """Only cuda and meta take the kernels' route (the CPU its plain
    version); any other device raises, naming the three."""
    from types import SimpleNamespace
    with pytest.raises(ValueError, match="cuda, meta or cpu"):
        fa._check_device("flash_fwd",
                         SimpleNamespace(device=torch.device("mps")))


def test_pairs_closed_form():
    for sq, kv, off in ((7, 7, 0), (3, 40, 37), (12, 5, 0), (9, 20, 4),
                        (1, 1, 0), (5, 64, 100)):
        want = sum(min(kv, off + i + 1) for i in range(sq))
        assert fa.pairs(sq, kv, True, off) == want
        assert fa.pairs(sq, kv, False, off) == sq * kv
