"""The port's Mixture-of-Experts layer and MoE models against the JAX
package's, run live.

Inputs are drawn with numpy from seeds; weights are the JAX model's (or
the JAX layer's), carried over by ``from_jax_params``.  Everything runs
on the CPU in fp32.

Tolerances and why:

* ``moe_apply``'s output within 1e-5 and its aux loss within 1e-6: the
  same fp32 arithmetic in another summation order (the top-k gates,
  the expert products); the routing itself (top-k, slots, drops) is
  discrete and must agree exactly, which the output checks (a token
  dropped on one side only would move its row by its expert's output);
* gradients within 1e-5, as the port's layer tolerance;
* whole-model loss and logits within 1e-4 (several layers of it);
* the streaming SpecTrain ticks and the IR round as
  ``tests/test_torch_train.py`` holds them: losses within rtol 1e-5,
  every state leaf within rtol 1e-4 / atol 1e-5;
* engine tokens exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core import pipeline_stream as jps
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.models.layers import init_params as jinit_params
from repro.planner import plan as jplan
from repro.planner import serve_plan as jserve_plan
from repro.serve import SimpleEngine as JSimpleEngine
from repro.serve import poisson_trace as jpoisson_trace
from repro_torch import configs as tconfigs
from repro_torch.core import pipeline_stream as tps
from repro_torch.models import Model, from_jax_params
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import tree_leaves
from repro_torch.planner import plan as tplan
from repro_torch.planner import serve_plan
from repro_torch.serve import Request, ServeEngine, SimpleEngine
from test_torch_model import port_cfg
from test_torch_train import _batches, _close_trees
from test_torch_threads import one_thread  # noqa: F401

OUT_TOL, AUX_TOL, GRAD_TOL, MODEL_TOL = 1e-5, 1e-6, 1e-5, 1e-4
LOSS_RTOL = 1e-5
LR = 0.05
MOE_ARCHS = ("deepseek-moe-16b", "grok-1-314b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


def _layer_cfg(*, E=4, k=2, shared=1, gated=True, cf=1.25, d=32, ff=48):
    """An fp32 MoE config for the bare layer (JAX, port)."""
    j = jsmoke_config(jget_config("deepseek-moe-16b")).replace(
        d_model=d, d_ff=ff, mlp_gated=gated, param_dtype="float32",
        compute_dtype="float32")
    j = j.replace(moe=dataclasses.replace(
        j.moe, num_experts=E, top_k=k, num_shared=shared,
        capacity_factor=cf))
    return j, port_cfg(j)


# name, (E, k, shared, gated, capacity factor), (b, s): G = 16 when T
# divides by 16 and T / 16 >= E, else 1
LAYER_CASES = [
    ("G1 shared gated", (4, 2, 1, True, 1.25), (2, 5)),
    ("G16 no shared non-gated", (4, 2, 0, False, 1.25), (2, 32)),
    ("G1 overflow no shared", (4, 2, 0, True, 0.5), (1, 24)),
    ("G16 overflow shared non-gated", (8, 3, 2, False, 0.3), (8, 16)),
]


def _jax_moe(jc):
    return jax.jit(lambda p_, x_: jmoe.moe_apply(jc, p_, x_))


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_moe_apply_matches_jax(case):
    name, (E, k, shared, gated, cf), (b, s) = case
    jc, tc = _layer_cfg(E=E, k=k, shared=shared, gated=gated, cf=cf)
    p = jinit_params(jmoe.moe_specs(jc), jax.random.PRNGKey(len(name)))
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, jc.d_model)).astype(np.float32)
    jo, ja = _jax_moe(jc)(p, jnp.asarray(x))
    to, ta = tmoe.moe_apply(tc, _t(p), torch.from_numpy(x))
    _close(to, jo, OUT_TOL, "out")
    assert abs(float(ta) - float(ja)) <= AUX_TOL
    T = b * s
    G = tmoe.dispatch_groups(tc, T)
    assert G == (16 if name.startswith("G16") else 1)
    r = tmoe.route(tc, _t(p), torch.from_numpy(x).reshape(G, T // G, -1),
                   tmoe.capacity(tc, T // G))
    if "overflow" in name:      # the same pairs dropped on both sides
        assert int((~r.keep).sum()) > 0


def test_moe_grads_match_jax():
    """d(sum(out * w) + aux) by every weight and by x, at G = 16 with a
    capacity that drops pairs (their gradient is zero on both sides)."""
    jc, tc = _layer_cfg(E=4, k=2, shared=1, cf=0.6)
    p = jinit_params(jmoe.moe_specs(jc), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((4, 16, jc.d_model)).astype(np.float32)

    def jf(p_, x_):
        out, aux = jmoe.moe_apply(jc, p_, x_)
        return jnp.sum(out * w) + aux
    jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(p, jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_apply(tc, tp, tx)
    (out * torch.from_numpy(w)).sum().add(aux).backward()
    for key in sorted(p):
        _close(tp[key].grad, jgp[key], GRAD_TOL, key)
    _close(tx.grad, jgx, GRAD_TOL, "x")
    assert float(tp["router"].grad.abs().max()) > 0


def test_serving_routes_each_token_alone():
    """``moe_apply_tokens`` on a prompt of T tokens equals the JAX layer
    called on each token alone (T = 1, capacity 1: what the JAX engines'
    decode steps give it), where the JAX layer on the whole prompt drops
    pairs."""
    jc, tc = _layer_cfg(E=4, k=2, shared=0, cf=0.5)
    p = jinit_params(jmoe.moe_specs(jc), jax.random.PRNGKey(5))
    x = np.random.default_rng(6).standard_normal(
        (1, 12, jc.d_model)).astype(np.float32)
    jf = _jax_moe(jc)
    want = np.concatenate([np.asarray(jf(p, jnp.asarray(x[:, i:i + 1]))[0])
                           for i in range(12)], 1)
    got, _ = tmoe.moe_apply_tokens(tc, _t(p), torch.from_numpy(x))
    _close(got, want, OUT_TOL)
    shared_cap, _ = jf(p, jnp.asarray(x))
    assert not np.allclose(np.asarray(shared_cap), want, atol=1e-3)


# ---------------------------------------------------------------------------
# the MoE models


@functools.lru_cache(maxsize=None)
def _shared_pair(arch, n_layers):
    """One pair a few tests read and none writes."""
    return _model_pair(arch, n_layers=n_layers)


def _model_pair(arch, *, S=1, n_layers=2, seed=0, capacity_factor=None):
    jc = tiny_cfg(arch, n_layers=n_layers, pipe=S)
    if capacity_factor is not None:
        jc = jc.replace(moe=dataclasses.replace(
            jc.moe, capacity_factor=capacity_factor))
    jm = JModel(jc)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = Model(port_cfg(jc), device="cpu")
    tp = from_jax_params(_np(jp), tm.cfg, device="cpu")
    return jc, jm, jp, tm, tp


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_loss_and_grads_match_jax(arch):
    jc, jm, jp, tm, tp = _shared_pair(arch, 2)
    b = _batches(jc, 1, batch=2, seq=32)[0]   # T = 64: G = 16
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, b)
    _, jaux = jax.jit(jm.forward)(jp, b)
    leaves = jax.tree.map(lambda a: a.detach().requires_grad_(), tp,
                          is_leaf=lambda a: isinstance(a, torch.Tensor))
    tb = {k: torch.from_numpy(np.asarray(v)).long() for k, v in b.items()}
    tloss = tm.loss(leaves, tb)
    _, taux = tm.forward(tp, tb)
    assert float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    _close(tloss, jloss, MODEL_TOL, "loss")
    tloss.backward()
    gl = [a.grad if a.grad is not None else torch.zeros_like(a)
          for a in tree_leaves(leaves)]
    for i, (g, w) in enumerate(zip(gl, jax.tree.leaves(jg))):
        _close(g, w, MODEL_TOL, f"grad leaf {i}")


def _stream(arch, S, mode, *, coef=None, ticks=None):
    jc, jm, jp, tm, tp = _model_pair(arch, S=S, n_layers=2 * S, seed=S)
    if coef is not None:
        # the port alone, with the routers' aux loss switched off
        tm = Model(tm.cfg.replace(moe=dataclasses.replace(
            tm.cfg.moe, aux_loss_coef=coef)), device="cpu")
    n = ticks or 2 * (S - 1) + 3
    bs = _batches(jc, n, batch=2, seq=16)
    ts = tps.make_state(tm, tp, bs[0], mode=mode)
    tstep = tps.make_train_step(tm, mode=mode, lr=LR)
    tl = []
    for b in bs:
        ts, met = tstep(ts, b)
        tl.append((float(met["loss"]), met["loss_valid"]))
        assert "aux" in met and np.isfinite(float(met["aux"]))
    if coef is not None:
        return ts, None, tl, None
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       bs[0])
    js = jps.make_state(jm, jp, sds, mode=mode)
    jstep = jax.jit(jps.make_train_step(jm, mode=mode, lr=LR))
    jl = []
    for b in bs:
        js, jmet = jstep(js, b)
        jl.append((float(jmet["loss"]), float(jmet["loss_valid"])))
    return ts, js, tl, jl


@pytest.mark.parametrize("arch,S", [("deepseek-moe-16b", 2)])
def test_spectrain_ticks_take_the_aux_cotangent(arch, S):
    """2(S-1)+3 SpecTrain ticks: every loss, params, momentum and
    prediction leaf as JAX's, whose stage backward takes each stage's
    aux loss with cotangent ``valid_b``.  The routers' weights then
    differ from a run with the aux loss off: their gradient carries the
    aux term."""
    ts, js, tl, jl = _stream(arch, S, "spectrain")
    assert [v for _, v in tl] == [v for _, v in jl]
    np.testing.assert_allclose([x for x, _ in tl], [x for x, _ in jl],
                               rtol=LOSS_RTOL)
    _close_trees(ts["params"], js["params"], "params")
    _close_trees(ts["momentum"], js["momentum"], "momentum")
    off, _, _, _ = _stream(arch, S, "spectrain", coef=0.0)
    for k in range(S):
        a = ts["params"]["stages"][k]["layers"]["moe"]["router"]
        b = off["params"]["stages"][k]["layers"]["moe"]["router"]
        assert float((a - b).abs().max()) > 1e-7, k


def test_one_1f1b_ir_round_matches_jax():
    """One 1f1b round (2 stages of grok's smoke layer, 2 microbatches,
    spectrain): the loss (aux left out, as JAX leaves it out) and every
    state leaf; the chunk backwards take the aux cotangent 1, as JAX's
    do."""
    jc, jm, jp, tm, tp = _model_pair("grok-1-314b", S=2, n_layers=2,
                                     seed=7)
    kw = dict(n_stages=2, schedule="1f1b", n_microbatches=2,
              partitioner="uniform")
    jpl, tpl = jplan(jc, **kw), tplan(tm.cfg, **kw)
    b = _batches(jc, 1, batch=2, seq=16)[0]
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), b)
    js = jps.make_ir_state(jm, jp, sds, plan=jpl, mode="spectrain")
    js, jmet = jax.jit(jps.make_ir_train_step(
        jm, plan=jpl, mode="spectrain", lr=LR, backend="unrolled"))(js, b)
    ts = tps.make_ir_state(tm, tp, b, plan=tpl, mode="spectrain")
    ts, tmet = tps.make_ir_train_step(tm, plan=tpl, mode="spectrain",
                                      lr=LR)(ts, b)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    _close_trees(ts["params"], js["params"], "params")
    _close_trees(ts["momentum"], js["momentum"], "momentum")


# ---------------------------------------------------------------------------
# serving: every token routed alone


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engines_emit_jax_tokens(arch):
    """The port's SimpleEngine and pipelined ServeEngine (2 stages) emit
    JAX SimpleEngine's tokens (which JAX's ServeEngine emits too,
    ``tests/test_serve.py``) on one trace with prompts up to 8 tokens
    (where a prompt-wide capacity could drop pairs)."""
    jc, jm, jp, tm, tp = _model_pair(arch, S=2, n_layers=2, seed=11)
    trace = jpoisson_trace(5, rate=1.0, seed=2, prompt_lens=(3, 8),
                           gen_lens=(2, 4), vocab=jc.vocab_size)
    kw = dict(n_slots=3, max_prefill=2, prompt_budget=8, page_seq=32)
    one = dict(n_stages=1, n_slots=1, max_prefill=1, prompt_budget=8,
               page_seq=32, validate=False)
    want = JSimpleEngine(jm, jp, jserve_plan(jc, **one)).run(trace)
    reqs = [Request(q.rid, q.arrival, q.prompt, q.gen_len) for q in trace]
    got = SimpleEngine(tm, tp, serve_plan(tm.cfg, **one)).run(reqs)
    assert got == want
    got_p = ServeEngine(tm, tp, serve_plan(tm.cfg, n_stages=2, **kw)).run(
        reqs)
    assert got_p == want


def test_long_prompt_prefill_matches_stepped_decode():
    """A 12-token prompt: the port's one-call prefill gives JAX's
    ``decode_step`` stepped token by token (JAX SimpleEngine's prefill)
    its logits and KV cache, where JAX's whole-prompt forward (one
    shared capacity: 4 slots an expert at capacity factor 0.5, for 24
    pairs over 4 experts) drops pairs and parts from both."""
    jc, jm, jp, tm, tp = _model_pair("deepseek-moe-16b", n_layers=2,
                                     capacity_factor=0.5)
    toks = np.random.default_rng(14).integers(0, jc.vocab_size, (1, 12))
    cache = jm.init_cache(1, 16)
    step = jax.jit(jm.decode_step)
    rows = []
    for i in range(12):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                         jnp.asarray(i, jnp.int32))
        rows.append(np.asarray(lg))
    want = np.concatenate(rows, 1)
    got, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 16)
    _close(got, want, MODEL_TOL, "logits")
    _close(tcache["layers"]["k"], cache["layers"]["k"], MODEL_TOL, "k")
    whole, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)})
    assert not np.allclose(np.asarray(whole), want, atol=1e-3)


def test_moe_configs_build_in_the_port():
    for name in MOE_ARCHS:
        t, j = tconfigs.get_config(name), jget_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        s, js = tconfigs.smoke_config(t), jsmoke_config(j)
        assert dataclasses.asdict(s) == dataclasses.asdict(js)
        specs = Model(s, device="cpu").param_specs()
        layer = specs["stages"][0]["layers"]
        assert "moe" in layer and "mlp" not in layer
        E = s.moe.num_experts
        assert layer["moe"]["router"].shape == (s.n_layers, s.d_model, E)
        assert layer["moe"]["w2"].shape == (s.n_layers, E, s.d_ff,
                                            s.d_model)
        assert ("shared_w1" in layer["moe"]) == bool(s.moe.num_shared)
