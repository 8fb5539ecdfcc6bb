"""The port's vision-frontend model (pixtral-12b: a dense GQA backbone
whose first positions take image patches) against the JAX package's,
run live; and the cost twins of the two architectures this slice ports.

Everything runs on the CPU in fp32 at JAX's smoke size (d_model 64, 4
heads over 4 KV heads of 16; 4 patches, the smoke size JAX's own tests
take), inputs drawn with numpy from seeds; weights are the JAX model's,
carried over by ``from_jax_params``.

Tolerances: logits within 1e-4 (several layers); the streaming SpecTrain
ticks as ``tests/test_torch_train.py`` holds them (every loss within
rtol 1e-5, every state leaf within rtol 1e-4 / atol 1e-5); engine tokens
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import tiny_cfg
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.core import pipeline_stream as jps
from repro.models import Model as JModel
from repro.planner import serve_plan as jserve_plan
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SimpleEngine as JSimpleEngine
from repro.serve import poisson_trace as jpoisson_trace
from repro_torch import configs as tconfigs
from repro_torch.core import pipeline_stream as tps
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import Model, from_jax_params
from repro_torch.planner import serve_plan
from repro_torch.serve import Request, ServeEngine, SimpleEngine
from test_torch_model import port_cfg
from test_torch_train import _close_trees
from test_torch_threads import one_thread  # noqa: F401

MODEL_TOL = 1e-4
LOSS_RTOL = 1e-5
LR = 0.05
ARCH = "pixtral-12b"
PATCHES = 4


def _pair(*, S=1, n_layers=2, seed=0):
    jc = tiny_cfg(ARCH, n_layers=n_layers, pipe=S,
                  frontend_patches=PATCHES)
    jm = JModel(jc)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = Model(port_cfg(jc), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, device="cpu")
    return jc, jm, jp, tm, tp


def _batches(cfg, n, *, batch=2, seq=12, seed=0):
    """Token/target batches that carry ``PATCHES`` patches each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
        t = t.astype(np.int32)
        out.append({"tokens": t[:, :-1], "targets": t[:, 1:],
                    "patches": rng.standard_normal(
                        (batch, PATCHES, cfg.d_model)).astype(np.float32)})
    return out


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


def test_pixtral_config_builds_in_the_port():
    t, j = tconfigs.get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.n_heads, t.n_kv_heads, t.hd, t.rope_theta, t.vocab_size,
            t.tie_embeddings) == (32, 8, 128, 1e6, 131072, False)
    assert (t.frontend, t.frontend_patches) == ("vision", 256)
    assert dataclasses.asdict(tconfigs.smoke_config(t)) == \
        dataclasses.asdict(jsmoke_config(j))
    m = Model(tconfigs.smoke_config(t), device="cpu")
    assert m.n_stages == 1 and not m.hybrid


def test_cost_twins_equal_jax():
    """whisper-base and pixtral-12b (read for their cost only before
    this port): parameter counts equal the JAX ``ArchConfig``'s, the
    spec trees count the same parameters as JAX's, and the figure twins'
    cost rows are JAX's."""
    from benchmarks import _timeline as jt
    from repro.models.layers import is_spec
    from repro_torch.bench import _timeline as tt
    from repro_torch.models.layers import tree_leaves
    for name in ("whisper-base", "pixtral-12b"):
        t, j = tconfigs.arch_config(name), jget_config(name)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        n_t = sum(int(np.prod(sp.shape)) for sp in
                  tree_leaves(Model(t, device="cpu").param_specs()))
        n_j = sum(int(np.prod(sp.shape)) for sp in jax.tree.leaves(
            JModel(j).param_specs(), is_leaf=is_spec))
        assert n_t == n_j
    rows = {m.name: dataclasses.astuple(m) for m in tt.lm_models()}
    want = {m.name: dataclasses.astuple(m) for m in jt.lm_models()}
    for name in ("whisper-base", "pixtral-12b"):
        assert rows[name] == want[name]


def test_forward_with_patches_matches_jax():
    jc, jm, jp, tm, tp = _pair(n_layers=3, seed=1)
    b = _batches(jc, 1, seed=2)[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want, _ = jax.jit(jm.forward)(jp, jb)
    got, _ = tm.forward(tp, tb)
    _close(got, want, MODEL_TOL, "forward")
    # the patches move every position (the tail attends to them), and
    # their positions take nothing of the tokens they replace
    moved = dict(tb, patches=tb["patches"] + 1.0)
    other, _ = tm.forward(tp, moved)
    assert float((other - got).abs().max()) > 1e-4
    toks = dict(tb, tokens=tb["tokens"].clone())
    toks["tokens"][:, :PATCHES] = (toks["tokens"][:, :PATCHES] + 1) % \
        jc.vocab_size
    same, _ = tm.forward(tp, toks)
    assert torch.equal(same, got)


def test_engines_emit_jax_tokens():
    """SimpleEngine and the pipelined ServeEngine (2 stages) emit exactly
    the JAX SimpleEngine's and ServeEngine(backend="scan")'s tokens (text
    prompts: the serving paths carry no patches, in both packages)."""
    jc, jm, jp, tm, tp = _pair(S=2, n_layers=2, seed=3)
    trace = jpoisson_trace(6, rate=1.0, seed=4, prompt_lens=(2, 8),
                           gen_lens=(2, 5), vocab=jc.vocab_size)
    reqs = [Request(q.rid, q.arrival, q.prompt, q.gen_len) for q in trace]
    one = dict(n_stages=1, n_slots=1, max_prefill=1, prompt_budget=8,
               page_seq=32, validate=False)
    want = JSimpleEngine(jm, jp, jserve_plan(jc, **one)).run(trace)
    assert SimpleEngine(tm, tp, serve_plan(tm.cfg, **one)).run(reqs) == want
    kw = dict(n_stages=2, n_slots=3, max_prefill=2, prompt_budget=8,
              page_seq=32)
    want_p = JServeEngine(jm, jp, jserve_plan(jc, **kw),
                          backend="scan").run(trace)
    eng = ServeEngine(tm, tp, serve_plan(tm.cfg, **kw))
    assert eng.run(reqs) == want_p
    assert eng.n_waves > 1 and eng.n_lanes > 1


def test_stream_ticks_with_patches_match_jax():
    """2(S-1)+1 SpecTrain ticks on 2 stages, every batch carrying
    patches: the tick embeds them (its forward) and the embedding
    backward of the batch it reads back from the ring takes none of the
    patch positions' tokens, as JAX's does.  Every loss and every
    params and momentum leaf as JAX's."""
    S = 2
    jc, jm, jp, tm, tp = _pair(S=S, n_layers=S, seed=5)
    bs = _batches(jc, 2 * (S - 1) + 1, seed=6)
    ts = tps.make_state(tm, tp, bs[0], mode="spectrain")
    assert ts["batch_ring"]["patches"].dtype == torch.float32
    tstep = tps.make_train_step(tm, mode="spectrain", lr=LR)
    sds = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       bs[0])
    js = jps.make_state(jm, jp, sds, mode="spectrain")
    jstep = jax.jit(jps.make_train_step(jm, mode="spectrain", lr=LR))
    tl, jl = [], []
    for b in bs:
        ts, met = tstep(ts, b)
        js, jmet = jstep(js, b)
        tl.append((float(met["loss"]), met["loss_valid"]))
        jl.append((float(jmet["loss"]), float(jmet["loss_valid"])))
    assert [v for _, v in tl] == [v for _, v in jl]
    np.testing.assert_allclose([x for x, _ in tl], [x for x, _ in jl],
                               rtol=LOSS_RTOL)
    _close_trees(ts["params"], js["params"], "params")
    _close_trees(ts["momentum"], js["momentum"], "momentum")
    assert float(ts["momentum"]["outer"]["embed"]["tok"].abs().max()) > 0


def test_launchers_run_pixtral_smoke_on_cpu(capsys):
    for engine in ("simple", "pipelined"):
        rc = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--engine", engine, "--requests", "3"])
        assert rc == 0
    rc = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--pipe", "2", "--layers", "2", "--steps", "3",
                      "--log-every", "1"])
    assert rc == 0
