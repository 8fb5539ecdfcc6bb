"""The port's encoder-decoder models (whisper-base with audio frames, the
paper's transformer-paper with source tokens) against the JAX package's,
run live.

Everything runs on the CPU in fp32 at JAX's smoke size (d_model 64, 4
heads of 16, 2 encoder and 2 decoder layers), inputs drawn with numpy
from seeds; weights are the JAX model's, carried over by
``from_jax_params``.  On the CPU the flash wrappers compute their plain
versions (``kernels/ref.py``): cross-attention is one non-causal flash
call with sq != sk, whose backward is ``flash_bwd_ref``; the card's
kernels are held to the same plain versions by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.

Tolerances and why:

* ``sinusoidal_pos`` within 1e-6 (one fp32 sin / cos of the same angle);
* cross-attention and a decoder block within 2e-5, the port's fp32
  attention tolerance (the same arithmetic in another order);
* encoder output, cross K/V, logits, losses and decode steps within 1e-4
  (several layers of it);
* gradients and one SGD step within rtol 1e-4 / atol 1e-5, the training
  tests' state tolerance;
* engine tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.layers import init_params as jinit_params
from repro.optim import sgd as jsgd
from repro.planner import serve_plan as jserve_plan
from repro.serve import SimpleEngine as JSimpleEngine
from repro.serve import poisson_trace as jpoisson_trace
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import Model, from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import sgd as tsgd
from repro_torch.planner import serve_plan
from repro_torch.serve import Request, ServeEngine, SimpleEngine
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401

ATTN_TOL, MODEL_TOL = 2e-5, 1e-4
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
ARCHS = ("whisper-base", "transformer-paper")
LR = 0.05


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol, what="", rtol=None):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol,
        rtol=tol if rtol is None else rtol, err_msg=what)


def _pair(arch, seed=0):
    """JAX's smoke config of ``arch`` in fp32: (JAX cfg, JAX model, JAX
    params, port model on the CPU, the same params in the port)."""
    jc = tiny_cfg(arch, n_layers=2, pipe=1)
    jm = JModel(jc)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = Model(port_cfg(jc), device="cpu")
    return jc, jm, jp, tm, from_jax_params(_np(jp), tm.cfg, device="cpu")


def _batch(cfg, seed, b=2, s=8, frames=12, src=5):
    """Tokens and targets [b, s]; audio frames [b, frames, d] or source
    tokens [b, src] (the encoder's input, of another length than the
    decoder's)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
           "targets": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (b, frames, cfg.d_model)).astype(np.float32)
    else:
        out["src_tokens"] = rng.integers(0, cfg.vocab_size, (b, src))
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_trees_equal_jax(arch):
    t, j = tconfigs.get_config(arch), jget_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert dataclasses.asdict(tconfigs.smoke_config(t)) == \
        dataclasses.asdict(jsmoke_config(j))
    tm, jm = Model(t, device="cpu"), JModel(j)
    assert tm.n_stages == jm.n_stages == 1
    got = [(sp.shape, sp.axes) for sp in tree_leaves(tm.param_specs())]
    want = [(s.shape, s.axes) for s in jax.tree.leaves(
        jm.param_specs(), is_leaf=jlayers.is_spec)]
    assert got == want
    assert sorted(tm.param_specs()["stages"]) == ["dec", "enc"]
    assert "ln_f_enc" in tm.param_specs()["outer"]


@pytest.mark.parametrize("seq,d,offset", [(20, 512, 0), (1500, 512, 0),
                                          (7, 64, 33), (1, 16, 447)])
def test_sinusoidal_pos_matches_jax(seq, d, offset):
    want = jlayers.sinusoidal_pos(seq, d, offset)
    got = tlayers.sinusoidal_pos(seq, d, offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
    _close(got, want, 1e-6)


# ------------------------------------------------------- cross-attention
# (arch, heads over KV heads): the sinusoidal enc-dec, and a rope model at
# G 2 (the JAX twin ropes neither side when kv_input is given)
XATTN_CASES = [("whisper-base", 4, 4), ("granite-8b", 4, 2)]


@pytest.mark.parametrize("arch,H,KV", XATTN_CASES)
def test_gqa_apply_with_kv_input_matches_jax(arch, H, KV):
    jc = jsmoke_config(jget_config(arch)).replace(
        n_heads=H, n_kv_heads=KV, param_dtype="float32",
        compute_dtype="float32")
    p = jinit_params(jattn.gqa_specs(jc), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, jc.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 14, jc.d_model)).astype(np.float32)
    want, _ = jattn.gqa_apply(jc, p, jnp.asarray(x), causal=False,
                              kv_input=jnp.asarray(src))
    got, cache = tattn.gqa_apply(port_cfg(jc), _t(p), torch.from_numpy(x),
                                 causal=False,
                                 kv_input=torch.from_numpy(src))
    assert cache is None
    _close(got, want, ATTN_TOL)


def test_block_apply_with_enc_out_matches_jax():
    jc = tiny_cfg("whisper-base", n_layers=2, pipe=1)
    p = jinit_params(jtransformer.block_specs(jc, cross=True),
                     jax.random.PRNGKey(5))
    assert {"lnx", "xattn"} <= set(p)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, jc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 11, jc.d_model)).astype(np.float32)
    want, _, _, _ = jtransformer.block_apply(jc, p, jnp.asarray(x),
                                             enc_out=jnp.asarray(enc))
    tc = port_cfg(jc)
    got, aux, _, _ = ttransformer.block_apply(tc, _t(p), torch.from_numpy(x),
                                              enc_out=torch.from_numpy(enc))
    assert aux is None
    _close(got, want, ATTN_TOL)
    # the serving form: the same cross K/V given precomputed
    kv = tattn.cross_kv(tc, _t(p)["xattn"], torch.from_numpy(enc))
    again, _, _, _ = ttransformer.block_apply(tc, _t(p), torch.from_numpy(x),
                                              cross_kv=kv)
    _close(again, got, ATTN_TOL)
    with pytest.raises(ValueError, match="enc_out or cross_kv"):
        ttransformer.block_apply(tc, _t(p), torch.from_numpy(x))


# ------------------------------------------------------------- the models
@pytest.mark.parametrize("arch", ARCHS)
def test_encode_prefill_cache_forward_and_loss_match_jax(arch):
    jc, jm, jp, tm, tp = _pair(arch, seed=1)
    batch = _batch(jc, 2)
    jbatch, tbatch = _jb(batch), _tb(batch)
    _close(tm.encode(tp, tbatch), jax.jit(jm.encode)(jp, jbatch),
           MODEL_TOL, "encode")
    want = jax.jit(jm.encdec_prefill_cache, static_argnums=2)(jp, jbatch, 16)
    got = tm.encdec_prefill_cache(tp, tbatch, 16)
    for part in ("self", "cross"):
        for k in ("k", "v"):
            assert tuple(got[part][k].shape) == want[part][k].shape
            _close(got[part][k], want[part][k], MODEL_TOL, f"{part} {k}")
    jl, jaux = jax.jit(jm.forward)(jp, jbatch)
    tl, taux = tm.forward(tp, tbatch)
    _close(tl, jl, MODEL_TOL, "logits")
    assert float(taux) == float(jaux) == 0.0
    _close(tm.loss(tp, tbatch), jax.jit(jm.loss)(jp, jbatch), MODEL_TOL,
           "loss")


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_and_one_sgd_step_match_jax(arch):
    """``Model.loss`` backward (cross-attention through the flash
    backward's plain version), then one momentum-SGD step through
    ``optim.sgd`` (``fused_update``'s plain version on the CPU), against
    ``jax.grad`` and the JAX ``sgd.update``."""
    jc, jm, jp, tm, tp = _pair(arch, seed=3)
    batch = _batch(jc, 4)
    jbatch, tbatch = _jb(batch), _tb(batch)
    jg = jax.jit(jax.grad(jm.loss))(jp, jbatch)
    leaves = tree_map(lambda _, a: a.detach().clone().requires_grad_(), tp)
    loss = tm.loss(leaves, tbatch)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat)
    jflat = jax.tree.leaves(jg)
    assert len(grads) == len(jflat)
    for i, (g, w) in enumerate(zip(grads, jflat)):
        _close(g, w, STATE_ATOL, f"grad leaf {i}", rtol=STATE_RTOL)
    # the cross-attention weights got a gradient
    xg = jg["stages"]["dec"]["xattn"]["wk"]
    assert float(jnp.abs(xg).max()) > 0
    jp2, jst = jsgd.update(jp, jsgd.init(jp), jg, lr=LR)
    params = tree_map(lambda _, a: a.detach().clone(), tp)
    it = iter(grads)
    g_tree = tree_map(lambda _, a: next(it), params)
    st = tsgd.init(params)
    tsgd.update(params, st, g_tree, lr=LR)
    for i, (a, b) in enumerate(zip(tree_leaves(params),
                                   jax.tree.leaves(jp2))):
        _close(a, b, STATE_ATOL, f"param leaf {i}", rtol=STATE_RTOL)
    for i, (a, b) in enumerate(zip(tree_leaves(st.v),
                                   jax.tree.leaves(jst.v))):
        _close(a, b, STATE_ATOL, f"momentum leaf {i}", rtol=STATE_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("start", ["encdec_prefill_cache", "init_cache"])
def test_decode_steps_match_jax(arch, start):
    """Decode steps from ``encdec_prefill_cache`` (the encoded input's
    cross K/V) and from ``init_cache`` (the zero cross cache of 1500
    frames), logits and caches against JAX's ``decode_step``; from the
    encoded input the steps also reproduce ``forward``'s logits at every
    position (JAX's ``test_decode_matches_forward``)."""
    jc, jm, jp, tm, tp = _pair(arch, seed=5)
    batch = _batch(jc, 6, s=6)
    T = batch["tokens"].shape[1]
    if start == "init_cache":
        jcache, tcache = jm.init_cache(2, T), tm.init_cache(2, T)
        assert tuple(tcache["cross"]["k"].shape) == \
            (jc.n_layers, 2, tmodel.WHISPER_ENC_FRAMES, jc.n_kv_heads,
             jc.hd)
    else:
        jcache = jm.encdec_prefill_cache(jp, _jb(batch), T)
        tcache = tm.encdec_prefill_cache(tp, _tb(batch), T)
        full, _ = tm.forward(tp, _tb(batch))
    step = jax.jit(jm.decode_step)
    for t in range(T):
        tok = batch["tokens"][:, t:t + 1]
        jl, jcache = step(jp, jcache, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(t, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), t)
        _close(tl, jl, MODEL_TOL, f"step {t}")
        if start != "init_cache":
            _close(tl[:, 0], full[:, t], MODEL_TOL, f"vs forward {t}")
    for part in ("self", "cross"):
        for k in ("k", "v"):
            _close(tcache[part][k], jcache[part][k], MODEL_TOL, part + k)


@pytest.mark.parametrize("arch", ARCHS)
def test_simple_engine_tokens_equal_jax(arch):
    jc, jm, jp, tm, tp = _pair(arch, seed=7)
    trace = jpoisson_trace(5, rate=1.0, seed=3, prompt_lens=(2, 8),
                           gen_lens=(2, 5), vocab=jc.vocab_size)
    reqs = [Request(q.rid, q.arrival, q.prompt, q.gen_len) for q in trace]
    kw = dict(n_stages=1, n_slots=1, max_prefill=1, prompt_budget=8,
              page_seq=32, validate=False)
    want = JSimpleEngine(jm, jp, jserve_plan(jc, **kw)).run(trace)
    eng = SimpleEngine(tm, tp, serve_plan(tm.cfg, **kw))
    assert eng.run(reqs) == want
    assert eng.n_prefill == 1 + len(reqs)


def test_prefill_equals_jax_stepped_decode():
    """``Model.prefill`` runs the prompt in one causal call a layer; the
    JAX SimpleEngine steps ``decode_step`` over it from ``init_cache``:
    the logits at every position and the filled self cache agree."""
    jc, jm, jp, tm, tp = _pair("whisper-base", seed=8)
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, (1, 7))
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 16)
    jcache = jm.init_cache(1, 16)
    step = jax.jit(jm.decode_step)
    for t in range(toks.shape[1]):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.asarray(t, jnp.int32))
        _close(tl[:, t], jl[:, 0], MODEL_TOL, f"position {t}")
    for part in ("self", "cross"):
        for k in ("k", "v"):
            _close(tcache[part][k], jcache[part][k], MODEL_TOL, part + k)


def test_decode_embed_adds_the_sinusoidal_term_as_jax():
    """``decode_embed`` at per-row positions (a wave's [R, 1], a lane's
    [1, n]) adds the sinusoidal term at each position, as JAX's does."""
    jc, jm, jp, tm, tp = _pair("whisper-base", seed=18)
    rng = np.random.default_rng(19)
    for shape, pos in (((3, 1), np.array([[0], [7], [30]])),
                       ((1, 5), np.arange(5)[None])):
        toks = rng.integers(0, jc.vocab_size, shape)
        want = jm.decode_embed(jp["outer"], jnp.asarray(toks),
                               jnp.asarray(pos, jnp.int32))
        got = tm.decode_embed(tp["outer"], torch.from_numpy(toks),
                              torch.from_numpy(pos))
        _close(got, want, 1e-5)


# -------------------------------------- three behaviours of the reference
def test_jax_encoder_is_causal_and_the_port_keeps_it():
    """JAX's ``encode`` runs ``_layer_body``, whose ``block_apply`` keeps
    ``causal=True``: changing the last source token changes only the last
    encoder position (a bidirectional encoder would move them all).  The
    port follows it."""
    jc, jm, jp, tm, tp = _pair("transformer-paper", seed=10)
    batch = _batch(jc, 11)
    other = dict(batch)
    other["src_tokens"] = batch["src_tokens"].copy()
    other["src_tokens"][:, -1] = (other["src_tokens"][:, -1] + 1) % \
        jc.vocab_size
    enc = jax.jit(jm.encode)
    for e1, e2 in ((enc(jp, _jb(batch)), enc(jp, _jb(other))),
                   (tm.encode(tp, _tb(batch)), tm.encode(tp, _tb(other)))):
        d = np.abs(np.asarray(e1) - np.asarray(e2)).max(axis=(0, 2))
        assert d[:-1].max() <= 1e-6 and d[-1] > 1e-3, d
    _close(tm.encode(tp, _tb(other)), enc(jp, _jb(other)), MODEL_TOL)


def test_jax_simple_engine_never_runs_the_encoder():
    """JAX's ``init_cache`` holds an all-zero cross cache, and its
    SimpleEngine decodes from it: the cross term adds exactly 0, so
    served tokens depend on no encoder input, nor on the cross weights.
    The port's prefill and decode keep this (bit for bit)."""
    jc, jm, jp, tm, tp = _pair("whisper-base", seed=12)
    jcache = jm.init_cache(1, 16)
    assert float(jnp.abs(jcache["cross"]["k"]).max()) == 0.0
    assert float(jnp.abs(jcache["cross"]["v"]).max()) == 0.0
    rng = np.random.default_rng(13)
    jother = jax.tree.map(lambda a: a, jp)
    jother["stages"]["dec"]["xattn"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jp["stages"]["dec"]["xattn"])
    tother = from_jax_params(_np(jother), tm.cfg, device="cpu")
    tok = jnp.asarray([[3]], jnp.int32)
    pos = jnp.asarray(0, jnp.int32)
    step = jax.jit(jm.decode_step)
    a, _ = step(jp, jm.init_cache(1, 16), tok, pos)
    b, _ = step(jother, jm.init_cache(1, 16), tok, pos)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    toks = {"tokens": torch.from_numpy(rng.integers(0, jc.vocab_size,
                                                    (1, 6)))}
    l1, c1 = tm.prefill(tp, toks, 16)
    l2, c2 = tm.prefill(tother, toks, 16)
    assert torch.equal(l1, l2)
    assert float(c1["cross"]["k"].abs().max()) == 0.0
    d1, _ = tm.decode_step(tp, c1, toks["tokens"][:, :1], 6)
    d2, _ = tm.decode_step(tother, c2, toks["tokens"][:, :1], 6)
    assert torch.equal(d1, d2)


def test_decode_attends_every_cross_key_unmasked():
    """JAX's ``_decode_encdec`` attends over every cached cross key with
    no length mask (with ``init_cache``, 1500 zero keys): keys written
    past the encoded frames move the result.  The port's decode step
    does the same, and agrees with JAX's either way."""
    jc, jm, jp, tm, tp = _pair("whisper-base", seed=14)
    batch = _batch(jc, 15, s=4, frames=6)
    jcache = jax.jit(jm.encdec_prefill_cache, static_argnums=2)(
        jp, _jb(batch), 8)
    rng = np.random.default_rng(16)
    extra = rng.standard_normal((jc.n_layers, 2, 4, jc.n_kv_heads,
                                 jc.hd)).astype(np.float32)
    longer = {"self": jcache["self"], "cross": {
        k: jnp.concatenate([jcache["cross"][k], jnp.asarray(extra)], 2)
        for k in ("k", "v")}}
    tok = batch["tokens"][:, :1]
    outs = []
    step = jax.jit(jm.decode_step)
    for cache in (jcache, longer):
        jl, _ = step(jp, cache, jnp.asarray(tok, jnp.int32),
                     jnp.asarray(0, jnp.int32))
        tl, _ = tm.decode_step(tp, _t(cache), torch.from_numpy(tok), 0)
        _close(tl, jl, MODEL_TOL)
        outs.append(np.asarray(jl))
    assert np.abs(outs[0] - outs[1]).max() > 1e-3


# ------------------------------------------------------------- refusals
def test_refusals():
    """The pipelined engine and the train launcher refuse enc-dec
    models, as JAX's do; the recurrent family stays refused (its
    reference model does not exist); enc-dec stacks are no stages."""
    jc, jm, jp, tm, tp = _pair("whisper-base", seed=17)
    splan = serve_plan(tm.cfg, n_stages=1, n_slots=2, prompt_budget=8,
                       page_seq=32, validate=False)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServeEngine(tm, tp, splan)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tm.stage_apply({"layers": tp["stages"]["dec"]},
                       (torch.zeros(1, 2, jc.d_model), torch.zeros(())))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tm.partition_stage_params(tp["stages"], (2,))
    with pytest.raises(RuntimeError, match="forward"):
        tm.embed(tp["outer"], {"tokens": torch.zeros(1, 2, dtype=int)})
    with pytest.raises(SystemExit, match="encoder-decoder"):
        ttrain.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                     "--pipe", "1", "--steps", "1"])
    with pytest.raises(SystemExit, match="not per-layer pageable"):
        tserve.main(["--arch", "transformer-paper", "--smoke", "--device",
                     "cpu", "--engine", "pipelined"])
    with pytest.raises(NotImplementedError, match="family 'rnn'"):
        Model(tconfigs.get_config("residual-lstm-paper"), device="cpu")


def test_launcher_serves_encdec_smoke_on_cpu(capsys):
    for arch in ARCHS:
        rc = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3"])
        assert rc == 0
        assert "engine=simple" in capsys.readouterr().out


# ------------------------------------------- cache axes and input specs
def _dict_leaves(tree) -> list:
    """The leaves of nested dicts in sorted key order (the cache's
    ``ShapeDtype`` tuples are leaves here)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _dict_leaves(tree[k])]
    return [tree]


SHAPES = [("train", 4096, 256), ("prefill", 32768, 32),
          ("decode", 32768, 128), ("decode", 524288, 1)]


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b",
                                  "granite-8b", "minicpm3-4b", "rwkv6-7b",
                                  "zamba2-1.2b"])
def test_cache_axes_input_specs_and_cache_specs_match_jax(arch):
    from repro.configs.base import ShapeConfig
    from repro.models import model as jmodel
    from repro.runtime import sharding as jsh
    from repro_torch.runtime import sharding as rsh
    from test_torch_dp import _FakeMesh, _grid, _jax_mesh
    tcfg, jcfg = tconfigs.get_config(arch), jget_config(arch)
    assert tmodel.cache_axes(Model(tcfg, device="cpu")) == \
        jmodel.cache_axes(JModel(jcfg))
    for kind, seq, gb in SHAPES:
        shape = ShapeConfig(f"{kind}-{seq}", seq, gb, kind)
        got = tmodel.input_specs(tcfg, shape)
        want = jmodel.input_specs(jcfg, shape)
        assert sorted(got) == sorted(want)
        if kind != "decode":
            for k, sd in want["batch"].items():
                assert got["batch"][k].shape == sd.shape, k
                assert (got["batch"][k].dtype.is_floating_point
                        == jnp.issubdtype(sd.dtype, jnp.floating))
            continue
        gl = _dict_leaves(got["cache"])
        wl = jax.tree.leaves(want["cache"])
        assert [tuple(a.shape) for a in gl] == [a.shape for a in wl]
        assert [a.dtype == torch.bfloat16 for a in gl] == \
            [a.dtype == jnp.bfloat16 for a in wl]
        assert got["token"].shape == want["token"].shape
        for gid in ("sizes-16x4x4", "smoke-refined"):
            mesh, names, mshape = _grid(gid, "granite-8b")
            jmesh = _jax_mesh(names, mshape)
            rules = rsh.decode_rules(tcfg, mesh, global_batch=gb)
            assert rules == jsh.decode_rules(jcfg, _FakeMesh(names, mshape),
                                             global_batch=gb)
            specs = rsh.cache_specs(tcfg, got["cache"], mesh, rules)
            jspecs = jsh.cache_specs(jcfg, want["cache"], jmesh, rules)
            assert specs == jax.tree.map(lambda s: tuple(s.spec), jspecs)
