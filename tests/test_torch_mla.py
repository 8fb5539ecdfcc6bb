"""The port's multi-head latent attention (MLA) and the MLA model
(minicpm3-4b) against the JAX package's, run live.

Everything runs on the CPU in fp32 at JAX's ``smoke_config("minicpm3-4b")``
(d_model 64, 4 heads, q rank 32, kv rank 16, q.k width 16 + 8, v width
16), inputs drawn with numpy from seeds; weights are the JAX model's (or
layer's), carried over by ``from_jax_params``.  On the CPU the flash
wrappers compute their plain versions (``kernels/ref.py``), which take
any (q.k, v) widths; the card's kernels take (96, 64) and are held to the
same plain versions by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerances and why:

* attention and the layer within 2e-5: the same fp32 arithmetic in
  another order (one q.k product over the concatenated nope | rope dims
  against the JAX twin's two summed einsums; the flash plain version's
  fp32 softmax against ``jax.nn.softmax``), the port's fp32 tolerance;
* whole-model logits within 1e-4 (several layers of it);
* the streaming SpecTrain ticks as ``tests/test_torch_train.py`` holds
  them: every state leaf within rtol 1e-4 / atol 1e-5;
* engine tokens exact.
"""
import dataclasses
import math

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
from repro.models import attention as jattn
from repro.models.layers import init_params as jinit_params
from repro.planner import serve_plan as jserve_plan
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SimpleEngine as JSimpleEngine
from repro.serve import poisson_trace as jpoisson_trace
from repro_torch import configs as tconfigs
from repro_torch.core import pipeline_stream as tps
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch import serve as tlaunch
from repro_torch.models import Model, from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.planner import serve_plan
from repro_torch.serve import Request, ServeEngine, SimpleEngine
from test_torch_model import port_cfg
from test_torch_train import _batches, _close_trees
from test_torch_threads import one_thread  # noqa: F401

ATTN_TOL, MODEL_TOL = 2e-5, 1e-4
LOSS_RTOL = 1e-5
LR = 0.05
ARCH = "minicpm3-4b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


def _layer(seed=0):
    """JAX's smoke MLA config in fp32 (JAX, port) and one layer's
    attention weights drawn by JAX."""
    jc = jsmoke_config(jget_config(ARCH)).replace(
        param_dtype="float32", compute_dtype="float32")
    p = jinit_params(jattn.mla_specs(jc), jax.random.PRNGKey(seed))
    return jc, port_cfg(jc), p


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def test_minicpm3_config_builds_in_the_port():
    t, j = tconfigs.get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count() == 4_073_492_480
    s, js = tconfigs.smoke_config(t), jsmoke_config(j)
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    m = s.mla
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim) == (32, 16, 16, 8, 16)
    layer = Model(s, device="cpu").param_specs()["stages"][0]["layers"]
    assert sorted(layer["attn"]) == ["kv_norm", "q_norm", "w_dkv", "w_dq",
                                     "w_ukv", "w_uq", "wo"]
    assert layer["attn"]["w_ukv"].shape == (s.n_layers, 16, 4 * (16 + 16))
    # full depth 8 of 62 layers: the training configuration's parameters
    assert t.replace(n_layers=8).param_count() == 689_377_280


def test_mla_whole_sequence_at_an_offset_matches_jax():
    jc, tc, p = _layer(0)
    x = _x(1, 2, 7, jc.d_model)
    want, _ = jattn.mla_apply(jc, p, jnp.asarray(x), pos_offset=3)
    got, cache = tattn.mla_apply(tc, _t(p), torch.from_numpy(x),
                                 pos_offset=3)
    assert cache is None
    _close(got, want, ATTN_TOL)


def test_mla_prefill_returns_jax_latents():
    jc, tc, p = _layer(2)
    x = _x(3, 2, 6, jc.d_model)
    jcache = jattn.mla_init_cache(jc, 2, 16, jnp.float32)
    want, wc = jattn.mla_apply(jc, p, jnp.asarray(x), cache=jcache)
    got, tc_ = tattn.mla_apply(tc, _t(p), torch.from_numpy(x), cache={})
    _close(got, want, ATTN_TOL, "out")
    assert sorted(tc_) == sorted(wc) == ["c_kv", "k_rope"]
    for k in wc:          # the raw latents: unnormed, unroped
        _close(tc_[k], wc[k], ATTN_TOL, k)


def test_mla_decode_step_matches_jax_and_updates_the_cache():
    """A decode step at pos 5 over a 16-position cache whose every slot
    holds random latents: JAX expands all 16 and masks positions past 5,
    the port expands positions [0, 5] only; outputs and the updated cache
    agree, and the port's cache is updated in place."""
    jc, tc, p = _layer(4)
    rng = np.random.default_rng(5)
    b, S, pos = 2, 16, 5
    cache = {"c_kv": rng.standard_normal((b, S, 16)).astype(np.float32),
             "k_rope": rng.standard_normal((b, S, 8)).astype(np.float32)}
    x = _x(6, b, 1, jc.d_model)
    want, wc = jattn.mla_apply(jc, p, jnp.asarray(x),
                               cache=jax.tree.map(jnp.asarray, cache),
                               pos=pos)
    tcache = _t(cache)
    got, out_cache = tattn.mla_apply(tc, _t(p), torch.from_numpy(x),
                                     cache=tcache, pos=pos)
    assert out_cache is tcache
    _close(got, want, ATTN_TOL, "out")
    for k in wc:
        _close(tcache[k], wc[k], ATTN_TOL, k)
    # the tail past pos does not move the result
    tcache["c_kv"][:, pos + 1:] = 1e3
    again, _ = tattn.mla_apply(tc, _t(p), torch.from_numpy(x), cache=tcache,
                               pos=pos)
    _close(again, got, ATTN_TOL, "tail")


def test_jax_blocked_branch_against_the_flash_plain_version():
    """At s = 1449 (s * s >= 2**21) the JAX twin runs ``blocked_attention``
    on the concatenated q and k; the port runs the flash plain version at
    widths (24, 16) for every s."""
    jc, tc, p = _layer(7)
    s = 1449
    assert jattn._use_blocked(s, s) and not jattn._use_blocked(s - 1,
                                                               s - 1)
    x = _x(8, 1, s, jc.d_model)
    want, _ = jattn.mla_apply(jc, p, jnp.asarray(x))
    got, _ = tattn.mla_apply(tc, _t(p), torch.from_numpy(x))
    _close(got, want, ATTN_TOL)


def _jax_mla_attention(q, k, v, *, causal, kv_len=None, nope=16):
    """JAX ``mla_apply``'s einsum attention (attention.py:222-231 for the
    sequence, :190-198 for a decode step's key mask) on concatenated q, k
    [b, s, H, nope + rope] (k_rope already broadcast) and v."""
    scores = (jnp.einsum("bqhd,bshd->bhqs", q[..., :nope], k[..., :nope])
              + jnp.einsum("bqhd,bshd->bhqs", q[..., nope:], k[..., nope:]))
    scores = scores.astype(jnp.float32) / math.sqrt(q.shape[-1])
    sq, sk = q.shape[1], k.shape[1]
    mask = jnp.ones((sq, sk), bool)
    if causal:
        mask = jnp.tril(mask)
    if kv_len is not None:
        mask = mask & (jnp.arange(sk)[None, :] < kv_len)
    scores = jnp.where(mask[None, None], scores, -1e30)
    probs = jax.nn.softmax(scores, -1).astype(q.dtype)
    return jnp.einsum("bhqs,bshd->bqhd", probs, v)


# b, sq, sk, H, q.k width (nope + rope), v width, causal, kv_len: the
# smoke dims (24, 16), the card's pair (96, 64), a decode row
SPLIT_CASES = [
    (2, 9, 9, 4, 24, 16, True, None),
    (1, 20, 20, 3, 96, 64, True, None),
    (2, 1, 13, 4, 24, 16, False, 6),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_flash_plain_versions_at_split_widths_match_jax_vjp(case):
    b, sq, sk, H, dk, dv, causal, kv_len = case
    rng = np.random.default_rng(sum(case[:6]))
    q = rng.standard_normal((b, sq, H, dk)).astype(np.float32)
    k = rng.standard_normal((b, sk, H, dk)).astype(np.float32)
    v = rng.standard_normal((b, sk, H, dv)).astype(np.float32)
    do = rng.standard_normal((b, sq, H, dv)).astype(np.float32)
    nope = dk * 2 // 3
    fn = lambda q_, k_, v_: _jax_mla_attention(q_, k_, v_, causal=causal,
                                               kv_len=kv_len, nope=nope)
    o_j, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=causal, kv_len=kv_len)
    o, lse = ref.flash_fwd_ref(tq, tk, tv, **kw)
    assert o.shape == (b, sq, H, dv)
    _close(o, o_j, ATTN_TOL, "o")
    dq, dk_, dv_ = ref.flash_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    for got, want, nm in ((dq, dq_j, "dq"), (dk_, dk_j, "dk"),
                          (dv_, dv_j, "dv")):
        _close(got, want, ATTN_TOL, nm)
    # the wrappers on the CPU compute the same plain versions
    o_w, _ = fa.flash_fwd(tq, tk, tv, **kw)
    assert torch.equal(o_w, o)
    # and the port's einsum reference (the JAX twin's form)
    cfg = tconfigs.smoke_config(tconfigs.get_config(ARCH)).replace(
        mla=tconfigs.MLAConfig(qk_nope_head_dim=nope,
                               qk_rope_head_dim=dk - nope, v_head_dim=dv))
    _close(tattn.mla_attend_ref(cfg, tq, tk, tv, causal=causal,
                                k_valid_len=kv_len), o_j, ATTN_TOL, "ref")


def test_flash_width_pairs_are_checked_on_the_card_only():
    """The card's kernels take the pairs of ``WIDTH_PAIRS`` and raise
    naming any other; the CPU path takes any widths."""
    assert (96, 64) in fa.WIDTH_PAIRS and (24, 16) not in fa.WIDTH_PAIRS
    for pair in fa.WIDTH_PAIRS:
        fa.check_widths(*pair)
    for pair in ((24, 16), (96, 96), (64, 96), (8, 8)):
        with pytest.raises(ValueError, match=rf"\(q\.k {pair[0]}, v "
                                             rf"{pair[1]}\)"):
            fa.check_widths(*pair)
    q = torch.zeros(1, 3, 2, 24)
    o, lse = fa.flash_fwd(q, q, torch.zeros(1, 3, 2, 16), causal=True)
    assert o.shape == (1, 3, 2, 16) and lse.shape == (1, 2, 3)


# ---------------------------------------------------------------------------
# the MLA model


def _model_pair(*, S=1, n_layers=2, seed=0):
    jc = tiny_cfg(ARCH, n_layers=n_layers, pipe=S)
    jm = JModel(jc)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = Model(port_cfg(jc), device="cpu")
    tp = from_jax_params(_np(jp), tm.cfg, device="cpu")
    return jc, jm, jp, tm, tp


def test_mla_model_logits_prefill_and_decode_match_jax():
    jc, jm, jp, tm, tp = _model_pair(n_layers=3, seed=1)
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, (2, 10))
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, MODEL_TOL, "forward")
    # prefill 7 tokens, then decode tokens 7..9
    jl, jcache = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :7])}, 16)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :7])},
                            16)
    assert sorted(tcache["layers"]) == ["c_kv", "k_rope"]
    assert tuple(tcache["layers"]["c_kv"].shape) == (3, 2, 16, 16)
    _close(tl, jl, MODEL_TOL, "prefill")
    step = jax.jit(jm.decode_step)
    for pos in range(7, 10):
        tok = toks[:, pos:pos + 1]
        jl, jcache = step(jp, jcache, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok), pos)
        _close(tl, jl, MODEL_TOL, f"decode {pos}")
    for k in ("c_kv", "k_rope"):
        _close(tcache["layers"][k], jcache["layers"][k], MODEL_TOL, k)


def test_engines_emit_jax_tokens():
    """The port's SimpleEngine and its pipelined ServeEngine (2 stages)
    emit exactly the JAX SimpleEngine's and ServeEngine(backend="scan")'s
    tokens on one seeded trace."""
    jc, jm, jp, tm, tp = _model_pair(S=2, n_layers=2, seed=11)
    trace = jpoisson_trace(6, rate=1.0, seed=2, prompt_lens=(2, 8),
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


def test_spectrain_ticks_match_jax_with_the_tied_embedding():
    """2(S-1)+1 streaming SpecTrain ticks on 2 stages (the last the first
    whose backward is valid on every stage): every loss and every params
    and momentum leaf as JAX's.  minicpm3-4b
    ties its embedding, so ``embed/tok``'s gradient sums the head's and
    the embedding's; its momentum moves from the first valid backward."""
    S = 2
    jc, jm, jp, tm, tp = _model_pair(S=S, n_layers=S, seed=S)
    assert jc.tie_embeddings and "unembed" not in tp["outer"]["embed"]
    bs = _batches(jc, 2 * (S - 1) + 1, batch=2, seq=16)
    ts = tps.make_state(tm, tp, bs[0], mode="spectrain")
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


def test_launcher_serves_minicpm3_smoke_on_cpu(capsys):
    for engine in ("simple", "pipelined"):
        rc = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--engine", engine, "--requests", "3",
                           "--layers", "2"])
        assert rc == 0
        assert "served 3/3 requests" in capsys.readouterr().out
