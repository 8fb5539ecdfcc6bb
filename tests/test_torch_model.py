"""The port's configs, layers and model against the JAX package's.

Inputs are drawn with numpy from a seed; weights are the JAX model's,
carried over by ``repro_torch.models.from_jax_params``.  Everything runs
on the CPU in fp32.  Tolerances: 1e-5 for single layers (same fp32
arithmetic, other summation order), 1e-4 for whole-model logits and
caches (four layers of it).
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
from repro.models import layers as jl
from repro_torch import configs as tconfigs
from repro_torch.models import Model, from_jax_params
from repro_torch.models import layers as tl
from repro_torch.models import model as tmodel
from test_torch_threads import one_thread  # noqa: F401

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4


def port_cfg(jcfg):
    """The port's ArchConfig with every field of a JAX one (dense with GQA
    or MLA, MoE, rwkv6 or mamba2/hybrid)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jcfg)}
    kw["mesh_plan"] = tconfigs.MeshPlan(
        **dataclasses.asdict(jcfg.mesh_plan))
    if jcfg.mla is not None:
        kw["mla"] = tconfigs.MLAConfig(**dataclasses.asdict(jcfg.mla))
    if jcfg.ssm is not None:
        kw["ssm"] = tconfigs.SSMConfig(**dataclasses.asdict(jcfg.ssm))
    if jcfg.moe is not None:
        kw["moe"] = tconfigs.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return tconfigs.ArchConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# configs


@pytest.mark.parametrize("smoke", [False, True])
def test_granite_config_matches_jax(smoke):
    j, t = jget_config("granite-8b"), tconfigs.get_config("granite-8b")
    if smoke:
        j, t = jsmoke_config(j), tconfigs.smoke_config(t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.hd, j.vocab_padded, j.param_count()) == \
        (t.hd, t.vocab_padded, t.param_count())


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(tconfigs.get_config("residual-lstm-paper"), device="cpu")
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


def test_rnn_family_refused():
    """The residual LSTM has no reference model to port (the JAX config
    names a ``models/rnn.py`` the JAX package does not have); its
    dimensions would build dense attention blocks, so the port refuses
    the family by name."""
    from repro_torch.models.transformer import check_ported
    cfg = tconfigs.get_config("residual-lstm-paper")
    assert cfg.family == "rnn"
    for build in (lambda: check_ported(cfg),
                  lambda: Model(cfg, device="cpu"),
                  lambda: Model(tconfigs.smoke_config(cfg), device="cpu")):
        with pytest.raises(NotImplementedError, match="models/rnn.py"):
            build()


# (c) layers


@pytest.fixture(scope="module")
def cfgs():
    j = tiny_cfg("granite-8b", n_kv_heads=2)
    return j, port_cfg(j)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply(cfgs, kind):
    jc, tc = cfgs
    x = _rand(0, 2, 5, jc.d_model) * 3 + 1
    p = {"scale": _rand(1, jc.d_model), "bias": _rand(2, jc.d_model)}
    want = jl.norm_apply(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                         kind)
    got = tl.norm_apply(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), kind)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply(cfgs, gated):
    jc, tc = cfgs
    jc, tc = jc.replace(mlp_gated=gated), tc.replace(mlp_gated=gated)
    d, ff = jc.d_model, jc.d_ff
    p = {"wg": _rand(3, d, ff) / 8, "w1": _rand(4, d, ff) / 8,
         "w2": _rand(5, ff, d) / 8}
    x = _rand(6, 2, 3, d)
    want = jl.mlp_apply(jc, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tl.mlp_apply(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("offset", [0, 29])
def test_apply_rope(cfgs, offset):
    jc, tc = cfgs
    x = _rand(7, 2, 6, jc.n_heads, jc.hd)
    pos = np.arange(6)[None, :] + offset
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jl.rope_freqs(jc))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        tl.rope_freqs(tc))
    _close(tl.rope_freqs(tc), jl.rope_freqs(jc), LAYER_TOL)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_embed_apply(cfgs, dt):
    jc, tc = cfgs
    jc, tc = jc.replace(compute_dtype=dt), tc.replace(compute_dtype=dt)
    tok = _rand(8, jc.vocab_padded, jc.d_model)
    ids = np.random.default_rng(9).integers(0, jc.vocab_size, (2, 7))
    want = jl.embed_apply(jc, {"tok": jnp.asarray(tok)}, jnp.asarray(ids))
    got = tl.embed_apply(tc, {"tok": torch.from_numpy(tok)},
                         torch.from_numpy(ids))
    assert got.dtype == getattr(torch, dt)
    # the same bf16 rounding on both sides: cast first, then scale
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 0)


@pytest.mark.parametrize("tie,softcap", [(False, 0.0), (True, 30.0)])
def test_unembed_apply(cfgs, tie, softcap):
    jc, tc = cfgs
    kw = dict(tie_embeddings=tie, logit_softcap=softcap)
    jc, tc = jc.replace(**kw), tc.replace(**kw)
    V, d = jc.vocab_padded, jc.d_model
    p = {"tok": _rand(10, V, d), "unembed": _rand(11, d, V)}
    x = _rand(12, 2, 3, d)
    want = jl.unembed_apply(jc, jax.tree.map(jnp.asarray, p),
                            jnp.asarray(x))
    got = tl.unembed_apply(tc, {k: torch.from_numpy(v)
                                for k, v in p.items()}, torch.from_numpy(x))
    _close(got, want, 1e-4)


def test_init_distributions(cfgs):
    _, tc = cfgs
    m = Model(tc, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    tok = params["outer"]["embed"]["tok"]
    wq = params["stages"][0]["layers"]["attn"]["wq"]
    assert tok.shape == (tc.vocab_padded, tc.d_model)
    # _fan_in is shape[-2]: std 1/sqrt(V) for the embedding table
    assert abs(float(tok.std()) * np.sqrt(tc.vocab_padded) - 1) < 0.02
    assert abs(float(wq.std()) * np.sqrt(tc.d_model) - 1) < 0.05
    assert torch.equal(params["outer"]["ln_f"]["scale"],
                       torch.ones(tc.d_model))
    assert tuple(int(s["layers"]["ln1"]["scale"].shape[0])
                 for s in params["stages"]) == m.stage_sizes
    again = m.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["outer"]["embed"]["tok"], tok)
    cast = m.init(torch.Generator().manual_seed(0), dtype="bfloat16")
    assert cast["outer"]["embed"]["tok"].dtype == torch.bfloat16
    assert cast["outer"]["ln_f"]["scale"].dtype == torch.float32


def test_stage_helpers():
    assert tmodel.uniform_stage_sizes(7, 3) == (3, 2, 2)
    with pytest.raises(ValueError):
        tmodel.uniform_stage_sizes(2, 3)
    flat = {"layers": {"w": torch.arange(7.0)[:, None]}}
    stages = tmodel.split_flat_stages(flat, (3, 2, 2))
    assert [int(s["layers"]["w"].shape[0]) for s in stages] == [3, 2, 2]
    merged = tmodel.flat_stage_layers(stages)
    assert torch.equal(merged["w"], flat["layers"]["w"])


# (d) the whole model, with the JAX weights


@pytest.fixture(scope="module")
def models(cfgs):
    jc, tc = cfgs
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tc, device="cpu")
    return jm, jp, tm, from_jax_params(_np(jp), tc, device="cpu")


@pytest.mark.parametrize("b,s", [(1, 8), (2, 5)])
def test_prefill_matches_jax(models, b, s):
    jm, jp, tm, tp = models
    toks = np.random.default_rng(13).integers(0, jm.cfg.vocab_size, (b, s))
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, 32)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32)
    assert lt.shape == (b, s, jm.cfg.vocab_padded)
    _close(lt, lj, MODEL_TOL)
    for name in ("k", "v"):
        assert ct["layers"][name].shape == cj["layers"][name].shape
        _close(ct["layers"][name], cj["layers"][name], MODEL_TOL)


def test_decode_steps_match_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(14)
    prompt = rng.integers(0, jm.cfg.vocab_size, (1, 5))
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)}, 16)
    _, ct = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, 16)
    decode = jax.jit(jm.decode_step)
    for pos in range(5, 9):
        tok = rng.integers(0, jm.cfg.vocab_size, (1, 1))
        lj, cj = decode(jp, cj, jnp.asarray(tok, jnp.int32),
                        jnp.asarray(pos, jnp.int32))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(tok), pos)
        assert lt.shape == (1, 1, jm.cfg.vocab_padded)
        _close(lt, lj, MODEL_TOL)
        for name in ("k", "v"):
            _close(ct["layers"][name], cj["layers"][name], MODEL_TOL)


def test_prefill_then_decode_matches_longer_prefill(models):
    """The decode step at position n reproduces the causal prefill's
    row n (the property that lets the engine prefill in one call)."""
    _, _, tm, tp = models
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, tm.cfg.vocab_size, (1, 6)))
    full, cfull = tm.prefill(tp, {"tokens": toks}, 16)
    _, cache = tm.prefill(tp, {"tokens": toks[:, :5]}, 16)
    last, cache = tm.decode_step(tp, cache, toks[:, 5:], 5)
    _close(last[0, 0], full[0, 5], MODEL_TOL)
    _close(cache["layers"]["k"], cfull["layers"]["k"], MODEL_TOL)


def test_from_jax_params_layout(models, cfgs):
    jm, jp, _, tp = models
    assert len(tp["stages"]) == len(jp["stages"]) == jm.n_stages
    got = tmodel.cast_for_compute(from_jax_params(_np(jp), cfgs[1],
                                                  device="cpu"),
                                  torch.bfloat16)
    wq = got["stages"][1]["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert got["stages"][1]["layers"]["ln1"]["scale"].dtype == torch.float32
    _close(wq.float(), np.asarray(
        jp["stages"][1]["layers"]["attn"]["wq"].astype(jnp.bfloat16)
        .astype(jnp.float32)), 0)
