"""The port's library optimizers against the JAX package's, on the CPU:
AdamW (``optim/adam.py``: update, bias correction, weight decay and
the SpecTrain-style prediction), gradient compression
(``optim/compression.py``: top-k with error feedback, int8 stochastic
rounding) and ``core/spectrain.py::predict_weights_stacked``.

Inputs are drawn with numpy from a seed.  Tolerances: 1e-6 for Adam's
elementwise fp32 arithmetic over 20 steps (``pow`` for the bias
correction may round apart by an ulp), exact for top-k (a selection and
a subtraction) and for the int8 rounding given the same uniform draws
(JAX's own draws, replayed from its key); the draws of a
``torch.Generator`` are not JAX's, so ``int8_roundtrip`` is held to
JAX's properties (unbiased, bounded error) instead.  The cases of JAX's
``tests/test_optim.py::TestAdam`` / ``TestCompression`` run on the port
too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spectrain as jst
from repro.optim import adam as jadam
from repro.optim import compression as jcomp
from repro_torch.core import spectrain as tst
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import adam as tadam
from repro_torch.optim import compression as tcomp
from test_torch_threads import one_thread  # noqa: F401

TOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32) * scale
    return {"outer": {"tok": mk(12, 8), "scale": mk(8)},
            "stages": ({"w": mk(2, 8, 8)}, {"w": mk(1, 8, 8)})}


def _t(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _t(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_t(v, dtype) for v in tree)
    return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype)


def _close(got, want, tol=TOL):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


# -------------------------------------------------------------------- Adam
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_update_matches_jax_over_steps(wd):
    p_np = _tree(0)
    tp, jp = _t(p_np), jax.tree.map(jnp.asarray, p_np)
    ts, js = tadam.init(tp), jadam.init(jp)
    for step in range(20):
        g = _tree(100 + step, 0.5)
        tp, ts = tadam.update(tp, ts, _t(g), lr=1e-2, weight_decay=wd)
        jp, js = jadam.update(jp, js, jax.tree.map(jnp.asarray, g),
                              lr=1e-2, weight_decay=wd)
    _close(tp, jp)
    _close(ts.m, js.m)
    _close(ts.v, js.v)
    assert int(ts.count) == int(js.count) == 20
    for leaf in tree_leaves(ts.m) + tree_leaves(ts.v):
        assert leaf.dtype == torch.float32


def test_adam_keeps_bf16_params_and_fp32_moments():
    p_np = _tree(1)
    tp = _t(p_np, torch.bfloat16)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p_np)
    ts, js = tadam.init(tp), jadam.init(jp)
    g = _tree(7, 0.5)
    tp, ts = tadam.update(tp, ts, _t(g, torch.bfloat16), lr=1e-2)
    jp, js = jadam.update(jp, js, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), g), lr=1e-2)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(tp))
    assert all(x.dtype == torch.float32 for x in tree_leaves(ts.m))
    _close(ts.m, js.m)
    _close(tp, jp, tol=1e-2)         # one bf16 rounding of each weight


@pytest.mark.parametrize("s", [0, 1, 5])
def test_adam_predict_matches_jax(s):
    p_np = _tree(2)
    tp, jp = _t(p_np), jax.tree.map(jnp.asarray, p_np)
    ts, js = tadam.init(tp), jadam.init(jp)
    for step in range(4):
        g = _tree(200 + step, 0.5)
        tp, ts = tadam.update(tp, ts, _t(g), lr=1e-2)
        jp, js = jadam.update(jp, js, jax.tree.map(jnp.asarray, g), lr=1e-2)
    _close(tadam.predict(tp, ts, lr=1e-2, s=s),
           jadam.predict(jp, js, lr=1e-2, s=s))


def test_adam_descends_quadratic():
    """``TestAdam.test_descends_quadratic`` on the port."""
    w = torch.tensor([5.0, -3.0])
    state = tadam.init(w)
    for _ in range(200):
        w, state = tadam.update(w, state, 2 * w, lr=0.1)
    assert float(w.abs().max()) < 0.1


def test_adam_predict_direction():
    w = torch.tensor([1.0])
    state = tadam.init(w)
    for _ in range(10):
        w, state = tadam.update(w, state, torch.tensor([1.0]), lr=0.01)
    pred = tadam.predict(w, state, lr=0.01, s=5)
    assert float(pred[0]) < float(w[0])


# ------------------------------------------------------------ compression
def test_topk_keeps_largest():
    g = {"a": torch.tensor([0.1, -5.0, 0.2, 3.0])}
    res = tcomp.topk_init(g)
    sent, res2, stats = tcomp.topk_compress(g, res, frac=0.5)
    assert sent["a"].tolist() == [0.0, -5.0, 0.0, 3.0]
    np.testing.assert_allclose(res2["a"].numpy(), [0.1, 0.0, 0.2, 0.0])
    assert stats == {"kept": 2, "total": 4}


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_topk_matches_jax_and_telescopes(frac):
    """Five steps of error feedback: sent, residual and stats equal JAX's
    exactly, and sum(sent) + the final residual is the sum of the
    gradients (nothing is lost)."""
    rng = np.random.default_rng(3)
    tres, jres = tcomp.topk_init(_t(_tree(0))), jcomp.topk_init(
        jax.tree.map(jnp.asarray, _tree(0)))
    total_g = total_sent = 0.0
    for i in range(5):
        g = _tree(int(rng.integers(1 << 30)))
        tsent, tres, tst_ = tcomp.topk_compress(_t(g), tres, frac=frac)
        jsent, jres, jst_ = jcomp.topk_compress(
            jax.tree.map(jnp.asarray, g), jres, frac=frac)
        _close(tsent, jsent, tol=0)
        _close(tres, jres, tol=0)
        assert tst_ == jst_
        total_g = total_g + np.concatenate(
            [np.ravel(x) for x in jax.tree.leaves(g)])
        total_sent = total_sent + torch.cat(
            [x.reshape(-1) for x in tree_leaves(tsent)]).numpy()
    final = torch.cat([x.reshape(-1) for x in tree_leaves(tres)]).numpy()
    np.testing.assert_allclose(total_sent + final, total_g, atol=1e-5)


def test_int8_rounding_equals_jax_given_its_draws():
    """JAX's ``int8_roundtrip`` draws one uniform a leaf element from
    ``jax.random.split(key, n)``; the port's rounding fed those draws
    gives the same bits."""
    g_np = _tree(5)
    key = jax.random.PRNGKey(11)
    want = jcomp.int8_roundtrip(jax.tree.map(jnp.asarray, g_np), key)
    leaves = jax.tree.leaves(g_np)
    keys = jax.random.split(key, len(leaves))
    got = [tcomp.int8_round(torch.tensor(np.asarray(g)), torch.tensor(
        np.asarray(jax.random.uniform(k, np.shape(g)))))
        for g, k in zip(leaves, keys)]
    for a, b in zip(got, jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_int8_unbiased():
    """``TestCompression.test_int8_unbiased`` with a torch.Generator."""
    g = {"a": torch.from_numpy(
        np.random.default_rng(0).standard_normal(64, dtype=np.float32))}
    gen = torch.Generator().manual_seed(0)
    n = 200
    acc = sum(tcomp.int8_roundtrip(g, gen)["a"] for _ in range(n))
    err = float((acc / n - g["a"]).abs().max())
    scale = float(g["a"].abs().max()) / 127
    assert err < 3 * scale


def test_int8_bounded_error():
    g = {"a": torch.from_numpy(
        np.random.default_rng(1).standard_normal(128, dtype=np.float32))}
    out = tcomp.int8_roundtrip(g, torch.Generator().manual_seed(1))
    scale = float(g["a"].abs().max()) / 127
    assert float((out["a"] - g["a"]).abs().max()) <= scale + 1e-6


# --------------------------------------------- SpecTrain, stage-stacked
@pytest.mark.parametrize("s", [[0, 1, 2, 3], [6, 4, 2, 0]])
def test_predict_weights_stacked_matches_jax(s):
    rng = np.random.default_rng(9)
    w = {"a": rng.standard_normal((4, 3, 5), dtype=np.float32),
         "b": rng.standard_normal((4, 7), dtype=np.float32)}
    v = {"a": rng.standard_normal((4, 3, 5), dtype=np.float32),
         "b": rng.standard_normal((4, 7), dtype=np.float32)}
    got = tst.predict_weights_stacked(_t(w), _t(v), 0.05, s)
    want = jst.predict_weights_stacked(jax.tree.map(jnp.asarray, w),
                                       jax.tree.map(jnp.asarray, v), 0.05,
                                       np.asarray(s))
    _close(got, want, tol=TOL)
    # stage k's rows are predict_weights at s[k]
    for k in range(4):
        one = tst.predict_weights({"a": _t(w)["a"][k]},
                                  {"a": _t(v)["a"][k]}, 0.05, s[k])
        np.testing.assert_allclose(got["a"][k].numpy(), one["a"].numpy(),
                                   rtol=TOL, atol=TOL)
