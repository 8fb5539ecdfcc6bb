"""The port's optimizer, SpecTrain closed forms and prediction, and
synthetic data against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed.  Tolerances: 1e-6 for the
elementwise update and prediction (the same fp32 roundings), 1e-5 for
the global norm and clipping (a sum over every leaf in another order);
the data batches are bit-equal (both sides run the same numpy code).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spectrain as jst
from repro.data import pipeline as jdata
from repro.optim import sgd as jsgd
from repro_torch.core import spectrain as tst
from repro_torch.data import pipeline as tdata
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import sgd as tsgd
from test_torch_threads import one_thread  # noqa: F401

UPD_TOL = 1e-6
NORM_TOL = 1e-5


def _tree(seed, scale=1.0):
    """A small param-like tree: outer leaves and a ragged stage tuple."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s, dtype=np.float32) * scale)
    return {"outer": {"embed": {"tok": mk(16, 8)}, "ln_f": {"scale": mk(8)}},
            "stages": ({"layers": {"w": mk(2, 8, 8), "b": mk(2, 8)}},
                       {"layers": {"w": mk(1, 8, 8), "b": mk(1, 8)}})}


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_torch(v, dtype) for v in tree)
    return torch.from_numpy(np.array(tree)).to(dtype)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close_trees(got, want, tol):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)


# momentum SGD


def test_init_is_fp32_zeros():
    v = tsgd.init(_torch(_tree(0), torch.bfloat16)).v
    assert all(t.dtype == torch.float32 and not t.any()
               for t in tree_leaves(v))


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_update_matches_jax(g_dtype):
    p, v, g = _tree(1), _tree(2, 0.1), _tree(3)
    jp, jm = jsgd.update(_jax(p), jsgd.MomentumState(_jax(v)),
                         jax.tree.map(lambda a: jnp.asarray(a).astype(
                             jnp.bfloat16 if g_dtype == torch.bfloat16
                             else jnp.float32), g), lr=0.05, gamma=0.9)
    tp, tv = _torch(p), _torch(v)
    out_p, out_m = tsgd.update(tp, tsgd.MomentumState(tv),
                               _torch(g, g_dtype), lr=0.05, gamma=0.9)
    assert out_p is tp and out_m.v is tv        # in place
    _close_trees(tp, jp, UPD_TOL)
    _close_trees(tv, jm.v, UPD_TOL)


def test_update_writes_prediction():
    p, v, g = _tree(4), _tree(5, 0.1), _tree(6)
    tp, tv = _torch(p), _torch(v)
    pred = _torch(p, torch.bfloat16)
    tsgd.update(tp, tsgd.MomentumState(tv), _torch(g), lr=0.05, gamma=0.9,
                s=4.0, pred=pred)
    jp, jm = jsgd.update(_jax(p), jsgd.MomentumState(_jax(v)), _jax(g),
                         lr=0.05, gamma=0.9)
    want = jst.predict_weights(jp, jm.v, 0.05, 4)
    _close_trees(pred, want, 2e-2)       # pred held in bf16
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(pred))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_matches_jax(max_norm):
    g = _tree(7)
    jc, jn = jsgd.clip_by_global_norm(_jax(g), max_norm)
    tc, tn = tsgd.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=NORM_TOL)
    np.testing.assert_allclose(float(tsgd.global_norm(_torch(g))),
                               float(jsgd.global_norm(_jax(g))),
                               rtol=NORM_TOL)
    _close_trees(tc, jc, NORM_TOL)


def test_clip_keeps_dtype():
    tc, _ = tsgd.clip_by_global_norm(_torch(_tree(8), torch.bfloat16), 0.1)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tc))


# SpecTrain closed forms, prediction, rmse


@pytest.mark.parametrize("fn", ["version_difference_paper",
                                "version_difference_stream",
                                "version_difference_1f1b",
                                "version_difference_2bw"])
def test_closed_forms_match_jax(fn):
    for n in (1, 2, 3, 4, 8):
        for k in range(n):
            for phase in ("forward", "backward"):
                assert getattr(tst, fn)(k, n, phase) == \
                    getattr(jst, fn)(k, n, phase)
    with pytest.raises(ValueError):
        getattr(tst, fn)(4, 4, "forward")
    with pytest.raises(ValueError):
        getattr(tst, fn)(0, 4, "sideways")


@pytest.mark.parametrize("s", [0, 1, 6])
def test_predict_weights_matches_jax(s):
    w, v = _tree(9), _tree(10, 0.1)
    want = jst.predict_weights(_jax(w), _jax(v), 0.05, s)
    got = tst.predict_weights(_torch(w), _torch(v), 0.05, s)
    _close_trees(got, want, UPD_TOL)


def test_rmse_matches_jax():
    a, b = _tree(11), _tree(12)
    np.testing.assert_allclose(float(tst.rmse(_torch(a), _torch(b))),
                               float(jst.rmse(_jax(a), _jax(b))),
                               rtol=NORM_TOL)


# synthetic data


@pytest.mark.parametrize("kind", ["bigram", "uniform"])
def test_batches_bit_equal(kind):
    kw = dict(vocab_size=97, seq_len=12, global_batch=6, seed=3, kind=kind)
    jd = jdata.SyntheticLM(jdata.DataConfig(**kw))
    td = tdata.SyntheticLM(tdata.DataConfig(**kw))
    for step in (0, 1, 17):
        for shard, n in ((0, 1), (1, 2)):
            jb = jd.batch_at(step, shard=shard, num_shards=n)
            tb = td.batch_at(step, shard=shard, num_shards=n)
            for key in ("tokens", "targets"):
                assert tb[key].dtype == jb[key].dtype
                np.testing.assert_array_equal(tb[key], jb[key])
    assert td.optimal_loss() == jd.optimal_loss()
    it_j = jdata.make_iterator(jd, 5)
    it_t = tdata.make_iterator(td, 5)
    for _ in range(2):
        (sj, bj), (st_, bt) = next(it_j), next(it_t)
        assert sj == st_
        np.testing.assert_array_equal(bt["tokens"], bj["tokens"])


def test_data_rejects_unknown_kind_and_bad_shards():
    with pytest.raises(ValueError, match="kind"):
        tdata.SyntheticLM(tdata.DataConfig(8, 4, 2, kind="zipf"))
    d = tdata.SyntheticLM(tdata.DataConfig(8, 4, 3, kind="uniform"))
    with pytest.raises(ValueError, match="shards"):
        d.batch_at(0, num_shards=2)
