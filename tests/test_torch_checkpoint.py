"""The port's checkpointing against the JAX package's, on the CPU.

A checkpoint written by either package restores into the other bit for
bit (one on-disk format: ``step_%08d/shard_0.npz`` + ``manifest.json``,
keys joined by ``/``), bf16 leaves included; the three restore
migrations (stacked → ragged, partition → partition, packed ↔ ragged)
give what the JAX ``restore`` gives on the same directory; a resumed
streaming run repeats the uninterrupted one bit for bit; and the
launcher's ``--ckpt-dir`` / ``--resume auto`` resume exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.core import pipeline_stream as jps
from repro.core import pipeline_sync as jsync
from repro.models import Model as JModel
from repro.models.model import pack_chunk_params
from repro.runtime import checkpoint as jck
from repro_torch.core import pipeline_stream as tps
from repro_torch.launch import train as ttrain
from repro_torch.models import Model, from_jax_params
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import sgd
from repro_torch.runtime import checkpoint as tck
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401


def _bits(a) -> np.ndarray:
    """A leaf's bytes (bf16 tensors and ml_dtypes arrays included);
    integers as int64, so int32 / int64 / Python int compare by value."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().reshape(-1).view(np.uint8)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return a.reshape(-1).view(np.uint8)


def _assert_same(port_tree, jax_tree, what=""):
    """Key for key (the port's flattening against JAX's paths) and bit
    for bit; integer leaves by value (int32 / int64 / Python int)."""
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 jax_tree)[0]}
    pflat = dict(tck._flat(port_tree))
    assert set(pflat) == set(jflat), (what, set(pflat) ^ set(jflat))
    for k in pflat:
        assert np.array_equal(_bits(pflat[k]), _bits(jflat[k])), (what, k)


def _batch(cfg, seed=0, b=4, s=16):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}


def _pair(pipe=2, n_layers=4, dtype="float32"):
    cfg = tiny_cfg("granite-8b", n_layers=n_layers, pipe=pipe,
                   n_kv_heads=2).replace(compute_dtype=dtype)
    jm = JModel(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(port_cfg(cfg), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg,
                         device="cpu")
    return cfg, jm, jp, tm, tp


def _clone(params):
    return tree_map(lambda _, t: t.clone(), params)


def _sds(batch):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        batch)


# ---------------------------------------------------------------------------
# JAX <-> port


@pytest.mark.parametrize("mode,fused", [("vanilla", False),
                                        ("pipedream", False),
                                        ("spectrain", True)])
def test_jax_checkpoint_restores_into_port_bitwise(tmp_path, mode, fused):
    """A bf16-compute JAX streaming state (bf16 rings, and for spectrain
    the fused bf16 prediction: leaves numpy loads as ``V2``) after two
    ticks, saved by JAX, restored into a fresh port state."""
    cfg, jm, jp, tm, tp = _pair(dtype="bfloat16")
    b = _batch(cfg)
    js = jps.make_state(jm, jp, _sds(b), mode=mode, fused_predict=fused)
    step = jax.jit(jps.make_train_step(jm, mode=mode, lr=0.05,
                                       fused_predict=fused))
    for _ in range(2):
        js, _ = step(js, b)
    jck.save(str(tmp_path), js, 3)
    template = tps.make_state(tm, tp, b, mode=mode, fused_predict=fused)
    got, s = tck.restore(str(tmp_path), template)
    assert s == 3 and got["tick"] == 2 and got["step"] == 2
    assert got["fwd_buf"].dtype == torch.bfloat16
    if fused:
        # the port predicts only embed.tok of the outer tree; the JAX
        # state's other outer predictions are not read
        js = dict(js, pred={"outer": {"embed": {
            "tok": js["pred"]["outer"]["embed"]["tok"]}},
            "stages": js["pred"]["stages"]})
    _assert_same(got, js, mode)


@pytest.mark.parametrize("mode", ["vanilla", "pipedream", "spectrain"])
def test_port_checkpoint_restores_into_jax_bitwise(tmp_path, mode):
    """A bf16-compute port state after two ticks, saved by the port
    (bf16 leaves widened to float32), restored by JAX's ``restore`` into
    a JAX state: the same bits, bf16 leaves included."""
    cfg, jm, jp, tm, tp = _pair(dtype="bfloat16")
    b = _batch(cfg)
    ts = tps.make_state(tm, tp, b, mode=mode)
    step = tps.make_train_step(tm, mode=mode, lr=0.05)
    for _ in range(2):
        ts, _ = step(ts, b)
    tck.save(str(tmp_path), ts, 5)
    got, s = jck.restore(str(tmp_path),
                         jps.make_state(jm, jp, _sds(b), mode=mode))
    assert s == 5
    assert got["fwd_buf"].dtype == jnp.bfloat16
    _assert_same({k: v for k, v in ts.items() if k != "pred"}, got, mode)


def test_manifest_and_keys_are_the_jax_spelling(tmp_path):
    cfg, jm, jp, tm, tp = _pair()
    b = _batch(cfg)
    ts = tps.make_state(tm, tp, b, mode="pipedream")
    tck.save(str(tmp_path), ts, 12)
    d = tmp_path / "step_00000012"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 12 and manifest["nshards"] == 1
    keys = set(manifest["keys"])
    assert {"step", "tick", "params/stages/0/layers/attn/wq",
            "w_stash/1/layers/mlp/w1", "batch_ring/tokens"} <= keys
    with np.load(d / "shard_0.npz") as data:
        assert set(data.files) == keys
        assert data["step"].dtype == np.int32 and data["step"].shape == ()


# ---------------------------------------------------------------------------
# the restore migrations, held against JAX's restore of the same directory


def _sync_state(jm, jp, steps=2, seed=0):
    """A JAX sync state {params, momentum, step} after a few updates."""
    cfg = jm.cfg
    st = {"params": jp, "momentum": jax.tree.map(jnp.zeros_like, jp),
          "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jsync.make_train_step(jm, lr=0.05, num_microbatches=2))
    for i in range(steps):
        st, _ = step(st, _batch(cfg, seed + i))
    return st


def test_partition_to_partition(tmp_path):
    """A JAX pipe-2 checkpoint onto a port pipe-4 template (each stage's
    layers re-sliced from the flat layer order), as JAX restores it onto
    a JAX pipe-4 template."""
    _, jm2, jp2, _, _ = _pair(pipe=2)
    jck.save(str(tmp_path), _sync_state(jm2, jp2), 4)
    _, jm4, jp4, tm4, tp4 = _pair(pipe=4)
    want, _ = jck.restore(str(tmp_path), {
        "params": jp4, "momentum": jax.tree.map(jnp.zeros_like, jp4),
        "step": jnp.zeros((), jnp.int32)})
    got, _ = tck.restore(str(tmp_path), {
        "params": tp4, "momentum": sgd.init(tp4).v, "step": 0})
    assert [t["layers"]["ln1"]["scale"].shape[0]
            for t in got["params"]["stages"]] == [1, 1, 1, 1]
    _assert_same(got, want)


def test_stacked_to_ragged(tmp_path):
    _, jm, jp, tm, tp = _pair(pipe=2)
    st = _sync_state(jm, jp)
    old = {"params": {"outer": st["params"]["outer"],
                      "stages": jm.stack_stage_params(
                          st["params"]["stages"])},
           "momentum": {"outer": st["momentum"]["outer"],
                        "stages": jm.stack_stage_params(
                            st["momentum"]["stages"])},
           "step": st["step"]}
    jck.save(str(tmp_path), old, 2)
    want, _ = jck.restore(str(tmp_path), st)
    got, _ = tck.restore(str(tmp_path), {
        "params": tp, "momentum": sgd.init(tp).v, "step": 0})
    _assert_same(got, want)
    _assert_same(got, st)


def test_packed_to_ragged_and_back(tmp_path):
    """An MPMD-packed checkpoint ([v, S, Lmax, ...] layer leaves and a
    ``chunk_sizes`` leaf) onto a ragged port template, and a ragged one
    onto a packed template, each as JAX restores it."""
    _, jm, jp, tm, tp = _pair(pipe=2, n_layers=5)   # ragged (3, 2)
    packed, sizes = pack_chunk_params(jp["stages"], 2)
    assert sizes == (3, 2)
    jck.save(str(tmp_path / "packed"), {
        "params": {"outer": jp["outer"], "stages": packed},
        "chunk_sizes": np.asarray(sizes, np.int32)}, 1)
    want, _ = jck.restore(str(tmp_path / "packed"), {"params": jp})
    got, _ = tck.restore(str(tmp_path / "packed"), {"params": tp})
    _assert_same(got, want)
    _assert_same(got, {"params": jp})

    jck.save(str(tmp_path / "ragged"), {"params": jp}, 1)
    tmpl_j = {"params": {"outer": jp["outer"], "stages": packed},
              "chunk_sizes": np.asarray(sizes, np.int32)}
    tmpl_t = {"params": {"outer": tp["outer"], "stages": {
        "layers": jax.tree.map(lambda a: torch.zeros(a.shape),
                               packed["layers"])}},
        "chunk_sizes": torch.tensor(sizes, dtype=torch.int32)}
    want, _ = jck.restore(str(tmp_path / "ragged"), tmpl_j)
    got, _ = tck.restore(str(tmp_path / "ragged"), tmpl_t)
    _assert_same(got, want)


def test_ring_across_partitions_raises(tmp_path):
    _, jm2, jp2, tm2, tp2 = _pair(pipe=2)
    b = _batch(jm2.cfg)
    tck.save(str(tmp_path), tps.make_state(tm2, tp2, b, mode="vanilla"), 1)
    _, _, _, tm4, tp4 = _pair(pipe=4)
    with pytest.raises(ValueError, match="in-flight rings"):
        tck.restore(str(tmp_path),
                    tps.make_state(tm4, tp4, b, mode="vanilla"))


# ---------------------------------------------------------------------------
# the store itself


@pytest.fixture
def state():
    cfg, jm, jp, tm, tp = _pair()
    return tps.make_state(tm, tp, _batch(cfg), mode="spectrain")


def test_atomic_tmp_is_ignored(tmp_path, state):
    d = str(tmp_path)
    tck.save(d, state, 1)
    os.makedirs(os.path.join(d, "step_00000002.tmp"))     # a crashed write
    os.makedirs(os.path.join(d, "step_00000003"))          # no manifest
    assert tck.all_steps(d) == [1]
    assert tck.latest_step(d) == 1
    assert tck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"), state)


def test_keep_collects_old_steps(tmp_path, state):
    for s in (1, 2, 3, 4, 5):
        tck.save(str(tmp_path), state, s, keep=2)
    assert tck.all_steps(str(tmp_path)) == [4, 5]


def test_missing_leaf_raises_key_error(tmp_path, state):
    tck.save(str(tmp_path), {"params": state["params"]}, 1)
    with pytest.raises(KeyError, match="momentum"):
        tck.restore(str(tmp_path), {"params": state["params"],
                                    "momentum": state["momentum"]})


def test_background_save_snapshots_before_returning(tmp_path, state):
    """The host copy is taken before ``save`` returns: writing the state
    in place while the file is written does not reach the checkpoint."""
    want = [t.clone() for t in tree_leaves(state["params"])]
    t = tck.save(str(tmp_path), state, 9, background=True)
    for p in tree_leaves(state["params"]):
        p.add_(1.0)
    t.join(timeout=60)
    assert not t.is_alive()
    got, s = tck.restore(str(tmp_path), state)
    assert s == 9
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got["params"]), want))


# ---------------------------------------------------------------------------
# exact resume


@pytest.mark.parametrize("mode", ["spectrain", "pipedream"])
def test_resume_is_bit_exact(tmp_path, mode):
    """6 ticks == 3 ticks, save, restore into a fresh state, 3 ticks:
    every leaf of the state bit for bit."""
    cfg, jm, jp, tm, tp = _pair()
    bs = [_batch(cfg, seed=i) for i in range(6)]
    step = tps.make_train_step(tm, mode=mode, lr=0.05)
    fresh = lambda: tps.make_state(tm, _clone(tp), bs[0], mode=mode)
    a = fresh()
    for b in bs:
        a, _ = step(a, b)
    c = fresh()
    for b in bs[:3]:
        c, _ = step(c, b)
    tck.save(str(tmp_path), c, 2)
    c, _ = tck.restore(str(tmp_path), fresh())
    for b in bs[3:]:
        c, _ = step(c, b)
    for (k, x), (_, y) in zip(tck._flat(a), tck._flat(c)):
        assert np.array_equal(_bits(x), _bits(y)), k


@pytest.mark.parametrize("mode", ["spectrain", "sync"])
def test_launcher_resume_matches_uninterrupted(tmp_path, mode):
    """``--ckpt-dir`` / ``--resume auto``: 3 steps, then a second call
    to 6, saves the same final state as 6 steps in one call."""
    argv = ["--smoke", "--device", "cpu", "--pipe", "2", "--layers", "2",
            "--batch", "2", "--seq", "8", "--mode", mode,
            "--save-every", "2", "--log-every", "10"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    assert ttrain.main(argv + ["--steps", "6", "--ckpt-dir", one]) == 0
    assert tck.all_steps(one) == [1, 3, 5]
    assert ttrain.main(argv + ["--steps", "3", "--ckpt-dir", two]) == 0
    assert tck.latest_step(two) == 2
    ran = []
    assert ttrain.main(argv + ["--steps", "6", "--ckpt-dir", two,
                               "--resume", "auto"],
                       on_step=lambda s, st, m: ran.append(s)) == 0
    assert ran == [3, 4, 5]
    with np.load(os.path.join(one, "step_00000005", "shard_0.npz")) as x, \
            np.load(os.path.join(two, "step_00000005", "shard_0.npz")) as y:
        assert set(x.files) == set(y.files)
        for k in x.files:
            assert np.array_equal(x[k], y[k]), k


def test_launcher_final_save_is_the_last_step_run(tmp_path, monkeypatch):
    """The final save writes only a state no periodic save wrote, under
    the step that produced it: a resume past ``--steps`` runs nothing
    and rewrites nothing; a run whose last step was saved saves once."""
    argv = ["--smoke", "--device", "cpu", "--pipe", "2", "--layers", "2",
            "--batch", "2", "--seq", "8", "--mode", "spectrain",
            "--save-every", "2", "--log-every", "10"]
    d = str(tmp_path / "ck")
    saves = []
    real_save = tck.save

    def counting_save(path, state, step, **kw):
        saves.append(step)
        return real_save(path, state, step, **kw)

    monkeypatch.setattr(tck, "save", counting_save)
    assert ttrain.main(argv + ["--steps", "4", "--ckpt-dir", d]) == 0
    assert saves == [1, 3]
    assert tck.all_steps(d) == [1, 3]
    shard = os.path.join(d, "step_00000001", "shard_0.npz")
    with open(shard, "rb") as f:
        before = f.read()
    ran = []
    assert ttrain.main(argv + ["--steps", "2", "--ckpt-dir", d,
                               "--resume", "auto"],
                       on_step=lambda s, st, m: ran.append(s)) == 0
    assert ran == [] and saves == [1, 3]
    assert tck.all_steps(d) == [1, 3]
    with open(shard, "rb") as f:
        assert f.read() == before
    assert ttrain.main(argv + ["--steps", "5", "--ckpt-dir", d,
                               "--resume", "auto"]) == 0
    assert saves == [1, 3, 4]
    assert tck.all_steps(d) == [1, 3, 4]
