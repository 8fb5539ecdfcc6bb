"""The port's training-side model (loss, head loss, gradients), its
synchronous pipeline and its training launcher against the JAX
package's, on the CPU in fp32.

Weights are the JAX model's, carried over by ``from_jax_params``; inputs
are drawn with numpy from a seed.  The port's attention gradients go
through ``flash_bwd_ref`` (the kernels' formula), JAX's through autodiff
of ``_attend``.  Tolerances: 1e-5 (abs and rel) for losses and
gradients, the same fp32 arithmetic in another summation order; the
sync pipeline's state after two steps to rtol 1e-4 / atol 1e-5 as the
streaming runtime's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline_sync as jsync
from repro.models import layers as jl
from repro_torch.core import pipeline_sync as tsync
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tl
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import sgd as tsgd
from test_torch_train import _pair as _stream_pair
from test_torch_threads import one_thread  # noqa: F401

TOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5


def _pair(S=2, n_layers=4):
    return _stream_pair(S, n_layers)


def _batch(cfg, batch=4, seq=16, seed=0):
    t = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _close(got, want, rtol=TOL, atol=TOL, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=what)


def _close_trees(got, want, **kw):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        _close(g, w, what=f"leaf {i}", **kw)


def _requires_grad(tree):
    return tree_map(lambda _, p: p.detach().requires_grad_(), tree)


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 40), dtype=np.float32) * 3
    tgt = rng.integers(0, 33, size=(3, 5)).astype(np.int32)
    for z in (0.0, 1e-3):
        want = jl.softmax_xent(jnp.asarray(logits), jnp.asarray(tgt), 33,
                               z_loss=z)
        got = tl.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(tgt), 33, z_loss=z)
        _close(got, want)
    # bf16 logits: the logsumexp still runs in fp32
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    want = jl.softmax_xent(jnp.asarray(logits).astype(jnp.bfloat16),
                           jnp.asarray(tgt), 33)
    _close(tl.softmax_xent(lb, torch.from_numpy(tgt), 33), want)


def test_head_loss_and_grads_match_jax():
    cfg, jm, jparams, tm, tparams = _pair()
    b = _batch(cfg)
    x = np.random.default_rng(2).standard_normal(
        (4, 16, cfg.d_model), dtype=np.float32)
    want, (g_outer, g_x) = jax.value_and_grad(
        lambda o, x_: jm.head_loss(o, x_, jnp.asarray(b["targets"])),
        argnums=(0, 1))(jparams["outer"], jnp.asarray(x))
    outer = _requires_grad(tparams["outer"])
    tx = torch.from_numpy(x).requires_grad_()
    got = tm.head_loss(outer, tx, _tb(b)["targets"])
    _close(got, want)
    grads = torch.autograd.grad(got, tree_leaves(outer) + [tx],
                                allow_unused=True)
    for g, w in zip(grads, jax.tree.leaves(g_outer) + [g_x]):
        _close(torch.zeros(w.shape) if g is None else g, w)


@pytest.mark.parametrize("S,L", [(1, 2), (2, 4), (3, 7)])
def test_loss_and_grads_match_jax(S, L):
    """Whole-model loss and every parameter's gradient (attention
    backward through the flash backward formula) against jax.grad."""
    cfg, jm, jparams, tm, tparams = _pair(S, L)
    b = _batch(cfg)
    want, jg = jax.value_and_grad(jm.loss)(jparams, jax.tree.map(
        jnp.asarray, b))
    params = _requires_grad(tparams)
    got = tm.loss(params, _tb(b))
    _close(got, want)
    grads = torch.autograd.grad(got, tree_leaves(params))
    for i, (g, w) in enumerate(zip(grads, jax.tree.leaves(jg))):
        _close(g, w, what=f"grad leaf {i}")
    logits, aux = tm.forward(tparams, _tb(b))
    _close(logits, jm.forward(jparams, jax.tree.map(jnp.asarray, b))[0],
           rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0


def test_stage_apply_matches_jax():
    cfg, jm, jparams, tm, tparams = _pair(2, 4)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model), dtype=np.float32)
    jx, _ = jm.stage_apply(jparams["stages"][1],
                           (jnp.asarray(x), jnp.zeros(())))
    tx, aux = tm.stage_apply(tparams["stages"][1],
                             (torch.from_numpy(x), torch.zeros(())))
    _close(tx, jx, rtol=1e-4, atol=1e-4)


def test_partition_stage_params():
    cfg, jm, jparams, tm, tparams = _pair(3, 7)
    stages = tparams["stages"]
    assert all(a is b for a, b in zip(
        tm.partition_stage_params(stages, (3, 2, 2)), stages))
    moved = tm.partition_stage_params(stages, (1, 3, 3))
    want = jm.partition_stage_params(jparams["stages"], (1, 3, 3))
    _close_trees(moved, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cover"):
        tm.partition_stage_params(stages, (3, 3, 3))
    with pytest.raises(ValueError, match="empty"):
        tm.partition_stage_params(stages, (0, 3, 4))
    # hybrid trees: each stage keeps its tied shared block through a
    # repartition (JAX's rule), and virtual stages are refused
    hybrid = tuple({**s, "shared": {"x": torch.full((2,), float(k))}}
                   for k, s in enumerate(stages))
    again = tm.partition_stage_params(hybrid, (1, 3, 3))
    assert [float(t["shared"]["x"][0]) for t in again] == [0.0, 1.0, 2.0]
    _close_trees([t["layers"] for t in again],
                 [t["layers"] for t in want], rtol=0, atol=0)
    with pytest.raises(ValueError, match="shared"):
        tm.partition_stage_params(hybrid, (1,) * 7, n_chunks=7)


def test_partition_stacked_and_chunked_like_jax():
    """The legacy stacked [S, Lps, ...] input, the interleaved plans'
    n_chunks = S·v chunk trees (ragged too) and their per-device
    grouping, each equal to JAX's."""
    cfg, jm, jparams, tm, tparams = _pair(3, 6)
    jstacked = jm.stack_stage_params(jparams["stages"])
    tstacked = {"layers": tree_map(
        lambda path, _: torch.stack([_at(t["layers"], path) for t in
                                     tparams["stages"]]),
        tparams["stages"][0]["layers"])}
    for sizes, n_chunks in (((1, 2, 3), None), ((2, 2, 2), None),
                            ((1,) * 6, 6)):
        for src_t, src_j in ((tstacked, jstacked),
                             (tparams["stages"], jparams["stages"])):
            got = tm.partition_stage_params(src_t, sizes, n_chunks=n_chunks)
            want = jm.partition_stage_params(src_j, sizes,
                                             n_chunks=n_chunks)
            _close_trees(got, want, rtol=0, atol=0)
    # a ragged chunk split: 7 layers in 6 chunks on 3 devices
    _, jm, jparams, tm, tparams = _pair(3, 7)
    chunks_t = tm.partition_stage_params(tparams["stages"],
                                         (2, 1, 1, 1, 1, 1), n_chunks=6)
    chunks_j = jm.partition_stage_params(jparams["stages"],
                                         (2, 1, 1, 1, 1, 1), n_chunks=6)
    _close_trees(chunks_t, chunks_j, rtol=0, atol=0)
    by_dev_t = tm.device_chunk_params(chunks_t)
    by_dev_j = jm.device_chunk_params(chunks_j)
    assert [len(d) for d in by_dev_t] == [len(d) for d in by_dev_j] == \
        [2, 2, 2]
    for dt, dj in zip(by_dev_t, by_dev_j):
        _close_trees(dt, dj, rtol=0, atol=0)
    for m in (tm, jm):
        with pytest.raises(ValueError, match="fold"):
            m.device_chunk_params(chunks_t[:5])


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("S,L,clip", [(2, 4, None), (3, 7, 0.5)])
def test_sync_pipeline_matches_jax(S, L, clip):
    cfg, jm, jparams, tm, tparams = _pair(S, L)
    M = 2
    bs = [_batch(cfg, seed=i) for i in range(2)]
    _close(tsync.pipeline_loss(tm, tparams, _tb(bs[0]), M),
           jsync.pipeline_loss(jm, jparams, jax.tree.map(jnp.asarray,
                                                         bs[0]), M))
    jstate = {"params": jparams,
              "momentum": jax.tree.map(jnp.zeros_like, jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tparams, "momentum": tsgd.init(tparams).v,
              "step": 0}
    jstep = jax.jit(jsync.make_train_step(jm, lr=0.05,
                                          num_microbatches=M, clip=clip))
    tstep = tsync.make_train_step(tm, lr=0.05, num_microbatches=M,
                                  clip=clip)
    for b in bs:
        jstate, jmet = jstep(jstate, b)
        tstate, tmet = tstep(tstate, b)
        _close(tmet["loss"], jmet["loss"])
        if clip:
            _close(tmet["grad_norm"], jmet["grad_norm"])
    assert tstate["step"] == 2
    _close_trees(tstate["params"], jstate["params"], rtol=STATE_RTOL,
                 atol=STATE_ATOL)
    _close_trees(tstate["momentum"], jstate["momentum"], rtol=STATE_RTOL,
                 atol=STATE_ATOL)


def test_sync_rejects_indivisible_batch():
    cfg, _, _, tm, tparams = _pair(2, 4)
    with pytest.raises(ValueError, match="divisible"):
        tsync.pipeline_loss(tm, tparams, _tb(_batch(cfg, batch=3)), 2)


# the launcher


@pytest.mark.parametrize("mode", ["spectrain", "sync", "pipedream"])
def test_launcher_smoke_on_cpu(mode, tmp_path, capsys):
    out = tmp_path / "train.jsonl"
    rc = ttrain.main(["--smoke", "--device", "cpu", "--pipe", "2",
                      "--layers", "4", "--steps", "4", "--batch", "4",
                      "--seq", "16", "--mode", mode, "--log-every", "2",
                      "--metrics-out", str(out), "--ticks", "2"])
    assert rc == 0
    text = capsys.readouterr().out
    # every run is planned: the stream plan's IR-derived s_fwd, gpipe's
    # for the sync fill/drain pipeline
    if mode != "sync":
        assert "# plan[stream x2 part=dp:(2, 2) s_fwd=(2, 0) s_bwd=(0, 0)" \
            in text
    else:
        assert "# plan[gpipe x2 part=dp:(2, 2) s_fwd=(0, 0)" in text
    assert "# realized stages: s0:L[0:2)" in text
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    steps = [r for r in recs if r["event"] == "train_step"]
    assert [r["step"] for r in steps] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in steps)
    assert recs[-1]["event"] == "summary"


def test_launcher_step_hook_and_data_kind(capsys):
    seen = []
    rc = ttrain.main(["--smoke", "--device", "cpu", "--pipe", "2",
                      "--layers", "2", "--steps", "3", "--batch", "2",
                      "--seq", "8", "--data-kind", "uniform", "--json",
                      "--log-every", "1"],
                     on_step=lambda s, st, m: seen.append(
                         (s, st["tick"], m["loss_valid"])))
    assert rc == 0
    assert seen == [(0, 1, 0.0), (1, 2, 1.0), (2, 3, 1.0)]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["step"] for r in lines] == [1, 2, 3]


@pytest.mark.parametrize("argv", [["--schedule", "1f1b"],
                                  ["--profile-method", "hlo"],
                                  ["--schedule", "2bw"],
                                  ["--compress", "int8"]])
def test_launcher_not_ported(argv, capsys):
    """``--compress`` is refused: the JAX launcher parses it and reads it
    nowhere (the compressors are a library, ``optim/compression.py``;
    the tracer's ``--trace`` runs: tests/test_torch_obs.py).
    ``--profile-method hlo``, refused before the cost-accounting slice,
    now plans from one block counted on the meta device, and trains.
    The round schedules, refused before the planner slice, now train:
    the plan and the round are printed and every round's loss is
    finite."""
    base = ["--smoke", "--device", "cpu"]
    if argv[0] == "--compress":
        with pytest.raises(SystemExit, match="reads it nowhere"):
            ttrain.main(base + argv)
        return
    assert ttrain.main(base + argv + ["--steps", "2", "--log-every",
                                      "1", "--json"]) == 0
    out = capsys.readouterr().out
    if argv[0] == "--profile-method":
        assert "; profile hlo)" in out
        recs = [json.loads(x) for x in out.splitlines()
                if x.startswith("{")]
        assert [r["step"] for r in recs] == [1, 2]
        assert all(np.isfinite(r["loss"]) for r in recs)
        return
    assert f"# plan[{argv[1]} x2 part=dp:(1, 1)" in out
    assert f"# schedule {argv[1]}: round=4 microbatches" in out
    recs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_launcher_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--smoke", "--steps", "1"])
