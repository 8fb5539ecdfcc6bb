"""The port's fault tolerance (``runtime/fault_tolerance.py``) against the
JAX package's, on the CPU: the cases of JAX's
``tests/test_fault_tolerance.py`` (``TestRestart``, ``TestStraggler``,
``TestHeartbeat``) on the port, and the same calls made on both sides
giving the same results and the same structured events.

The restart runs the port's streaming SpecTrain tick (4 layers of the
smoke granite, 2 stages, its synthetic data) through a
:class:`RestartManager` over the port's checkpoint format: a crash and
restore gives the uninterrupted run's state bit for bit (the tick is
deterministic on the CPU and the data is a function of the step).
"""
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro_torch.core import pipeline_stream
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 RestartManager,
                                                 masked_gradient_mean)
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401


def _build(pipe=2, n_layers=4):
    cfg = port_cfg(tiny_cfg("granite-8b", n_layers=n_layers, pipe=pipe))
    m = Model(cfg, device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 4, seed=3))
    gen = torch.Generator().manual_seed(0)
    state = pipeline_stream.make_state(m, m.init(gen), data.batch_at(0),
                                       mode="spectrain")
    step = pipeline_stream.make_train_step(m, mode="spectrain", lr=0.02)
    return data, state, step


def _leaves(state):
    return [t.clone() for t in tree_leaves(
        {k: state[k] for k in ("params", "momentum", "pred")})]


@pytest.mark.parametrize("save_every,fail_at", [(1, 7), (3, 7)])
def test_crash_restart_matches_uninterrupted(tmp_path, save_every,
                                             fail_at):
    """``TestRestart``: 12 ticks uninterrupted against 12 with a node
    lost at ``fail_at`` (restored from the last checkpoint, the ticks
    after it replayed), bit for bit; with ``save_every=3`` the crash
    loses in-memory progress past the checkpoint."""
    data, state, step = _build()
    reg = MetricsRegistry()
    want, _ = RestartManager(str(tmp_path / "a"),
                             save_every=save_every).run(state, step, data,
                                                        0, 12)
    want = _leaves(want)
    data, state, step = _build()
    rm = RestartManager(str(tmp_path / "b"), save_every=save_every,
                        inject_failure_at=fail_at, registry=reg)
    got, s = rm.run(state, step, data, 0, 12)
    assert s == 12
    for a, b in zip(_leaves(got), want):
        assert torch.equal(a, b)
    last_save = (fail_at // save_every) * save_every - 1
    assert [e["step"] for e in reg.find("failure_injected")] == [fail_at]
    assert [e["step"] for e in reg.find("restore")] == [last_save]
    assert got["tick"] == 12


def test_restart_without_a_checkpoint_starts_over(tmp_path):
    data, state, step = _build()
    rm = RestartManager(str(tmp_path), save_every=100, inject_failure_at=2)
    assert rm.maybe_restore(state) == (state, 0)


def _shards(seed, n=4):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((3, 5), dtype=np.float32),
             "b": {"c": rng.standard_normal(7, dtype=np.float32)}}
            for _ in range(n)]


@pytest.mark.parametrize("alive", [[True, True, False, True],
                                   [False, True, False, False],
                                   [True] * 4])
def test_masked_mean_matches_jax(alive):
    import jax
    import jax.numpy as jnp
    from repro.runtime.fault_tolerance import masked_gradient_mean as jmean
    shards = _shards(0)
    to_t = lambda t: {"w": torch.from_numpy(t["w"]),
                      "b": {"c": torch.from_numpy(t["b"]["c"])}}
    got = masked_gradient_mean([to_t(s) for s in shards], alive)
    want = jmean([jax.tree.map(jnp.asarray, s) for s in shards], alive)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_masked_mean_drops_dead_replica():
    g = [{"w": torch.full((3,), float(i))} for i in range(4)]
    got = masked_gradient_mean(g, [True, True, False, True])
    np.testing.assert_allclose(got["w"].numpy(), np.full(3, (0 + 1 + 3) / 3))


def test_all_dead_raises():
    with pytest.raises(RuntimeError):
        masked_gradient_mean([{"w": torch.ones(2)}], [False])


def test_straggler_detection():
    """``TestHeartbeat.test_straggler_detection`` on the port."""
    reg = MetricsRegistry()
    hb = HeartbeatMonitor(deadline_s=10.0, registry=reg)
    hb.beat(0, 5, now=100.0)
    hb.beat(1, 5, now=100.0)
    hb.beat(2, 3, now=85.0)
    assert hb.stragglers(now=100.0) == [2]
    assert hb.alive_mask(4, now=100.0) == [True, True, False, False]
    missed = reg.find("heartbeat_missed")
    assert [e["worker"] for e in missed] == [2]
    assert missed[0]["last_step"] == 3
    assert missed[0]["overdue_s"] == pytest.approx(5.0)
    hb.stragglers(now=101.0)            # still overdue: no re-emit
    assert len(reg.find("heartbeat_missed")) == 1
    hb.beat(2, 4, now=101.0)
    rec = reg.find("heartbeat_recovered")
    assert [e["worker"] for e in rec] == [2]


def test_heartbeat_events_equal_jax():
    """One script of beats and checks on both monitors: the same
    stragglers, masks and events (but for the registries' clocks)."""
    from repro.obs import MetricsRegistry as JRegistry
    from repro.runtime.fault_tolerance import HeartbeatMonitor as JMonitor
    t_reg, j_reg = MetricsRegistry(), JRegistry()
    sides = [(HeartbeatMonitor(deadline_s=4.0, registry=t_reg), t_reg),
             (JMonitor(deadline_s=4.0, registry=j_reg), j_reg)]
    script = [("beat", 0, 1, 0.0), ("beat", 1, 1, 0.5), ("beat", 2, 0, 1.0),
              ("check", 6, 4.7), ("beat", 1, 2, 5.0), ("check", 6, 6.0),
              ("beat", 0, 3, 6.5), ("check", 3, 9.9), ("beat", 2, 1, 10.0),
              ("check", 3, 10.5)]
    out = []
    for mon, _ in sides:
        res = []
        for op in script:
            if op[0] == "beat":
                mon.beat(op[1], op[2], now=op[3])
            else:
                res.append((mon.stragglers(now=op[2]),
                            mon.alive_mask(op[1], now=op[2])))
        out.append(res)
    assert out[0] == out[1]
    strip = lambda reg: [{k: v for k, v in e.items() if k != "t"}
                         for e in reg.events]
    assert strip(t_reg) == strip(j_reg) and len(t_reg.events) >= 4
