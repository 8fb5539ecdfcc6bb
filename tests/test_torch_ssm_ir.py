"""The IR round schedules on the SSM families in the port against the
JAX package: gpipe, 1f1b and 2bw on rwkv6 and zamba2, interleaved
(v = 2) on rwkv6 only (zamba2 refuses virtual stages, as in JAX), two
rounds each from the JAX model's weights, on the CPU in fp32 against
JAX's ``backend="unrolled"`` oracle.

Tolerances (``tests/test_torch_ssm_train.py``'s): every state leaf
(params, momentum, the 2bw stash) within rtol 1e-4 / atol 1e-5, every
loss within rtol 1e-4.  In a file of its own so that the JAX rounds'
compiles (~9 s a case) spread over the workers.
"""
import jax
import numpy as np
import pytest

from repro.core import pipeline_stream as jps
from repro.planner import plan as jplan
from repro_torch.core import pipeline_stream as tps
from repro_torch.planner import plan as tplan
from test_torch_ssm_train import (LOSS_RTOL, LR, _batches, _close_trees,
                                  _pair, _sds)
from test_torch_threads import one_thread  # noqa: F401


IR_CASES = [("rwkv6-7b", "gpipe", 1), ("rwkv6-7b", "1f1b", 1),
            ("rwkv6-7b", "2bw", 1), ("rwkv6-7b", "interleaved", 2),
            ("zamba2-1.2b", "gpipe", 1), ("zamba2-1.2b", "1f1b", 1),
            ("zamba2-1.2b", "2bw", 1)]


@pytest.mark.parametrize("arch,schedule,v", IR_CASES,
                         ids=[f"{a[:6]}-{s}" for a, s, _ in IR_CASES])
def test_ir_rounds_match_jax(arch, schedule, v):
    """Two rounds of each schedule (spectrain, round size 2, S = 2)
    against JAX's unrolled oracle: losses, params, momentum and the 2bw
    stash."""
    cfg, jm, jparams, tm, tparams = _pair(arch, 2)
    kw = dict(n_stages=2, schedule=schedule, virtual_stages=v,
              n_microbatches=2, partitioner="uniform")
    jp, tp = jplan(cfg, **kw), tplan(tm.cfg, **kw)
    bs = _batches(cfg, 2)
    js = jps.make_ir_state(jm, jparams, _sds(bs[0]), plan=jp)
    jstep = jax.jit(jps.make_ir_train_step(jm, plan=jp, lr=LR,
                                           backend="unrolled"))
    ts = tps.make_ir_state(tm, tparams, plan=tp)
    tstep = tps.make_ir_train_step(tm, plan=tp, lr=LR)
    for b in bs:
        js, jmet = jstep(js, b)
        ts, tmet = tstep(ts, b)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=LOSS_RTOL)
    _close_trees(ts["params"], js["params"], "params", arch)
    _close_trees(ts["momentum"], js["momentum"], "momentum", arch)
    assert ("stash" in ts) == ("stash" in js)
    if "stash" in js:
        _close_trees(ts["stash"]["params"], js["stash"]["params"],
                     "stash params", arch)
