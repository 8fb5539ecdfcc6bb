"""The dense code models granite-20b (MQA: 48 heads over one KV head,
G = 48) and starcoder2-15b (48 heads over 4, G = 12) in the port against
the JAX package's, run live.

``smoke_config`` keeps 4 heads, so the smoke runs of these configs never
see their GQA groups; here the attention and the models keep the
published head counts (48 over 1 and 4, and 12 over 1 and 4) at
head_dim 16 and narrow widths.  Weights are the JAX model's or layer's,
carried over by ``from_jax_params``; inputs are drawn with numpy from
seeds; everything runs on the CPU in fp32.

Tolerances: 2e-5 for one attention layer (the port's fp32 attention
tolerance: the same softmax in another summation order); 1e-4 for
whole-model losses, gradients and logits (two layers of it); engine
tokens exact.
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
from repro.models.layers import init_params as jinit_params
from repro.planner import serve_plan as jserve_plan
from repro.serve import SimpleEngine as JSimpleEngine
from repro.serve import poisson_trace as jpoisson_trace
from repro_torch import configs as tconfigs
from repro_torch.models import Model, from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models.layers import tree_leaves
from repro_torch.planner import serve_plan
from repro_torch.serve import Request, SimpleEngine
from test_torch_model import port_cfg
from test_torch_train import _batches
from test_torch_threads import one_thread  # noqa: F401

ATTN_TOL, MODEL_TOL = 2e-5, 1e-4
CODE_ARCHS = {"granite-20b": (48, 1), "starcoder2-15b": (48, 4)}


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("name", sorted(CODE_ARCHS))
def test_code_configs_build_in_the_port(name):
    t, j = tconfigs.get_config(name), jget_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.n_heads, t.n_kv_heads) == CODE_ARCHS[name]
    assert t.param_count() == j.param_count()
    assert dataclasses.asdict(tconfigs.smoke_config(t)) == \
        dataclasses.asdict(jsmoke_config(j))
    Model(tconfigs.smoke_config(t), device="cpu")


def test_only_mla_encdec_and_frontends_stay_refused():
    """Since the enc-dec models and the vision frontend are ported, every
    assigned architecture builds (the name is kept from when MLA, enc-dec
    and the frontends were refused); only the recurrent
    residual-lstm-paper, which has no reference model, is refused."""
    for name in tconfigs.list_archs():
        Model(tconfigs.smoke_config(tconfigs.get_config(name)), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(tconfigs.get_config("residual-lstm-paper"), device="cpu")


@pytest.mark.parametrize("H,KV", [(48, 1), (48, 4), (12, 1), (12, 4)])
def test_gqa_attention_matches_jax(H, KV):
    """A causal prefill at pos_offset 3 and a decode step into a
    cache, against ``repro/models/attention.py``'s ``gqa_apply``."""
    jc = tiny_cfg("granite-20b", n_heads=H, n_kv_heads=KV, head_dim=16)
    tc = port_cfg(jc)
    p = jinit_params(jattn.gqa_specs(jc), jax.random.PRNGKey(H + KV))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    rng = np.random.default_rng(H * KV)
    x = rng.standard_normal((2, 7, jc.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p_, x_: jattn.gqa_apply(
        jc, p_, x_, pos_offset=3))(p, jnp.asarray(x))
    got, _ = tattn.gqa_apply(tc, tp, torch.from_numpy(x), pos_offset=3)
    _close(got, want, ATTN_TOL, "prefill")
    # decode at position 5 against a cache whose first 5 keys are set
    ck = rng.standard_normal((2, 8, KV, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 8, KV, 16)).astype(np.float32)
    ck[:, 5:] = cv[:, 5:] = 0
    x1 = x[:, :1]
    want, jcache = jax.jit(lambda p_, x_, c_: jattn.gqa_apply(
        jc, p_, x_, cache=c_, pos=5))(
        p, jnp.asarray(x1), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)})
    tcache = {"k": torch.from_numpy(ck.copy()),
              "v": torch.from_numpy(cv.copy())}
    got, tcache = tattn.gqa_apply(tc, tp, torch.from_numpy(x1),
                                  cache=tcache, pos=5)
    _close(got, want, ATTN_TOL, "decode")
    _close(tcache["k"], jcache["k"], ATTN_TOL, "cache k")


def _pair(name, seed=0):
    H, KV = CODE_ARCHS[name]
    jc = tiny_cfg(name, n_layers=2, pipe=1, n_heads=H, n_kv_heads=KV,
                  head_dim=16)
    jm = JModel(jc)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = Model(port_cfg(jc), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg,
                         device="cpu")
    return jc, jm, jp, tm, tp


@pytest.mark.parametrize("name", sorted(CODE_ARCHS))
def test_code_model_loss_grads_and_tokens_match_jax(name):
    """At the published head counts: the loss and every gradient leaf
    against ``jax.value_and_grad``; the tokens of ``SimpleEngine``
    against JAX's on one trace."""
    jc, jm, jp, tm, tp = _pair(name)
    b = _batches(jc, 1, batch=2, seq=16)[0]
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, b)
    leaves = jax.tree.map(lambda a: a.detach().requires_grad_(), tp,
                          is_leaf=lambda a: isinstance(a, torch.Tensor))
    tb = {k: torch.from_numpy(np.asarray(v)).long() for k, v in b.items()}
    tloss = tm.loss(leaves, tb)
    _close(tloss, jloss, MODEL_TOL, "loss")
    tloss.backward()
    for i, (a, w) in enumerate(zip(tree_leaves(leaves),
                                   jax.tree.leaves(jg))):
        _close(a.grad, w, MODEL_TOL, f"grad leaf {i}")
    trace = jpoisson_trace(4, rate=1.0, seed=1, prompt_lens=(2, 8),
                           gen_lens=(2, 4), vocab=jc.vocab_size)
    one = dict(n_stages=1, n_slots=1, max_prefill=1, prompt_budget=8,
               page_seq=16, validate=False)
    want = JSimpleEngine(jm, jp, jserve_plan(jc, **one)).run(trace)
    reqs = [Request(q.rid, q.arrival, q.prompt, q.gen_len) for q in trace]
    assert SimpleEngine(tm, tp, serve_plan(tm.cfg, **one)).run(reqs) == want
