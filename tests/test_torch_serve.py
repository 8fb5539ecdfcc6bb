"""The port's serving path against the JAX package's.

The load-bearing claim: on the same seeded trace and the same weights
(carried over from the JAX model), the port's ``SimpleEngine`` emits
exactly the JAX ``SimpleEngine``'s tokens, although it prefills in one
causal call where the JAX engine scans ``decode_step`` over the prompt.
Everything runs on the CPU in fp32.
"""
import json

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models import Model as JModel
from repro.planner import serve_plan as jserve_plan
from repro.planner import synthetic_profile as jsynthetic
from repro.serve import Request as JRequest
from repro.serve import SimpleEngine as JSimpleEngine
from repro.serve import admissible as jadmissible
from repro.serve import poisson_trace as jpoisson_trace
from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import Model, from_jax_params
from repro_torch.planner import serve_plan
from repro_torch.planner import synthetic_profile as tsynthetic
from repro_torch.serve import (Request, SimpleEngine, admissible,
                               poisson_trace)
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401

PLAN_KW = dict(n_slots=4, max_prefill=2, prompt_budget=8, page_seq=32,
               n_layers=4)


@pytest.fixture(scope="module")
def served():
    jc = tiny_cfg("granite-8b", n_kv_heads=2)
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    trace = jpoisson_trace(8, rate=1.5, seed=0, prompt_lens=(2, 8),
                           vocab=jc.vocab_size)
    want = JSimpleEngine(jm, jp, jserve_plan(None, n_stages=2, **PLAN_KW)
                         ).run(trace)
    tc = port_cfg(jc)
    tm = Model(tc, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return want, tm, tp


# (e) the port's engine emits the JAX engine's tokens


def test_simple_engine_tokens_match_jax(served):
    want, tm, tp = served
    trace = poisson_trace(8, rate=1.5, seed=0, prompt_lens=(2, 8),
                          vocab=tm.cfg.vocab_size)
    ops.reset_launch_counts()
    eng = SimpleEngine(tm, tp, serve_plan(None, n_stages=2, **PLAN_KW))
    got = eng.run(trace)
    assert got == want
    assert any(got.values())
    # one prefill per admitted request and one decode per further token,
    # plus the warm-up's one of each; the CPU path launches no kernel
    live = [q for q in trace if got[q.rid]]
    assert eng.n_prefill == 1 + len(live)
    assert eng.n_decode == 1 + sum(q.gen_len - 1 for q in live)
    assert set(ops.launch_counts().values()) == {0}


def test_simple_engine_rejects_what_jax_rejects(served):
    want, tm, tp = served
    splan = serve_plan(None, n_stages=1, n_slots=1, prompt_budget=4,
                       page_seq=8, n_layers=4)
    trace = [Request(0, 0, (1, 2, 3, 4, 5), 2), Request(1, 0, (1, 2), 7),
             Request(2, 1, (3,), 2)]
    got = SimpleEngine(tm, tp, splan).run(trace)
    assert got[0] == () and got[1] == () and len(got[2]) == 2


# (f) traces, admission and the plan summary


@pytest.mark.parametrize("kw", [
    dict(n_requests=8, rate=1.5, seed=0, prompt_lens=(2, 8)),
    dict(n_requests=20, rate=0.3, seed=7, prompt_lens=(1, 16),
         gen_lens=(2, 9), vocab=49152),
])
def test_poisson_trace_matches_jax(kw):
    n = kw.pop("n_requests")
    got = poisson_trace(n, **kw)
    want = jpoisson_trace(n, **kw)
    assert [(q.rid, q.arrival, q.prompt, q.gen_len) for q in got] == \
        [(q.rid, q.arrival, q.prompt, q.gen_len) for q in want]


def test_poisson_trace_validates():
    with pytest.raises(ValueError):
        poisson_trace(0)
    with pytest.raises(ValueError):
        poisson_trace(3, rate=0.0)


def test_admissible_matches_jax():
    kw = dict(n_layers=4, n_slots=2)
    plans = [(serve_plan(None, 1, prompt_budget=P, page_seq=S, **kw),
              jserve_plan(None, 1, prompt_budget=P, page_seq=S,
                          validate=False, **kw))
             for P, S in ((4, 8), (8, 32), (16, 16))]
    for plen in range(0, 18):
        for gen in range(0, 20, 3):
            prompt = tuple(range(plen))
            for tp, jp in plans:
                assert admissible(Request(0, 0, prompt, gen), tp) == \
                    jadmissible(JRequest(0, 0, prompt, gen), jp)


def test_serve_plan_summary_and_validation_match_jax():
    got = serve_plan(None, n_stages=2, **PLAN_KW)
    want = jserve_plan(None, n_stages=2, validate=False, **PLAN_KW)
    assert got.summary() == want.summary()
    assert got.stage_sizes == want.stage_sizes
    for bad in (dict(n_slots=0), dict(max_prefill=-1),
                dict(prompt_budget=0), dict(page_seq=4, prompt_budget=8),
                dict(n_pages=1, n_slots=2)):
        kw = dict(PLAN_KW, **bad)
        with pytest.raises(ValueError):
            serve_plan(None, n_stages=2, **kw)
        with pytest.raises(ValueError):
            jserve_plan(None, n_stages=2, validate=False, **kw)
    # the dp partitioner (refused before the planner slice): equal to
    # JAX's on a skewed profile and on a config's analytic profile
    costs = [4.0, 1.0, 1.0, 1.0, 1.0, 2.0]
    got = serve_plan(None, n_stages=3, partitioner="dp",
                     profile=tsynthetic(costs), **PLAN_KW)
    want = jserve_plan(None, n_stages=3, partitioner="dp",
                       profile=jsynthetic(costs), **PLAN_KW)
    assert got.summary() == want.summary()
    assert got.partition.boundaries == want.partition.boundaries
    assert got.stage_sizes == want.stage_sizes != (2, 2, 2)
    jcfg = tiny_cfg("granite-8b", n_layers=7, pipe=3)
    got = serve_plan(port_cfg(jcfg), n_stages=3, partitioner="dp",
                     **PLAN_KW)
    want = jserve_plan(jcfg, n_stages=3, partitioner="dp", **PLAN_KW)
    assert got.summary() == want.summary()
    assert got.stage_ranges == want.stage_ranges


# (g) the launcher, end to end on the CPU


def test_launcher_serves_smoke_on_cpu(tmp_path, capsys):
    out = tmp_path / "serve.jsonl"
    rc = tlaunch.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                       "--engine", "simple", "--requests", "4",
                       "--rate", "1.5", "--metrics-out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert text.startswith("# serve_plan[x1 ")
    assert "served 4/4 requests" in text
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    run = [r for r in recs if r["event"] == "serve_run"]
    assert len(run) == 1
    # the JAX launcher's serve_run keys, plus the device
    assert {"arch", "engine", "execution", "n_requests", "n_served",
            "n_rejected", "n_tokens", "rate", "seed", "wall_s",
            "compile_s", "tok_per_s", "token_ms_p50",
            "token_ms_p99", "device"} <= set(run[0])
    assert run[0]["n_served"] == 4 and run[0]["device"] == "cpu"
    summary = recs[-1]
    assert summary["event"] == "summary"
    assert summary["counters"]["serve/nonfinite_logits"] == 0


def test_launcher_reports_time_to_first_token(tmp_path):
    """Every served request's ``serve_request`` event carries its time to
    first token (``ttft_ms``: the prefill and first token, wall)."""
    out = tmp_path / "serve.jsonl"
    rc = tlaunch.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                       "--engine", "simple", "--requests", "3",
                       "--prompt-lens", "20,70",
                       "--prompt-budget", "80", "--page-seq", "96",
                       "--metrics-out", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    reqs = [r for r in recs if r["event"] == "serve_request"]
    assert len(reqs) == 3
    assert all(r["ttft_ms"] > 0 and 20 <= r["prompt_len"] <= 70
               for r in reqs)


def test_launcher_refuses_unported_paths():
    with pytest.raises(SystemExit, match="not per-layer pageable"):
        tlaunch.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                      "--engine", "pipelined"])
    with pytest.raises(SystemExit, match="not per-layer pageable"):
        tlaunch.main(["--arch", "whisper-base", "--smoke", "--device",
                      "cpu", "--engine", "pipelined"])


# (h) no quiet fallback to the CPU


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_cfg("granite-8b")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(port_cfg(cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        from_jax_params({"outer": {}, "stages": ()}, port_cfg(cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--smoke", "--requests", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
