"""The port's pipelined ``ServeEngine`` against the JAX package's, run live.

Weights are the JAX model's, carried over by
``repro_torch.models.from_jax_params``; everything runs on the CPU in
fp32, the JAX side as ``tests/test_serve.py`` runs it.  Module-scoped
fixtures build each JAX engine once.

Tolerances:
  * 2e-5 for the paged attention's plain version against JAX
    ``_attend`` applied row by row (the same fp32 softmax, another
    summation order);
  * 1e-5 for one chunk's decode wave and prefill lane against JAX
    ``_decode_chunk`` / ``_prefill_chunk``: hidden states and every live
    page's cache or state (the prefill lane is one causal call a layer
    here and a stepwise scan there);
  * exact tokens for the engines.

The load-bearing claims: the port's ``ServeEngine(backend="scan")``
emits exactly the JAX ``ServeEngine(backend="scan")``'s tokens for
granite and rwkv6, with page recycling, and its own ``SimpleEngine``'s;
the stage split and a restate between runs change no token; and the
scheduler's request log verifies clean.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models import Model as JModel
from repro.models.attention import _attend as jattend
from repro.planner import serve_plan as jserve_plan
from repro.serve import ServeEngine as JServeEngine
from repro.serve import engine as jengine
from repro.serve import poisson_trace as jpoisson_trace
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import Model, from_jax_params
from repro_torch.planner import serve_plan
from repro_torch.planner import verify as pv
from repro_torch.serve import (Request, ServeEngine, SimpleEngine,
                               chunk_page_caches, poisson_trace)
from test_torch_model import port_cfg
from test_torch_threads import one_thread  # noqa: F401

PLAN_KW = dict(n_slots=4, max_prefill=2, prompt_budget=8, page_seq=32,
               n_layers=4)
ATTN_TOL = 2e-5
CHUNK_TOL = 1e-5


def _splans(n_stages=2, **kw):
    merged = dict(PLAN_KW, **kw)
    return (serve_plan(None, n_stages=n_stages, **merged),
            jserve_plan(None, n_stages=n_stages, **merged))


def _pair(arch, seed):
    jc = tiny_cfg(arch, n_layers=4, pipe=2)
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    tc = port_cfg(jc)
    tm = Model(tc, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jm, jp, tm, tp


def _same_trace(trace):
    """The JAX trace as the port's requests."""
    return [Request(q.rid, q.arrival, q.prompt, q.gen_len) for q in trace]


@pytest.fixture(scope="module")
def granite():
    """The JAX granite pair, ``tests/test_serve.py``'s trace8 and the JAX
    scan engine's tokens on it (2 stages), and on a trace that recycles
    two pages through two slots."""
    jm, jp, tm, tp = _pair("granite-8b", 0)
    trace8 = jpoisson_trace(8, rate=0.7, seed=3, prompt_lens=(1, 8),
                            gen_lens=(1, 6), vocab=jm.cfg.vocab_size)
    want = JServeEngine(jm, jp, _splans()[1], backend="scan").run(trace8)
    recycle = jpoisson_trace(10, rate=1.5, seed=8, prompt_lens=(1, 8),
                             gen_lens=(1, 6), vocab=jm.cfg.vocab_size)
    jrec = _splans(n_slots=2, n_pages=2)[1]
    want_recycle = JServeEngine(jm, jp, jrec, backend="scan").run(recycle)
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, trace8=_same_trace(trace8),
                want=want, recycle=_same_trace(recycle),
                want_recycle=want_recycle)


@pytest.fixture(scope="module")
def rwkv6():
    jm, jp, tm, tp = _pair("rwkv6-7b", 1)
    trace = jpoisson_trace(6, rate=0.8, seed=5, prompt_lens=(1, 6),
                           gen_lens=(1, 4), vocab=jm.cfg.vocab_size)
    want = JServeEngine(jm, jp, _splans()[1], backend="scan").run(trace)
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, trace=_same_trace(trace),
                want=want)


# ---------------------------------------------------------------------------
# the paged attention's plain version


@pytest.mark.parametrize("R,H,KV,d", [(1, 4, 1, 16), (3, 8, 2, 64),
                                      (8, 4, 4, 128)])
def test_paged_plain_version_matches_attend_row_by_row(R, H, KV, d):
    """Ragged lengths (1, the page, and between), rows sharing the trash
    page, and a page shared by no live row: each row is JAX ``_attend``
    on its own page at its own length."""
    rng = np.random.default_rng(R)
    n_pages, page_seq = 5, 17
    q = rng.standard_normal((R, 1, H, d), dtype=np.float32)
    kp = rng.standard_normal((n_pages + 1, page_seq, KV, d),
                             dtype=np.float32)
    vp = rng.standard_normal((n_pages + 1, page_seq, KV, d),
                             dtype=np.float32)
    pages = np.full((R,), n_pages, np.int32)          # the trash page
    lens = np.ones((R,), np.int32)
    live = rng.permutation(n_pages)[:max(R - 2, 1)]
    pages[:len(live)] = live
    lens[:len(live)] = rng.choice([1, 9, page_seq], len(live))
    o = ops.flash_attention_paged(*(torch.from_numpy(a) for a in
                                    (q, kp, vp, pages, lens)))
    jcfg = tiny_cfg("granite-8b")
    for r in range(R):
        want = jattend(jcfg, jnp.asarray(q[r:r + 1]),
                       jnp.asarray(kp[pages[r]][None]),
                       jnp.asarray(vp[pages[r]][None]), causal=False,
                       q_pos=jnp.zeros((1,), jnp.int32), k_len=page_seq,
                       k_valid_len=int(lens[r]))
        np.testing.assert_allclose(o[r:r + 1].numpy(), np.asarray(want),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)


def test_paged_call_refuses_out_of_range_rows():
    q = torch.zeros(2, 1, 4, 16)
    kp = torch.zeros(3, 8, 2, 16)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    for pages, lens in ((i32(0, 3), i32(1, 1)), (i32(-1, 0), i32(1, 1)),
                        (i32(0, 2), i32(0, 1)), (i32(0, 2), i32(1, 9))):
        with pytest.raises(ValueError, match="outside"):
            ops.flash_attention_paged(q, kp, kp, pages, lens)
    with pytest.raises(ValueError, match="int32"):
        ops.flash_attention_paged(q, kp, kp, i32(0, 1).long(), i32(1, 1))
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# one chunk: the decode wave and a prefill lane


def _fill_pages(rng, jcache, tcache):
    """Random contents in every page of both layouts: JAX [n_pages + 1,
    L, 1, ...], the port [L, n_pages + 1, ...]."""
    out = {}
    for k, a in jcache["layers"].items():
        v = rng.standard_normal(a.shape, dtype=np.float32)
        if k == "S":
            v *= 0.3
        out[k] = v
        tcache["layers"][k].copy_(torch.from_numpy(
            np.ascontiguousarray(np.swapaxes(v[:, :, 0], 0, 1))))
    return {"layers": {k: jnp.asarray(v) for k, v in out.items()}}


def _port_layout(a):
    """[n_pages + 1, L, 1, ...] -> [L, n_pages + 1, ...]"""
    return np.swapaxes(np.asarray(a)[:, :, 0], 0, 1)


@pytest.mark.parametrize("which", ["granite", "rwkv6"])
@pytest.mark.parametrize("q", [0, 1])
def test_chunk_matches_jax(request, which, q):
    pair = request.getfixturevalue(which)
    jm, jp, tm, tp = pair["jm"], pair["jp"], pair["tm"], pair["tp"]
    n_pages, page_seq, R, d = 5, 16, 4, jm.cfg.d_model
    sizes = (2, 2)
    jchunks = jm.partition_stage_params(jp["stages"], sizes, n_chunks=2)
    tchunks = tm.partition_stage_params(tp["stages"], sizes, n_chunks=2)
    jcaches, jinit = jengine.chunk_page_caches(jm, sizes, n_pages,
                                               page_seq)
    tcaches = chunk_page_caches(tm, sizes, n_pages, page_seq)
    rng = np.random.default_rng(7 + q)
    jc = _fill_pages(rng, jcaches[q], tcaches[q])

    # the wave: three live rows at ragged positions, one on the trash page
    pages = np.array([3, 0, n_pages, 4], np.int32)
    pos = np.array([9, 0, 0, page_seq - 1], np.int32)
    live = pages < n_pages
    x = rng.standard_normal((R, 1, d), dtype=np.float32)
    jy, jnew = jengine._decode_chunk(jm, jchunks[q], jc, jnp.asarray(x),
                                     jnp.asarray(pos), jnp.asarray(pages))
    ty = tm.stage_decode(tchunks[q], tcaches[q], torch.from_numpy(x),
                         torch.from_numpy(pos), torch.from_numpy(pages))
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live],
                               atol=CHUNK_TOL, rtol=CHUNK_TOL)
    for k, a in jnew["layers"].items():
        np.testing.assert_allclose(
            tcaches[q]["layers"][k].numpy()[:, :n_pages],
            _port_layout(a)[:, :n_pages], atol=CHUNK_TOL, rtol=CHUNK_TOL,
            err_msg=k)

    # a prefill lane into a recycled page (it starts fresh)
    page, n, P = 3, 6, 8
    xs = rng.standard_normal((1, P, d), dtype=np.float32)
    jys, jnew2 = jengine._prefill_chunk(jm, jchunks[q], jinit[q], jnew,
                                        jnp.asarray(xs), n, page)
    tys = tm.stage_prefill(tchunks[q], tcaches[q],
                           torch.from_numpy(xs[:, :n]), page)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys)[:, :n],
                               atol=CHUNK_TOL, rtol=CHUNK_TOL)
    for k, a in jnew2["layers"].items():
        got = tcaches[q]["layers"][k].numpy()[:, :n_pages]
        want = _port_layout(a)[:, :n_pages]
        if k in ("k", "v"):        # past n the page is masked, not zeroed
            got, want = got[:, :, :n], want[:, :, :n]
        np.testing.assert_allclose(got, want, atol=CHUNK_TOL,
                                   rtol=CHUNK_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the engine


def test_engine_tokens_equal_jax_and_simple(granite):
    tm, tp, trace = granite["tm"], granite["tp"], granite["trace8"]
    splan = _splans()[0]
    ops.reset_launch_counts()
    eng = ServeEngine(tm, tp, splan)
    got = eng.run(trace)
    assert got == granite["want"]
    assert any(got.values())
    assert got == SimpleEngine(tm, tp, splan).run(trace)
    rep = pv.verify_request_trace(eng.last_events, n_slots=splan.n_slots,
                                  n_pages=splan.n_pages,
                                  n_stages=splan.n_stages)
    assert rep.ok, rep.violations
    # one wave per round with a live slot, one lane per admission, plus
    # the warm-up's one of each; the CPU path launches no kernel
    ev = eng.last_events
    assert eng.n_waves == 1 + len({e["round"] for e in ev
                                   if e["ev"] == "decode"})
    assert eng.n_lanes == 1 + sum(e["ev"] == "admit" for e in ev)
    assert set(ops.launch_counts().values()) == {0}


def test_stage_split_and_restate_keep_tokens(granite):
    tm, tp, trace = granite["tm"], granite["tp"], granite["trace8"]
    want = granite["want"]
    for S in (1, 3, 4):
        splan = serve_plan(None, n_stages=S, **PLAN_KW)
        assert ServeEngine(tm, tp, splan).run(trace) == want
    eng = ServeEngine(tm, tp, _splans()[0])
    early = [q for q in trace if q.arrival <= 2]
    late = [q for q in trace if q.arrival > 2]
    r1 = eng.run(early)
    eng.restate(serve_plan(None, n_stages=4, **PLAN_KW))
    assert eng.splan.stage_sizes == (1, 1, 1, 1)
    r2 = eng.run(late)
    assert {**r1, **r2} == want


def test_recycled_pages_equal_jax(granite):
    tm, tp = granite["tm"], granite["tp"]
    splan = _splans(n_slots=2, n_pages=2)[0]
    eng = ServeEngine(tm, tp, splan)
    got = eng.run(granite["recycle"])
    assert got == granite["want_recycle"]
    admits = [e["pages"][0] for e in eng.last_events if e["ev"] == "admit"]
    assert len(admits) > 2 * len(set(admits))          # pages reused
    assert pv.verify_request_trace(eng.last_events, n_slots=2, n_pages=2,
                                   n_stages=2).ok


def test_rwkv6_tokens_equal_jax_and_simple(rwkv6):
    tm, tp, trace = rwkv6["tm"], rwkv6["tp"], rwkv6["trace"]
    splan = _splans()[0]
    eng = ServeEngine(tm, tp, splan)
    got = eng.run(trace)
    assert got == rwkv6["want"]
    assert got == SimpleEngine(tm, tp, splan).run(trace)
    assert ServeEngine(tm, tp, _splans(4)[0]).run(trace) == got
    assert pv.verify_request_trace(eng.last_events, n_slots=4, n_pages=4,
                                   n_stages=2).ok


def test_refusals(granite):
    tm, tp = granite["tm"], granite["tp"]
    eng = ServeEngine(tm, tp, _splans()[0])
    with pytest.raises(ValueError, match="page_seq"):
        eng.restate(_splans(page_seq=64)[0])
    with pytest.raises(ValueError, match="mpmd"):   # no stage group
        ServeEngine(tm, tp, _splans()[0], backend="mpmd")
    with pytest.raises(ValueError, match="backend"):
        ServeEngine(tm, tp, _splans()[0], backend="xla")
    zc = port_cfg(tiny_cfg("zamba2-1.2b", n_layers=4, pipe=2))
    zm = Model(zc, device="cpu")
    with pytest.raises(NotImplementedError, match="SimpleEngine"):
        ServeEngine(zm, {"outer": {}, "stages": ()}, _splans()[0])
    with pytest.raises(NotImplementedError, match="SimpleEngine"):
        chunk_page_caches(zm, (2, 2), 4, 16)
    with pytest.raises(NotImplementedError, match="SimpleEngine"):
        zm.stage_decode(None, None, None, None, None)
    with pytest.raises(ValueError, match="max_prefill=0"):
        ServeEngine(tm, tp, _splans(max_prefill=0)[0]).run(
            [Request(0, 0, (1,), 1)])


@pytest.mark.parametrize("field,value", [("dec_pages", -1),
                                         ("dec_pages", 5),
                                         ("dec_pos", -1),
                                         ("dec_pos", 32)])
def test_round_refuses_out_of_range_rows(granite, field, value):
    """The wave's ranges are checked on the host once a round, before
    the upload (the paged kernel call then skips its device check)."""
    splan = _splans()[0]
    eng = ServeEngine(granite["tm"], granite["tp"], splan)
    R, F = splan.n_slots, splan.max_prefill
    batch = {"dec_tokens": np.ones((R,), np.int32),
             "dec_pos": np.zeros((R,), np.int32),
             "dec_pages": np.arange(R, dtype=np.int32),
             "pf_tokens": np.zeros((F, splan.prompt_budget), np.int32),
             "pf_len": np.zeros((F,), np.int32),
             "pf_pages": np.full((F,), splan.n_pages, np.int32)}
    eng._round(batch)
    batch[field][1] = value
    with pytest.raises(ValueError, match="outside"):
        eng._round(batch)


def test_metrics_and_event_stream(granite):
    from repro_torch.obs import MetricsRegistry
    tm, tp, trace = granite["tm"], granite["tp"], granite["trace8"]
    reg = MetricsRegistry()
    eng = ServeEngine(tm, tp, _splans()[0], registry=reg)
    got = eng.run(trace)
    n_tokens = sum(len(t) for t in got.values())
    hist = reg.histogram("serve/token_ms")
    assert hist.count == n_tokens and hist.percentile(50.0) > 0
    assert reg.gauge("serve/decode_tok_per_s").value > 0
    assert reg.gauge("serve/compile_s").value > 0
    assert reg.counter("serve/nonfinite_logits").value == 0
    # the JAX twin's batcher emits each decision on the registry
    assert [{k: v for k, v in r.items() if k not in ("event", "t")}
            for r in reg.find("serve_sched")] == eng.last_events


# ---------------------------------------------------------------------------
# the launcher


def test_launcher_pipelined_and_auto(tmp_path, capsys):
    out = tmp_path / "serve.jsonl"
    rc = tlaunch.main(["--engine", "pipelined", "--device", "cpu",
                       "--smoke", "--requests", "6", "--rate", "1.5",
                       "--layers", "4", "--pipe", "2", "--slots", "3",
                       "--max-prefill", "2", "--pages", "4",
                       "--metrics-out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert text.startswith("# serve_plan[x2 part=uniform:(2, 2) slots=3 "
                           "prefill=2 P=16 pages=4x64]")
    assert "engine=pipelined" in text and "served 6/6 requests" in text
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    run = [r for r in recs if r["event"] == "serve_run"][-1]
    assert run["engine"] == "pipelined" and run["execution"] == "scan"
    events = [{k: v for k, v in r.items() if k not in ("event", "t")}
              for r in recs if r["event"] == "serve_sched"]
    assert pv.verify_request_trace(events, n_slots=3, n_pages=4,
                                   n_stages=2).ok
    assert recs[-1]["counters"]["serve/nonfinite_logits"] == 0
    rc = tlaunch.main(["--arch", "zamba2-1.2b", "--device", "cpu",
                       "--smoke", "--requests", "2"])
    assert rc == 0
    assert "engine=simple" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--engine simple"):
        tlaunch.main(["--arch", "zamba2-1.2b", "--device", "cpu",
                      "--smoke", "--engine", "pipelined"])
    with pytest.raises(RuntimeError, match="exceeded 1 rounds"):
        tlaunch.main(["--device", "cpu", "--smoke", "--requests", "4",
                      "--max-rounds", "1"])

