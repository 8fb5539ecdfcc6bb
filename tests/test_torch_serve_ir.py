"""The port's serving IR, its verifier and its continuous batcher against
the JAX package's, run live.

All of it is host-side numpy in both packages, so every comparison is
exact: the serve table's rows, branches and slot counts, the device
streams, every verifier report (on clean artifacts, on every entry of
the mutation catalog and on request traces), and the batcher's poll
arrays and event log round by round, fed the same seeded tokens.
"""
import numpy as np
import pytest

from repro.planner import schedule_ir as jsir
from repro.planner import serve_plan as jserve_plan
from repro.planner import verify as jpv
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro_torch.planner import schedule_ir as sir
from repro_torch.planner import serve_plan
from repro_torch.planner import verify as pv
from repro_torch.serve import ContinuousBatcher, Request, poisson_trace
from test_torch_threads import one_thread  # noqa: F401

GRID = [(S, F) for S in (1, 2, 3, 4) for F in (0, 1, 2, 3)]


def _plans(S, F, **kw):
    kw = dict(dict(n_slots=4, prompt_budget=8, page_seq=32, n_layers=2 * S),
              **kw)
    return (serve_plan(None, n_stages=S, max_prefill=F, **kw),
            jserve_plan(None, n_stages=S, max_prefill=F, **kw))


def _report(rep):
    return (rep.artifact, rep.schedule, rep.n_events, rep.ok,
            tuple((v.check, v.site, v.message) for v in rep.violations),
            dict(rep.stats))


# ---------------------------------------------------------------------------
# the IR


@pytest.mark.parametrize("S,F", GRID)
def test_serve_table_and_streams_equal_jax(S, F):
    tp, jp = _plans(S, F)
    assert tp.serve_events() == jp.serve_events()
    for got, want in ((tp.serve_table(), jp.serve_table()),
                      (tp.serve_streams(), jp.serve_streams())):
        assert got.branches == want.branches
        np.testing.assert_array_equal(got.rows, want.rows)
        assert (got.n_dec_slots, got.n_pf_slots) == \
            (want.n_dec_slots, want.n_pf_slots)
        assert (got.n_chunks, got.max_prefill) == \
            (want.n_chunks, want.max_prefill)
    assert (tp.n_chunks, tp.n_devices) == (jp.n_chunks, jp.n_devices)


def test_lowering_refusals_match_jax():
    for mod in (sir, jsir):
        with pytest.raises(ValueError, match="n_chunks"):
            mod.serve_round_events(0, 1)
        with pytest.raises(ValueError, match="max_prefill"):
            mod.serve_round_events(2, -1)
        ev = mod.serve_round_events(3, 1)
        with pytest.raises(ValueError, match="events"):
            mod.compile_serve_table(ev[:-1], 3, 1)
        with pytest.raises(ValueError, match="one chunk per device"):
            mod.compile_serve_streams(ev, 3, 1, 2)


# ---------------------------------------------------------------------------
# the verifier


@pytest.mark.parametrize("S,F", GRID)
def test_clean_reports_equal_jax(S, F):
    tp, jp = _plans(S, F)
    got = pv.verify_serve_plan(tp)
    want = jpv.verify_serve_plan(jp)
    assert [_report(r) for r in got] == [_report(r) for r in want]
    assert all(r.ok for r in got)
    tp.verify()                        # raises on a violation


@pytest.mark.parametrize("S,F", [(3, 2), (3, 3), (4, 2), (4, 3)])
def test_mutation_catalog_reports_equal_jax(S, F):
    tp, jp = _plans(S, F)
    got = list(pv.serve_mutation_catalog(tp.serve_table(),
                                         tp.serve_streams()))
    want = list(jpv.serve_mutation_catalog(jp.serve_table(),
                                           jp.serve_streams()))
    assert [(n, c) for n, c, _ in got] == [(n, c) for n, c, _ in want]
    assert len(got) >= 8
    for (name, check, bad), (_, _, jbad) in zip(got, want):
        np.testing.assert_array_equal(bad.rows, jbad.rows)
        if isinstance(bad, sir.ServeTable):
            rep, jrep = pv.verify_serve_table(bad), \
                jpv.verify_serve_table(jbad)
        else:
            rep, jrep = pv.verify_serve_streams(bad), \
                jpv.verify_serve_streams(jbad)
        assert _report(rep) == _report(jrep), name
        assert not rep.ok and check in {v.check for v in rep.violations}
    assert pv.serve_self_test(tp) == jpv.serve_self_test(jp)
    assert pv.serve_self_test(tp)[1] == []


def test_check_raises_verification_error():
    tp, _ = _plans(3, 2)
    _, _, bad = next(pv.serve_mutation_catalog(tp.serve_table(),
                                               tp.serve_streams()))
    with pytest.raises(pv.VerificationError, match="slot-hazard"):
        pv.verify_serve_table(bad).raise_on_violation()


def _trace_cases():
    ok = [dict(ev="admit", round=0, rid=0, slot=0, pages=[1, 1],
               prompt_len=2, gen_len=3),
          dict(ev="decode", round=1, rid=0, slot=0),
          dict(ev="decode", round=2, rid=0, slot=0),
          dict(ev="evict", round=2, rid=0, slot=0)]
    yield "clean", ok
    yield "reject-only", [dict(ev="reject", round=0, rid=5)]
    yield "missed decode", [ok[0], ok[1], ok[3]]
    yield "double decode", [ok[0], ok[1], ok[1], ok[2], ok[3]]
    yield "never evicted", ok[:3]
    yield "page still held", ok[:2] + [
        dict(ok[0], rid=1, slot=1)] + ok[2:]
    yield "slot shared", ok[:1] + [dict(ok[0], rid=1, pages=[2, 2])]
    yield "page out of range", [dict(ok[0], pages=[9, 9])]
    yield "wrong stage count", [dict(ok[0], pages=[1])]
    yield "unknown event", [dict(ev="migrate", round=0, rid=0)]
    yield "decode of a dead rid", [dict(ev="decode", round=0, rid=3)]


@pytest.mark.parametrize("name,entries", list(_trace_cases()),
                         ids=[n for n, _ in _trace_cases()])
def test_request_trace_reports_equal_jax(name, entries):
    kw = dict(n_slots=2, n_pages=4, n_stages=2)
    got = pv.verify_request_trace(entries, **kw)
    want = jpv.verify_request_trace(entries, **kw)
    assert _report(got) == _report(want)
    assert got.ok == (name in ("clean", "reject-only"))


# ---------------------------------------------------------------------------
# the continuous batcher


def _drive(batcher_cls, request_cls, splan, trace, seed):
    """Poll and commit until drained, with emitted tokens drawn from a
    seeded generator; returns (per-round poll arrays, events, results)."""
    rng = np.random.default_rng(seed)
    reqs = [request_cls(q.rid, q.arrival, q.prompt, q.gen_len)
            for q in trace]
    sched = batcher_cls(splan, reqs)
    polls, r = [], 0
    while sched.active:
        assert r < 500
        batch = sched.poll(r)
        polls.append((r, {k: v.copy() for k, v in batch.items()},
                      sched.n_round_tokens(), sched.next_arrival()))
        if not sched.n_round_tokens():
            nxt = sched.next_arrival()
            r = max(r + 1, nxt if nxt is not None else r + 1)
            continue
        sched.commit(r, rng.integers(0, 1000, splan.n_slots, np.int32),
                     rng.integers(0, 1000, max(splan.max_prefill, 1),
                                  np.int32))
        r += 1
    return polls, sched.events, sched.results


BATCHER_CASES = {
    # rejections (empty prompt, past the budget, no generation, past the
    # page) between admissible requests
    "rejections": (dict(n_stages=2, n_slots=2, max_prefill=2),
                   [Request(0, 0, (1, 2), 3), Request(1, 0, (), 2),
                    Request(2, 0, (1,) * 9, 2), Request(3, 1, (4,), 0),
                    Request(4, 1, (1,) * 8, 30), Request(5, 1, (7, 8), 2)]),
    # one slot: every later request waits behind the head of the queue
    "head-of-line": (dict(n_stages=3, n_slots=1, max_prefill=2),
                     [Request(0, 0, (1, 2), 4), Request(1, 0, (3,), 1),
                      Request(2, 0, (5, 6, 7), 2)]),
    # two pages for a long seeded trace: pages are recycled many times
    "page reuse": (dict(n_stages=2, n_slots=2, n_pages=2, max_prefill=1),
                   poisson_trace(14, rate=1.2, seed=4, prompt_lens=(1, 8),
                                 gen_lens=(1, 6), vocab=256)),
    # more pages than slots, bursts of arrivals, three lanes
    "bursts": (dict(n_stages=4, n_slots=3, n_pages=5, max_prefill=3),
               poisson_trace(20, rate=2.5, seed=9, prompt_lens=(1, 10),
                             gen_lens=(1, 9), vocab=256)),
}


@pytest.mark.parametrize("name", list(BATCHER_CASES))
def test_batcher_rounds_and_events_equal_jax(name):
    kw, trace = BATCHER_CASES[name]
    kw = dict(dict(prompt_budget=8, page_seq=32, n_layers=4), **kw)
    S = kw.pop("n_stages")
    tp = serve_plan(None, n_stages=S, **kw)
    jp = jserve_plan(None, n_stages=S, **kw)
    got = _drive(ContinuousBatcher, Request, tp, trace, seed=11)
    want = _drive(JBatcher, JRequest, jp, trace, seed=11)
    assert len(got[0]) == len(want[0])
    for (r, b, n, nxt), (jr, jb, jn, jnxt) in zip(got[0], want[0]):
        assert (r, n, nxt) == (jr, jn, jnxt)
        assert b.keys() == jb.keys()
        for k in b:
            assert b[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    assert got[1] == want[1]
    assert got[2] == want[2]
    evs = {e["ev"] for e in got[1]}
    if name == "rejections":
        assert "reject" in evs
    if name == "page reuse":
        admits = [e["pages"][0] for e in got[1] if e["ev"] == "admit"]
        assert len(admits) > 2 * len(set(admits))
    rep = pv.verify_request_trace(got[1], n_slots=tp.n_slots,
                                  n_pages=tp.n_pages, n_stages=S)
    assert rep.ok, rep.violations
