"""Serving engines (twin of ``repro/serve/engine.py``).

:class:`ServeEngine` is the pipelined engine: continuous batching over
request slots and paged KV (``serve/scheduler.py``), each serving round
the planner's :class:`~repro_torch.planner.schedule_ir.ServeTable`
interpreted row by row: a decode arm or a prefill arm per ``(kind,
chunk)`` branch, hidden states handed between chunks through the two
slot pools the table allocates.  The decode wave advances every live
request by one token in one pass over the layers (one paged attention
kernel or one scan kernel a layer for all ``n_slots`` rows), so one
pass's host cost buys up to ``n_slots`` tokens; each prefill lane runs
one admitted prompt through every chunk in one causal call a layer.
All chunks run on one card; the JAX package's ``lax.scan`` interpreter
is this Python loop (``backend="scan"``).

KV state is paged per chunk: chunk ``q`` owns :func:`chunk_page_caches`
buffers of ``n_pages + 1`` pages (the last, the trash page, is where
idle rows compute), a request's state at the same page index in every
chunk, which makes :meth:`ServeEngine.restate` a concat-and-resplit
along the layer axis.

:class:`SimpleEngine` serves each request on its own through the whole
model: the reference the pipelined engine is tested against, and the
engine for hybrid models, whose decode state the stage split cannot
page.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.layers import dtype_of
from repro_torch.models.model import cast_for_compute
from repro_torch.planner import schedule_ir as sir
from repro_torch.serve.scheduler import ContinuousBatcher, admissible

SERVE_BACKENDS = ("scan", "mpmd")


def _unsupported_arch(model, what: str) -> NotImplementedError:
    kind = "encoder-decoder" if model.cfg.is_encdec else "hybrid"
    return NotImplementedError(
        f"{what} does not support {kind} models ({model.cfg.name}): "
        f"their decode state is not a per-layer scan the stage split "
        f"can page; serve them with SimpleEngine (launch/serve.py "
        f"--engine simple)")


def chunk_page_caches(model, sizes: Sequence[int], n_pages: int,
                      page_seq: int):
    """Per-chunk paged caches for the stage split ``sizes``: chunk q's is
    ``Model.init_cache`` over its ``sizes[q]`` layers with the batch axis
    as the page axis (``n_pages + 1`` pages, the last the trash page),
    so each layer's slice is a batch of pages for the kernels: dense
    ``{"layers": {"k", "v": [L_q, n_pages + 1, page_seq, KV, hd]}}``,
    rwkv6 ``{"layers": {"x_tm", "x_cm": [L_q, n_pages + 1, d], "S":
    [L_q, n_pages + 1, H, hd, hd]}}``.  (The JAX twin puts the page axis
    first, ``[n_pages + 1, L_q, 1, ...]``, and also returns fresh init
    slices; here a prefill lane starts fresh in place.)"""
    if model.hybrid or model.cfg.is_encdec:
        raise _unsupported_arch(model, "paged serving")
    full = model.init_cache(n_pages + 1, page_seq)["layers"]
    out, lo = [], 0
    for n in sizes:
        out.append({"layers": {k: a[lo:lo + n].clone()
                               for k, a in full.items()}})
        lo += n
    return tuple(out)


class ServeEngine:
    """Continuous-batching inference through the schedule-IR serving
    round on one device.  Emits, for a given trace, exactly the tokens
    the JAX ``ServeEngine(backend="scan")`` emits for the same weights in
    fp32, and the port's :class:`SimpleEngine`'s.

    ``n_waves`` / ``n_lanes`` count the decode waves and prefill lanes
    run, warm-up included: each wave launches one attention or scan
    kernel per layer for all ``n_slots`` rows, each lane one per layer.
    """

    def __init__(self, model, params, splan, *, backend: str = "scan",
                 registry=None, verify: bool = True):
        if backend not in SERVE_BACKENDS:
            raise ValueError(f"unknown serve backend {backend!r}; "
                             f"choose from {SERVE_BACKENDS}")
        if backend == "mpmd":
            raise NotImplementedError(
                "the mpmd serving backend (one process per stage, hidden "
                "states sent between them) is not ported to PyTorch yet: "
                "it comes with stage-local execution; use backend='scan'")
        if model.cfg.is_encdec or model.hybrid:
            raise _unsupported_arch(model, "the pipelined ServeEngine")
        self.model, self.splan, self.backend = model, splan, backend
        self.registry = registry
        self.verify = verify
        if verify:
            splan.verify(device_streams=False)
        params = cast_for_compute(params, dtype_of(model.cfg.compute_dtype))
        self._outer = params["outer"]
        sizes = splan.stage_sizes
        self._chunks = model.partition_stage_params(
            params["stages"], sizes, n_chunks=len(sizes))
        self.device = model.device
        self.n_waves = 0
        self.n_lanes = 0
        self.last_events: List[Dict[str, Any]] = []
        self._build(sizes)

    def _build(self, sizes) -> None:
        splan = self.splan
        self._sizes = tuple(sizes)
        self._table = splan.serve_table()
        self._caches = chunk_page_caches(self.model, sizes, splan.n_pages,
                                         splan.page_seq)
        self._warm = False

    # ------------------------------------------------------------ one round
    def _round(self, batch: Dict[str, np.ndarray]):
        """Run one round of the table on ``batch`` (a
        :meth:`ContinuousBatcher.poll`); returns (dec_next [n_slots],
        pf_next [max(max_prefill, 1)]) int32 on the host and the count of
        non-finite logits of the live rows (a device scalar)."""
        model, table, dev = self.model, self._table, self.device
        outer, chunks, caches = self._outer, self._chunks, self._caches
        vocab = model.cfg.vocab_size
        C = table.n_chunks
        live = batch["dec_pages"] < self.splan.n_pages
        wave = bool(live.any())
        pf_len, pf_pages = batch["pf_len"], batch["pf_pages"]
        if wave:
            self._check_rows(batch)
            self.n_waves += 1
            dec = torch.from_numpy(np.stack(
                [batch["dec_tokens"], batch["dec_pos"], batch["dec_pages"],
                 live.astype(np.int32)])).to(dev)
            toks, pos, pages = dec[0].long(), dec[1], dec[2]
        dec_pool: List[Optional[torch.Tensor]] = [None] * table.n_dec_slots
        pf_pool: List[Optional[torch.Tensor]] = [None] * table.n_pf_slots
        R = len(live)
        nxt = torch.zeros(R + len(pf_len), dtype=torch.long, device=dev)
        bad = torch.zeros((), dtype=torch.long, device=dev)
        for row in table.rows.tolist():
            kind, q = table.branches[row[sir.SCOL_BRANCH]]
            a, b = row[sir.SCOL_A], row[sir.SCOL_B]
            if kind == sir.DECODE:
                if not wave:
                    continue
                if q == 0:
                    x = model.decode_embed(outer, toks[:, None],
                                           pos[:, None])
                else:
                    x, dec_pool[a] = dec_pool[a], None
                y = model.stage_decode(chunks[q], caches[q], x, pos, pages)
                if q < C - 1:
                    dec_pool[b] = y
                    continue
                logits = model.logits(outer, y)[:, 0, :vocab]
                bad += (~torch.isfinite(logits[dec[3].bool()])).sum()
                nxt[:R] = torch.argmax(logits, -1)
                continue
            j = row[sir.SCOL_MB]
            n = int(pf_len[j])
            if n == 0:                         # an idle lane
                continue
            if q == 0:
                self.n_lanes += 1
                toks_j = torch.from_numpy(
                    batch["pf_tokens"][j, :n].astype(np.int64)).to(dev)
                x = model.decode_embed(
                    outer, toks_j[None],
                    torch.arange(n, device=dev)[None])
            else:
                x, pf_pool[a] = pf_pool[a], None
            y = model.stage_prefill(chunks[q], caches[q], x,
                                    int(pf_pages[j]))
            if q < C - 1:
                pf_pool[b] = y
                continue
            # all n rows, as SimpleEngine's prefill: the head's GEMM
            # then has its shape, and bf16 rounds the last row alike
            logits = model.logits(outer, y)[0, -1, :vocab]
            bad += (~torch.isfinite(logits)).sum()
            nxt[R + j] = torch.argmax(logits)
        got = nxt.cpu().numpy().astype(np.int32)     # one copy, one sync
        return got[:R], got[R:], bad

    def _check_rows(self, batch: Dict[str, np.ndarray]) -> None:
        """Raise unless every wave row's page lies in ``[0, n_pages]`` and
        its position in ``[0, page_seq)``: the ranges the paged kernel
        call relies on, checked here on the host, once a round, so the
        call need not read them back from the card once a layer."""
        n_pages, page_seq = self.splan.n_pages, self.splan.page_seq
        pages, pos = batch["dec_pages"], batch["dec_pos"]
        if ((pages < 0) | (pages > n_pages) | (pos < 0)
                | (pos >= page_seq)).any():
            raise ValueError(
                f"decode rows outside pages [0, {n_pages}] or positions "
                f"[0, {page_seq - 1}]: pages {pages.tolist()}, positions "
                f"{pos.tolist()}")

    def _warm_up(self) -> float:
        """Build the model's kernels and run one round, a decode wave and
        a prefill lane, on throwaway pages, so reported latencies exclude
        both (the JAX twin's compile-time exclusion)."""
        splan = self.splan
        R, F, P = splan.n_slots, max(splan.max_prefill, 1), \
            splan.prompt_budget
        t0 = time.time()
        with torch.inference_mode():
            if self.device.type == "cuda":
                for mod in self.model.kernel_modules():
                    mod.load()
            dec_pages = np.full((R,), splan.n_pages, np.int32)
            dec_pages[0] = 0
            pf_len = np.zeros((F,), np.int32)
            pf_len[0] = 1
            batch = {"dec_tokens": np.zeros((R,), np.int32),
                     "dec_pos": np.zeros((R,), np.int32),
                     "dec_pages": dec_pages,
                     "pf_tokens": np.zeros((F, P), np.int32),
                     "pf_len": pf_len,
                     "pf_pages": np.zeros((F,), np.int32)}
            real = self._caches
            self._caches = chunk_page_caches(self.model, self._sizes,
                                             splan.n_pages, splan.page_seq)
            try:
                self._round(batch)
            finally:
                self._caches = real
        compile_s = time.time() - t0
        self._warm = True
        if self.registry is not None:
            self.registry.gauge("serve/compile_s").set(compile_s)
        return compile_s

    # ------------------------------------------------------------ execution
    def run(self, requests, *, max_rounds: Optional[int] = None
            ) -> Dict[int, tuple]:
        """Drive the trace to completion; returns ``{rid: tokens}``
        (rejected requests map to ``()``).  The scheduler event log of
        the last run is kept on ``self.last_events`` for
        ``verify_request_trace``."""
        if self.splan.max_prefill < 1 and requests:
            raise ValueError("max_prefill=0 can never admit a request")
        if not self._warm:
            self._warm_up()
        sched = ContinuousBatcher(self.splan, requests,
                                  registry=self.registry)
        limit = max_rounds if max_rounds is not None else (
            max((q.arrival for q in requests), default=0)
            + sum(max(q.gen_len, 1) for q in requests) + len(requests)
            + 8)
        hist = (self.registry.histogram("serve/token_ms")
                if self.registry is not None else None)
        r, n_tokens, busy_s = 0, 0, 0.0
        bad = torch.zeros((), dtype=torch.long, device=self.device)
        with torch.inference_mode():
            while sched.active:
                if r > limit:
                    raise RuntimeError(
                        f"serving exceeded {limit} rounds with "
                        f"{len(sched.live)} live and {len(sched.queue)} "
                        f"queued requests — admission is stuck")
                batch = sched.poll(r)
                if not sched.n_round_tokens():
                    nxt = sched.next_arrival()
                    r = max(r + 1, nxt if nxt is not None else r + 1)
                    continue
                t0 = time.time()
                dec_next, pf_next, round_bad = self._round(batch)
                dt_s = time.time() - t0         # the tokens' copy synced
                bad += round_bad
                toks = sched.n_round_tokens()
                busy_s += dt_s
                n_tokens += toks
                if hist is not None:
                    for _ in range(toks):
                        hist.observe(dt_s * 1e3)
                sched.commit(r, dec_next, pf_next)
                r += 1
        self.last_events = sched.events
        if self.registry is not None:
            if busy_s > 0:
                self.registry.gauge("serve/decode_tok_per_s").set(
                    n_tokens / busy_s)
            self.registry.counter("serve/nonfinite_logits").inc(int(bad))
            self.registry.gauge("serve/wave_calls").set(self.n_waves)
            self.registry.gauge("serve/lane_calls").set(self.n_lanes)
            self.registry.gauge("serve/rounds").set(r)
        return dict(sched.results)

    # -------------------------------------------------------------- elastic
    def restate(self, new_splan) -> None:
        """Repartition onto ``new_splan``'s stage split between runs:
        stage weights regroup by flat layer order and the paged buffers
        concat-and-resplit along the layer axis, so every request's state
        stays at its page index and the emitted tokens are unchanged.
        Page geometry must match."""
        old = self.splan
        for f in ("n_slots", "max_prefill", "prompt_budget", "n_pages",
                  "page_seq"):
            if getattr(old, f) != getattr(new_splan, f):
                raise ValueError(
                    f"restate cannot change {f} "
                    f"({getattr(old, f)} -> {getattr(new_splan, f)}): "
                    f"page geometry is carried state")
        if self.verify:
            new_splan.verify(device_streams=False)
        full = {k: torch.cat([c["layers"][k] for c in self._caches], 0)
                for k in self._caches[0]["layers"]}
        new_sizes = new_splan.stage_sizes
        self._chunks = self.model.partition_stage_params(
            self._chunks, new_sizes, n_chunks=len(new_sizes))
        self.splan = new_splan
        self._sizes = tuple(new_sizes)
        self._table = new_splan.serve_table()
        carried, lo = [], 0
        for n in new_sizes:
            carried.append({"layers": {k: a[lo:lo + n]
                                       for k, a in full.items()}})
            lo += n
        self._caches = tuple(carried)
        if self.registry is not None:
            self.registry.emit("serve_restate", sizes=list(new_sizes),
                               backend=self.backend)


class SimpleEngine:
    """Each request prefills and decodes on its own through the whole
    model, with the JAX twin's admission and greedy argmax over the
    first ``vocab_size`` logits, so the two emit the same tokens.

    Prefill is one causal :meth:`Model.prefill` over the request's prompt
    into a fresh cache (for rwkv6 and mamba2 one scan-kernel call per
    layer over the whole prompt); decoding then runs
    :meth:`Model.decode_step` token by token.  Weights are cast to the
    compute dtype once, here (the fp32 leaves stay fp32).
    Reported latencies exclude a warm-up that builds the model's kernels
    and runs one prefill and one decode, as the JAX engine's exclude
    compilation; on the card every timed region ends in a synchronise.
    Each request's ``serve_request`` event carries ``ttft_ms``, the wall
    of its prefill and first token (its time to first token).

    ``n_prefill`` / ``n_decode`` count the model calls made, warm-up
    included (each runs every layer's attention or scan once, and each
    of a hybrid model's shared-block calls)."""

    def __init__(self, model, params, splan, *, registry=None):
        self.model, self.splan = model, splan
        self.params = cast_for_compute(params,
                                       dtype_of(model.cfg.compute_dtype))
        self.registry = registry
        self.device = model.device
        self._warm = False
        self.n_prefill = 0
        self.n_decode = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, toks) -> torch.Tensor:
        return torch.tensor([list(toks)], dtype=torch.long,
                            device=self.device)

    def _prefill(self, prompt):
        self.n_prefill += 1
        return self.model.prefill(self.params,
                                  {"tokens": self._tokens(prompt)},
                                  self.splan.page_seq)

    def _decode(self, cache, tok: int, pos: int):
        self.n_decode += 1
        return self.model.decode_step(self.params, cache,
                                      self._tokens([tok]), pos)

    def _warm_up(self) -> None:
        """Build the model's kernels and run one prefill and one decode
        on a throwaway cache, so reported latencies exclude both."""
        t0 = time.time()
        with torch.inference_mode():
            if self.device.type == "cuda":
                for mod in self.model.kernel_modules():
                    mod.load()
            _, cache = self._prefill([0])
            self._decode(cache, 0, 1)
            self._sync()
        self._warm = True
        if self.registry is not None:
            self.registry.gauge("serve/compile_s").set(time.time() - t0)

    def run(self, requests) -> Dict[int, tuple]:
        """Serve every request in arrival order; returns ``{rid:
        tokens}`` (rejected requests map to ``()``)."""
        vocab = self.model.cfg.vocab_size
        if not self._warm:
            self._warm_up()
        hist = (self.registry.histogram("serve/token_ms")
                if self.registry is not None else None)
        results: Dict[int, tuple] = {}
        with torch.inference_mode():
            bad = torch.zeros((), dtype=torch.long, device=self.device)
            for req in sorted(requests, key=lambda q: (q.arrival, q.rid)):
                if not admissible(req, self.splan):
                    results[req.rid] = ()
                    continue
                t0 = time.time()
                logits, cache = self._prefill(req.prompt)
                row = logits[0, -1, :vocab]
                bad += (~torch.isfinite(row)).sum()
                toks = [int(torch.argmax(row))]
                self._sync()
                ttft_ms = (time.time() - t0) * 1e3
                if hist is not None:
                    hist.observe(ttft_ms)
                pos = len(req.prompt)
                while len(toks) < req.gen_len:
                    t0 = time.time()
                    logits, cache = self._decode(cache, toks[-1], pos)
                    row = logits[0, -1, :vocab]
                    bad += (~torch.isfinite(row)).sum()
                    toks.append(int(torch.argmax(row)))
                    pos += 1
                    self._sync()
                    if hist is not None:
                        hist.observe((time.time() - t0) * 1e3)
                results[req.rid] = tuple(toks)
                if self.registry is not None:
                    self.registry.emit("serve_request", rid=req.rid,
                                       prompt_len=len(req.prompt),
                                       gen=req.gen_len, ttft_ms=ttft_ms)
        if self.registry is not None:
            self.registry.counter("serve/nonfinite_logits").inc(int(bad))
            self.registry.gauge("serve/prefill_calls").set(self.n_prefill)
            self.registry.gauge("serve/decode_calls").set(self.n_decode)
        return results
