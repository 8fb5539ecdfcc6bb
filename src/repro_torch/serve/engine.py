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
With ``backend="scan"`` all chunks run on one card, and the JAX
package's ``lax.scan`` interpreter is this Python loop.  With
``backend="mpmd"`` each chunk is one process of a stage group (the JAX
twin's ``make_mpmd_round``): rank 0 owns the batcher and sends each
round's descriptor to every rank, each rank walks its column of
``splan.serve_streams()`` over its own chunk's paged cache, the decode
``[R, 1, d]`` and prefill ``[1, n, d]`` hiddens ride the forward ring,
and the last chunk's rank returns the emitted tokens to rank 0; a stop
descriptor ends the other ranks' loops.  Both backends run the same
per-chunk calls at the same shapes, so they emit the same tokens.

KV state is paged per chunk: chunk ``q`` owns :func:`chunk_page_caches`
buffers of ``n_pages + 1`` pages (the last, the trash page, is where
idle rows compute), a request's state at the same page index in every
chunk, which makes :meth:`ServeEngine.restate` a concat-and-resplit
along the layer axis.

:class:`SimpleEngine` serves each request on its own through the whole
model: the reference the pipelined engine is tested against, and the
engine for hybrid and encoder-decoder models, whose decode state the
stage split cannot page.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.layers import dtype_of, tree_map
from repro_torch.models.model import cast_for_compute
from repro_torch.planner import schedule_ir as sir
from repro_torch.runtime import sharding as rsh
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
    ``{"layers": {"k", "v": [L_q, n_pages + 1, page_seq, KV, hd]}}`` (MLA
    ``{"c_kv": [..., page_seq, rank], "k_rope": [..., page_seq, rope]}``),
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


def pack_serve_caches(caches, sizes: Sequence[int]):
    """Per-chunk paged caches -> one dense tree: every leaf
    ``[L_q, n_pages + 1, ...]`` zero-padded to ``Lmax`` layers and
    stacked to ``[S, Lmax, n_pages + 1, ...]`` (the JAX twin stacks its
    page-first chunk leaves the same way, to ``[S, n_pages + 1, Lmax,
    ...]``).  An interchange format: each rank of the mpmd backend holds
    its own chunk's cache unpadded."""
    Lmax = max(sizes)
    trees = [c["layers"] for c in caches]

    def leaf(path, a0):
        out = a0.new_zeros((len(trees), Lmax) + tuple(a0.shape[1:]))
        for q, t in enumerate(trees):
            a = t
            for k in path:
                a = a[k]
            out[q, :a.shape[0]] = a
        return out
    return {"layers": tree_map(leaf, trees[0])}


def unpack_serve_caches(packed, sizes: Sequence[int]):
    """Inverse of :func:`pack_serve_caches` (padding layers dropped;
    views)."""
    return tuple({"layers": tree_map(lambda _, a, q=q: a[q, :sizes[q]],
                                     packed["layers"])}
                 for q in range(len(sizes)))


_DESC_KEYS = ("dec_tokens", "dec_pos", "dec_pages", "pf_tokens", "pf_len",
              "pf_pages")


class ServeEngine:
    """Continuous-batching inference through the schedule-IR serving
    round on one device.  Emits, for a given trace, exactly the tokens
    the JAX ``ServeEngine(backend="scan")`` emits for the same weights in
    fp32, and the port's :class:`SimpleEngine`'s.

    ``n_waves`` / ``n_lanes`` count the decode waves and prefill lanes
    run (on this rank, under mpmd), warm-up included: each wave launches
    one attention or scan kernel per layer for all ``n_slots`` rows,
    each lane one per layer.

    ``backend="mpmd"`` needs this rank's ``group`` (a
    :class:`~repro_torch.runtime.sharding.StageGroup` of
    ``splan.n_stages`` ranks, every rank constructing the engine with
    the same ``params``): the rank keeps its chunk and the outer leaves
    it reads.  Every rank calls :meth:`run`; rank 0's ``requests`` are
    served, and the other ranks follow its descriptors and return
    ``{}``.  ``restate`` is not ported under mpmd.
    """

    def __init__(self, model, params, splan, *, backend: str = "scan",
                 group=None, registry=None, verify: bool = True):
        if backend not in SERVE_BACKENDS:
            raise ValueError(f"unknown serve backend {backend!r}; "
                             f"choose from {SERVE_BACKENDS}")
        if model.cfg.is_encdec or model.hybrid:
            raise _unsupported_arch(model, "the pipelined ServeEngine")
        if backend == "mpmd":
            if group is None:
                raise ValueError(
                    "backend='mpmd' runs one process per stage and needs "
                    "this rank's group= (made by repro_torch.launch.mesh."
                    "run_stage_ranks)")
            if group.world != splan.n_stages:
                raise ValueError(f"the serve plan has {splan.n_stages} "
                                 f"stages, the group {group.world} ranks")
            if model.device != group.device:
                raise ValueError(f"model on {model.device}, rank "
                                 f"{group.rank} on {group.device}")
        self.model, self.splan, self.backend = model, splan, backend
        self.group = group
        self.registry = registry
        self.verify = verify
        if verify:
            splan.verify(device_streams=(backend == "mpmd"))
        params = cast_for_compute(params, dtype_of(model.cfg.compute_dtype))
        sizes = splan.stage_sizes
        C = len(sizes)
        if backend == "mpmd":
            part = rsh.rank_part(model, params, sizes, group.rank, C,
                                 group.device)
            self._outer, chunks = part["outer"], part["stages"]
        else:
            chunks = model.partition_stage_params(
                params["stages"], sizes, n_chunks=C)
            self._outer = params["outer"]
        self._chunks = chunks
        self.device = model.device
        self.n_waves = 0
        self.n_lanes = 0
        self.last_events: List[Dict[str, Any]] = []
        self.round_ms: List[float] = []     # each round's host wall
        self._build(sizes)

    def _build(self, sizes) -> None:
        splan = self.splan
        self._sizes = tuple(sizes)
        self._caches = self._new_caches()
        if self.backend == "mpmd":
            self._streams = splan.serve_streams()
        else:
            self._table = splan.serve_table()
        self._warm = False

    def _new_caches(self):
        caches = chunk_page_caches(self.model, self._sizes,
                                   self.splan.n_pages, self.splan.page_seq)
        if self.backend == "mpmd":      # the rank's own chunk only
            caches = tuple(c if q == self.group.rank else None
                           for q, c in enumerate(caches))
        return caches

    # ------------------------------------------------------------ one round
    def _round(self, batch: Dict[str, np.ndarray]):
        if self.backend == "mpmd":
            return self._round_mpmd(batch)
        return self._round_scan(batch)

    def _round_scan(self, batch: Dict[str, np.ndarray]):
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
            wave_len = int(batch["dec_pos"].max()) + 1
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
                y = model.stage_decode(chunks[q], caches[q], x, pos, pages,
                                       wave_len)
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

    def _round_mpmd(self, batch: Dict[str, np.ndarray]):
        """This rank's column of the serve streams over ``batch``, the
        same per-chunk calls as :meth:`_round_scan`.  After each row one
        exchange sends the hidden it produced to the next rank and
        receives what the row's receive slots name; a decode payload
        moves only in a round with a wave, a prefill payload only for a
        lane with a prompt (the sender's row names the lane).  The last
        chunk's rank sends ``[R + F]`` tokens and the non-finite count
        to rank 0, which returns them as :meth:`_round_scan` does; the
        other ranks return None."""
        model, g, st, dev = self.model, self.group, self._streams, \
            self.device
        outer, chunks, caches = self._outer, self._chunks, self._caches
        vocab, d = model.cfg.vocab_size, model.cfg.d_model
        cdt = dtype_of(model.cfg.compute_dtype)
        C, r, nop = st.n_chunks, g.rank, len(st.branches)
        live = batch["dec_pages"] < self.splan.n_pages
        wave = bool(live.any())
        pf_len, pf_pages = batch["pf_len"], batch["pf_pages"]
        R, F = len(live), len(pf_len)
        if wave:
            self._check_rows(batch)
            self.n_waves += 1
            dec = torch.from_numpy(np.stack(
                [batch["dec_tokens"], batch["dec_pos"], batch["dec_pages"],
                 live.astype(np.int32)])).to(dev)
            toks, pos, pages = dec[0].long(), dec[1], dec[2]
            wave_len = int(batch["dec_pos"].max()) + 1
        dec_pool: List[Optional[torch.Tensor]] = [None] * st.n_dec_slots
        pf_pool: List[Optional[torch.Tensor]] = [None] * st.n_pf_slots
        nxt = torch.zeros(R + F + 1, dtype=torch.long, device=dev)
        for t in range(st.rows.shape[0]):
            row = st.rows[t, r].tolist()
            sends = []
            if row[sir.SDCOL_BRANCH] != nop:
                kind, q = st.branches[row[sir.SDCOL_BRANCH]]
                a = row[sir.SDCOL_A]
                if kind == sir.DECODE and wave:
                    if q == 0:
                        x = model.decode_embed(outer, toks[:, None],
                                               pos[:, None])
                    else:
                        x, dec_pool[a] = dec_pool[a], None
                    y = model.stage_decode(chunks[q], caches[q], x, pos,
                                           pages, wave_len)
                    if q < C - 1:
                        sends.append((y, g.next, rsh.TAG_FWD))
                    else:
                        logits = model.logits(outer, y)[:, 0, :vocab]
                        nxt[R + F] += (~torch.isfinite(
                            logits[dec[3].bool()])).sum()
                        nxt[:R] = torch.argmax(logits, -1)
                elif kind == sir.PREFILL and pf_len[row[sir.SDCOL_MB]]:
                    j = row[sir.SDCOL_MB]
                    n = int(pf_len[j])
                    if q == 0:
                        self.n_lanes += 1
                        toks_j = torch.from_numpy(batch["pf_tokens"][
                            j, :n].astype(np.int64)).to(dev)
                        x = model.decode_embed(
                            outer, toks_j[None],
                            torch.arange(n, device=dev)[None])
                    else:
                        x, pf_pool[a] = pf_pool[a], None
                    y = model.stage_prefill(chunks[q], caches[q], x,
                                            int(pf_pages[j]))
                    if q < C - 1:
                        sends.append((y, g.next, rsh.TAG_PREFILL))
                    else:
                        logits = model.logits(outer, y)[0, -1, :vocab]
                        nxt[R + F] += (~torch.isfinite(logits)).sum()
                        nxt[R + j] = torch.argmax(logits)
            recvs, slots = [], []
            sd, sp = row[sir.SDCOL_RECV_D], row[sir.SDCOL_RECV_P]
            if sd >= 0 and wave:
                recvs.append(((R, 1, d), cdt, g.prev, rsh.TAG_FWD))
                slots.append((dec_pool, sd))
            if sp >= 0:
                n = int(pf_len[st.rows[t, g.prev, sir.SDCOL_MB]])
                if n:
                    recvs.append(((1, n, d), cdt, g.prev, rsh.TAG_PREFILL))
                    slots.append((pf_pool, sp))
            for (pool, k), x in zip(slots, g.exchange(sends, recvs)):
                pool[k] = x
        if C > 1 and r == C - 1:
            g.send(nxt, 0)
        if r != 0:
            return None
        if C > 1:
            nxt = g.recv((R + F + 1,), torch.long, C - 1)
        got = nxt.cpu().numpy()
        return (got[:R].astype(np.int32), got[R:R + F].astype(np.int32),
                int(got[R + F]))

    def _desc_size(self) -> int:
        splan = self.splan
        R, F, P = splan.n_slots, max(splan.max_prefill, 1), \
            splan.prompt_budget
        return 1 + 3 * R + F * P + 2 * F

    def _send_desc(self, batch: Optional[Dict[str, np.ndarray]]) -> None:
        """Rank 0: one round's descriptor (tokens, positions, pages,
        prefill lanes) to every other rank; ``None`` is the stop
        message."""
        g = self.group
        if batch is None:
            flat = np.zeros((self._desc_size(),), np.int64)
            flat[0] = 1
        else:
            flat = np.concatenate([np.zeros((1,), np.int64)] + [
                np.asarray(batch[k], np.int64).reshape(-1)
                for k in _DESC_KEYS])
        t = torch.from_numpy(flat)
        g.exchange([(t, q, rsh.TAG_CTL) for q in range(1, g.world)], [])

    def _recv_desc(self) -> Optional[Dict[str, np.ndarray]]:
        splan = self.splan
        R, F, P = splan.n_slots, max(splan.max_prefill, 1), \
            splan.prompt_budget
        flat = self.group.recv((self._desc_size(),), torch.int64,
                               0).cpu().numpy()
        if flat[0]:
            return None
        out, lo = {}, 1
        for k, shape in zip(_DESC_KEYS, ((R,), (R,), (R,), (F, P), (F,),
                                         (F,))):
            n = int(np.prod(shape))
            out[k] = flat[lo:lo + n].reshape(shape).astype(np.int32)
            lo += n
        return out

    def _follow(self) -> Dict[int, tuple]:
        """A rank other than 0: run rounds on rank 0's descriptors until
        the stop message."""
        with torch.inference_mode():
            while True:
                batch = self._recv_desc()
                if batch is None:
                    return {}
                self._round_mpmd(batch)

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
            self._caches = self._new_caches()
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
        mpmd = self.backend == "mpmd"
        if mpmd and self.group.rank != 0:
            return self._follow()
        sched = ContinuousBatcher(self.splan, requests,
                                  registry=self.registry)
        limit = max_rounds if max_rounds is not None else (
            max((q.arrival for q in requests), default=0)
            + sum(max(q.gen_len, 1) for q in requests) + len(requests)
            + 8)
        hist = (self.registry.histogram("serve/token_ms")
                if self.registry is not None else None)
        r, n_tokens, busy_s = 0, 0, 0.0
        self.round_ms = []
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
                if mpmd:
                    self._send_desc(batch)
                dec_next, pf_next, round_bad = self._round(batch)
                dt_s = time.time() - t0         # the tokens' copy synced
                self.round_ms.append(dt_s * 1e3)
                bad += round_bad
                toks = sched.n_round_tokens()
                busy_s += dt_s
                n_tokens += toks
                if hist is not None:
                    for _ in range(toks):
                        hist.observe(dt_s * 1e3)
                sched.commit(r, dec_next, pf_next)
                r += 1
        if mpmd:
            self._send_desc(None)
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
        Page geometry must match.  Not ported under mpmd."""
        if self.backend == "mpmd":
            raise NotImplementedError(
                "unsupported combination: ServeEngine.restate with "
                "backend='mpmd' — moving stage-local paged caches and "
                "weights between ranks is not ported to PyTorch yet; "
                "supported alternative: backend='scan', or a new mpmd "
                "engine on the new plan")
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
    first ``vocab_size`` logits, so the two emit the same tokens.  The
    engine for hybrid and encoder-decoder models (an enc-dec model's
    decoder attends to a zero cross cache, as the JAX engine's does:
    ``Model.prefill``).

    Prefill is one causal :meth:`Model.prefill` over the request's prompt
    into a fresh cache (for rwkv6 and mamba2 one scan-kernel call per
    layer over the whole prompt); decoding then runs
    :meth:`Model.decode_step` token by token.  Weights are cast to the
    compute dtype once, here (the fp32 leaves stay fp32).
    Reported latencies exclude a warm-up that builds the model's kernels
    and runs one prefill and one decode, as the JAX engine's exclude
    compilation; on the card every timed region ends in a synchronise.
    Each request's ``serve_request`` event carries ``ttft_ms``, the wall
    of its prefill and first token (its time to first token); the gauge
    ``serve/max_abs_logit`` holds the largest |logit| the run read.

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
            top = torch.zeros((), dtype=torch.float32, device=self.device)
            for req in sorted(requests, key=lambda q: (q.arrival, q.rid)):
                if not admissible(req, self.splan):
                    results[req.rid] = ()
                    continue
                t0 = time.time()
                logits, cache = self._prefill(req.prompt)
                row = logits[0, -1, :vocab]
                bad += (~torch.isfinite(row)).sum()
                top = torch.maximum(top, row.abs().max().float())
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
                    top = torch.maximum(top, row.abs().max().float())
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
            self.registry.gauge("serve/max_abs_logit").set(float(top))
            self.registry.gauge("serve/prefill_calls").set(self.n_prefill)
            self.registry.gauge("serve/decode_calls").set(self.n_decode)
        return results
