"""Whole-model greedy serving (twin of ``SimpleEngine`` in
``repro/serve/engine.py``).

The pipelined ``ServeEngine`` (schedule IR, paged KV, continuous
batching) is a later slice of the port.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.models.model import cast_for_compute
from repro_torch.serve.scheduler import admissible


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
