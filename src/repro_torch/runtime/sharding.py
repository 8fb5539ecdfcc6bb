"""Stage-local placement and the stage group (the stage-local half of
``repro/runtime/sharding.py``: ``mpmd_pipe_mesh`` and
``mpmd_state_shardings``).

Under ``execution="mpmd"`` each pipeline stage is one OS process, a
rank of a ``torch.distributed`` group.  This module holds:

* :class:`StageGroup`: the rank's place in the group (rank, world size,
  ``torch.device``, ring neighbours) and its transport, with the one
  send/receive primitive the runtimes use (:meth:`StageGroup.exchange`,
  a ``batch_isend_irecv`` of one tick's payloads);
* the placement rule: chunk ``q`` lives on rank ``q % S`` (the JAX
  twin's ``pack_chunk_params`` folding), and each leaf of the outer
  tree on the rank(s) that read it: the embedding on rank 0, the head
  (final norm and unembedding) on rank ``(C - 1) % S``, a tied
  embedding on both.

Device: rank ``r`` takes ``cuda:(r % torch.cuda.device_count())``, or
the CPU when the caller asks for it; nothing falls back to the CPU on
its own.  Transport, chosen once when the group is made and kept:

  ``nccl``       CUDA tensors over NCCL, when every rank has a card of
                 its own (NCCL refuses two ranks on one card);
  ``gloo-host``  gloo through pinned host buffers (device -> pinned
                 host -> gloo -> pinned host -> device), when ranks
                 share a card;
  ``gloo``       gloo on CPU tensors, when the device is the CPU.

An NCCL error raises; nothing falls back to gloo.  Every process group
gets a timeout, and rendezvous goes through a ``FileStore`` in a
temporary directory (no TCP port, so parallel runs cannot collide)
unless ``RANK`` / ``WORLD_SIZE`` are set, as under ``torchrun``.

The data axis (the data-parallel baseline):

* the JAX module's logical-axis rules as pure functions
  (:func:`logical_rules`, :func:`decode_rules`, :func:`spec_for_leaf`,
  :func:`shardings_for`, :func:`momentum_rules`, :func:`batch_specs`).
  They read a ``runtime.mesh_utils.RankMesh`` (or anything with
  ``axis_names`` and ``devices``) and return spec tuples equal to
  ``tuple(PartitionSpec)`` where JAX returns ``NamedSharding``s;
* the data axis executed as replicas: one process a replica, every
  replica holding the whole model (:func:`check_data_replicated` refuses
  a layout that shards a parameter over ``data``), taking its block of
  every microbatch of a global batch (:func:`replica_rows`; with one
  microbatch the block :func:`local_rows` cuts by ``batch_specs``'
  ``act_batch`` rule) and averaging its gradients with the others
  through :meth:`StageGroup.all_reduce_mean` (fixed-size fp32 buckets,
  one ``all_reduce`` each, on the transport below) once a sync step, a
  tick or a round; an MoE layer's expert fractions through
  :meth:`StageGroup.mean_stat`; checkpoints gather the rings' rows to
  rank 0 through :meth:`StageGroup.gather_rows`.  The reductions run
  after the backward, not overlapped with it;
* ZeRO-1 (the JAX package's default ``zero1=True``): each replica holds
  its contiguous piece of every momentum leaf (:func:`shard_range`),
  reduce-scatters the fp32 gradient (:meth:`StageGroup.
  reduce_scatter_mean`), updates its pieces (``optim.sgd.update_groups``)
  and all-gathers the weights and ŵ (:meth:`StageGroup.all_gather`), both
  bucketed like the all-reduce (:func:`shard_buckets`);
* the tensor axis of a ``(data, pipe=1, tensor)`` rank grid
  (:func:`init_grid`: the data and the tensor groups as ``new_group``
  sub-groups, tensor innermost): a rank holds its block of every leaf
  ``spec_for_leaf(logical_rules)`` shards over ``tensor``
  (:func:`tensor_leaf_dims`, :func:`tensor_block`, :func:`gather_tensor`);
  the layers' activation all-reduces go through
  :meth:`StageGroup.all_reduce_sum` (``models.tensor_axis``); mamba2's
  ``w_zx`` is held as the pair of its z and x blocks
  (:data:`TENSOR_PARTS`); the model kinds whose layers are not split are
  refused (:func:`tensor_refusal`).  The rings stay replicated over tensor (the
  JAX package shards them on ``embed``), and the SPMD state shardings
  (``stream_state_shardings`` and the rest) are not ported.
"""
from __future__ import annotations

import os
import time
import warnings
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime.mesh_utils import RankMesh, axis_sizes, rank_coords

TRANSPORTS = ("nccl", "gloo-host", "gloo")
TAG_FWD, TAG_BWD, TAG_CTL, TAG_PREFILL = 1, 2, 3, 4
# the all-reduce's bucket: 256 MiB of fp32 gradient a call, which bounds
# the pinned host buffer under gloo-host (one buffer a rank, reused)
BUCKET_BYTES = 256 * 2**20

_CURRENT: List[Optional["StageGroup"]] = [None]


def n_cards(cards: Optional[int] = None) -> int:
    """The cards the ranks spread over: all of them, or the first
    ``cards``."""
    n = torch.cuda.device_count()
    return n if cards is None else max(1, min(int(cards), n))


def rank_device(rank: int, device: str = "cuda",
                cards: Optional[int] = None) -> torch.device:
    """The device of rank ``rank``: ``cuda:(rank % n_cards(cards))``, or
    the CPU when ``device`` is ``"cpu"``.  Raises for ``cuda`` on a
    machine with no card."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % n_cards(cards))


def choose_transport(device: str, world: int,
                     cards: Optional[int] = None) -> str:
    """``gloo`` on the CPU; ``nccl`` when the ``world`` ranks have a card
    each; ``gloo-host`` when they share cards."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if world <= n_cards(cards) else "gloo-host"


def describe_transport(transport: str, world: int,
                       cards: Optional[int] = None) -> str:
    """One line naming the transport and the ranks' placement."""
    if transport == "gloo":
        return f"gloo on CPU tensors, {world} ranks on the CPU"
    if transport == "nccl":
        return f"nccl, {world} ranks on {world} cards"
    n = min(n_cards(cards), world)
    return (f"gloo through pinned host buffers, {world} ranks on "
            f"{n} card{'s' if n > 1 else ''}")


class StageGroup:
    """One rank of a stage group: ``rank`` of ``world``, its ``device``,
    ring neighbours ``next`` / ``prev`` and its ``transport``.

    Counters (reset with :meth:`reset_counters`): ``n_sent`` /
    ``bytes_sent`` and ``n_recv`` / ``bytes_recv`` count the payloads
    (activations, cotangents, hiddens) that crossed to or from another
    rank (a rank's payload to itself, at S = 1, moves nothing);
    ``n_ctl`` / ``bytes_ctl`` the control messages this rank sent
    (serving descriptors and tokens, gradient partials, gathers);
    ``transport_s`` is the host wall spent in :meth:`exchange`, host
    copies and waits included; ``n_reduce`` / ``bytes_reduce`` the
    all-reduce calls of :meth:`all_reduce_mean` and the bytes they
    reduced, ``reduce_s`` its host wall (packing, the calls, the
    division and unpacking) and :meth:`reduce_scatter_mean`'s;
    ``n_rs`` / ``bytes_rs`` ZeRO-1's reduce-scatter calls and their
    input bytes, ``n_ag`` / ``bytes_ag`` its all-gather calls and their
    output bytes, ``gather_s`` their host wall; ``n_stat`` /
    ``bytes_stat`` the small reductions of :meth:`mean_stat` and
    :meth:`all_reduce_scalar`; ``n_tp`` / ``bytes_tp`` the tensor axis's
    activation all-reduces (:meth:`all_reduce_sum`, and
    :meth:`all_reduce_max`) and their bytes, ``tp_s`` their host
    wall."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 transport: str, cards: Optional[int] = None, *,
                 pg=None, ranks: Optional[Sequence[int]] = None):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; known: "
                             f"{TRANSPORTS}")
        self.rank, self.world = rank, world
        self.device, self.transport = device, transport
        self.next, self.prev = (rank + 1) % world, (rank - 1) % world
        self.cards = cards
        # a sub-group of the process group (the data or the tensor group
        # of a rank grid): its handle and the global rank of each member
        self.pg = pg
        self.ranks = tuple(range(world)) if ranks is None else tuple(ranks)
        # the grid's groups, set on the world group by init_grid: the
        # data group (self when the grid has no tensor axis) and the
        # tensor group (None without one)
        self.data: Optional["StageGroup"] = self
        self.tensor: Optional["StageGroup"] = None
        self.t0 = time.perf_counter()   # when the rank began to join
        self._bufs: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}
        self.reset_counters()

    def reset_counters(self) -> None:
        self.n_sent = self.bytes_sent = 0
        self.n_recv = self.bytes_recv = 0
        self.n_ctl = self.bytes_ctl = 0
        self.transport_s = 0.0
        self.n_reduce = self.bytes_reduce = 0
        self.reduce_s = 0.0
        self.n_stat = self.bytes_stat = 0
        self.n_rs = self.bytes_rs = 0
        self.n_ag = self.bytes_ag = 0
        self.gather_s = 0.0
        self.n_tp = self.bytes_tp = 0
        self.tp_s = 0.0

    def counters(self) -> Dict[str, float]:
        return {"n_sent": self.n_sent, "bytes_sent": self.bytes_sent,
                "n_recv": self.n_recv, "bytes_recv": self.bytes_recv,
                "n_ctl": self.n_ctl, "bytes_ctl": self.bytes_ctl,
                "transport_s": self.transport_s,
                "n_reduce": self.n_reduce,
                "bytes_reduce": self.bytes_reduce,
                "reduce_s": self.reduce_s,
                "n_stat": self.n_stat, "bytes_stat": self.bytes_stat,
                "n_rs": self.n_rs, "bytes_rs": self.bytes_rs,
                "n_ag": self.n_ag, "bytes_ag": self.bytes_ag,
                "gather_s": self.gather_s,
                "n_tp": self.n_tp, "bytes_tp": self.bytes_tp,
                "tp_s": self.tp_s}

    def describe(self) -> str:
        return describe_transport(self.transport, self.world, self.cards)

    # ---------------------------------------------------------------- p2p
    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int, int]],
                 recvs: Sequence[Tuple[Tuple[int, ...], torch.dtype, int,
                                       int]]) -> List[torch.Tensor]:
        """One ``batch_isend_irecv``: ``sends`` are ``(tensor, dst, tag)``,
        ``recvs`` ``(shape, dtype, src, tag)``; returns the received
        tensors on this rank's device, in ``recvs``' order.  Every rank
        lists its operations grouped by tag in ascending order, sends
        before receives, so the k-th send from a to b with a tag meets
        the k-th receive at b from a with that tag on every transport
        (NCCL matches by order, not by tag).  A payload to this rank
        itself is handed over without a copy."""
        if not sends and not recvs:
            return []
        t0 = time.perf_counter()
        out: List[Optional[torch.Tensor]] = [None] * len(recvs)
        own = {}
        for t, dst, tag in sends:
            if dst == self.rank:
                own.setdefault(tag, []).append(t)
        ops, landing = [], []
        for tag in sorted({s[2] for s in sends} | {r[3] for r in recvs}):
            for t, dst, tg in sends:
                if tg != tag or dst == self.rank:
                    continue
                ops.append(dist.P2POp(dist.isend, self._wire(t),
                                      self.ranks[dst], tag=tag))
                if tag == TAG_CTL:
                    self.n_ctl += 1
                    self.bytes_ctl += t.numel() * t.element_size()
                else:
                    self.n_sent += 1
                    self.bytes_sent += t.numel() * t.element_size()
            for i, (shape, dtype, src, tg) in enumerate(recvs):
                if tg != tag:
                    continue
                if src == self.rank:
                    out[i] = own[tag].pop(0)
                    continue
                buf = self._buffer(shape, dtype)
                ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src],
                                      tag=tag))
                landing.append((i, buf))
                if tag != TAG_CTL:
                    self.n_recv += 1
                    self.bytes_recv += buf.numel() * buf.element_size()
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        for i, buf in landing:
            out[i] = (buf.to(self.device, non_blocking=False)
                      if self.transport == "gloo-host" else buf)
        if any(v for v in own.values()):
            raise ValueError("a payload sent to this rank was not "
                             "received by it")
        self.transport_s += time.perf_counter() - t0
        return out

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().contiguous()
        if self.transport == "nccl":
            return t.to(self.device)
        if self.transport == "gloo":
            return t.cpu()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _buffer(self, shape, dtype) -> torch.Tensor:
        if self.transport == "gloo-host":
            return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        return torch.empty(tuple(shape), dtype=dtype, device=self.device)

    def send(self, t: torch.Tensor, dst: int, tag: int = TAG_CTL) -> None:
        self.exchange([(t, dst, tag)], [])

    def recv(self, shape, dtype, src: int, tag: int = TAG_CTL
             ) -> torch.Tensor:
        return self.exchange([], [(tuple(shape), dtype, src, tag)])[0]

    def barrier(self) -> None:
        if self.world > 1:
            if self.transport == "nccl":
                dist.barrier(group=self.pg, device_ids=[self.device.index])
            else:
                dist.barrier(group=self.pg)

    # ------------------------------------------------------ data axis
    def all_reduce_mean(self, tree, *, bucket_bytes: int = BUCKET_BYTES):
        """Replace every leaf of ``tree`` (fp32 tensors on this rank's
        device: the gradients) by its mean over the group's ranks, in
        place, and return ``tree``.

        The leaves, taken in ``tree_leaves`` order as one flat sequence,
        are cut into buckets of ``bucket_bytes``; each bucket is packed
        into one buffer (on the card under ``nccl``, pinned host memory
        under ``gloo-host``, the CPU under ``gloo``; one buffer a rank,
        reused), reduced by one ``all_reduce(SUM)``, copied back and
        divided by the world size.  Every rank divides the same sum, so
        the ranks' results are bit-equal.  The calls run after the
        backward, one after another: overlapping them with the backward
        is not done.  Under ``nccl`` the host waits for the card at the
        end, so ``reduce_s`` is the reduction's wall there too."""
        from repro_torch.models.layers import tree_leaves
        leaves = tree_leaves(tree)
        for g in leaves:
            if g.dtype != torch.float32 or g.device != self.device:
                raise ValueError(
                    f"all_reduce_mean takes fp32 leaves on {self.device}, "
                    f"got {g.dtype} on {g.device}")
        if self.world == 1:
            return tree
        t0 = time.perf_counter()
        cap = max(1, int(bucket_bytes) // 4)
        buf = self._buf("ar", torch.float32, cap)
        flats = [g.view(-1) for g in leaves]
        pieces: List[Tuple[torch.Tensor, int]] = []    # (slice, offset)
        fill = 0

        def flush():
            nonlocal fill, pieces
            dist.all_reduce(buf[:fill], op=dist.ReduceOp.SUM, group=self.pg)
            for part, off in pieces:
                part.copy_(buf[off:off + part.numel()])
                part.div_(self.world)
            self.n_reduce += 1
            self.bytes_reduce += 4 * fill
            pieces, fill = [], 0

        for flat in flats:
            lo = 0
            while lo < flat.numel():
                n = min(cap - fill, flat.numel() - lo)
                part = flat[lo:lo + n]
                buf[fill:fill + n].copy_(part)
                pieces.append((part, fill))
                fill += n
                lo += n
                if fill == cap:
                    flush()
        if fill:
            flush()
        if self.transport == "nccl":
            # NCCL's calls return once queued: wait for them, so that
            # reduce_s is the reduction's wall as on the other transports
            torch.cuda.synchronize(self.device)
        self.reduce_s += time.perf_counter() - t0
        return tree

    def mean_stat(self, t: torch.Tensor) -> torch.Tensor:
        """Replace the small fp32 tensor ``t`` (on this rank's device, no
        gradient: an MoE layer's expert fractions) by its mean over the
        group's ranks, in place, and return it: one ``all_reduce(SUM)``
        on the transport, then the division, so every rank holds the same
        bits.  Counted under ``n_stat`` / ``bytes_stat``, apart from the
        gradients' reductions."""
        if self.world == 1:
            return t
        if t.dtype != torch.float32 or t.device != self.device:
            raise ValueError(f"mean_stat takes an fp32 tensor on "
                             f"{self.device}, got {t.dtype} on {t.device}")
        wire = t if self.transport == "nccl" else self._wire(t)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.pg)
        if wire is not t:
            t.copy_(wire)
        t.div_(self.world)
        self.n_stat += 1
        self.bytes_stat += t.numel() * 4
        return t

    # ------------------------------------------- ZeRO-1 over the data axis
    def _buf(self, kind: str, dtype: torch.dtype, n: int) -> torch.Tensor:
        """A reusable flat buffer of at least ``n`` elements on the
        transport's side (pinned host memory under gloo-host)."""
        buf = self._bufs.get((kind, dtype))
        if buf is None or buf.numel() < n:
            buf = (torch.empty(n, dtype=dtype, pin_memory=True)
                   if self.transport == "gloo-host" else
                   torch.empty(n, dtype=dtype, device=self._wire_dev()))
            self._bufs[(kind, dtype)] = buf
        return buf

    def _wire_dev(self) -> torch.device:
        return self.device if self.transport == "nccl" else \
            torch.device("cpu")

    def _sync(self) -> None:
        if self.transport == "nccl":
            torch.cuda.synchronize(self.device)

    def reduce_scatter_mean(self, leaves: Sequence[torch.Tensor], *,
                            bucket_bytes: int = BUCKET_BYTES
                            ) -> List[torch.Tensor]:
        """ZeRO-1's gradient reduction: for every fp32 leaf (on this
        rank's device) this rank's piece of its mean over the group,
        written over the leaf's own piece (:func:`shard_range` of its
        flat elements; a contiguous leaf is not copied) and returned as
        a 1-D view, in ``leaves``' order; the rest of the leaf keeps the
        rank's own values.  Each leaf's flat elements are cut into
        ``world`` contiguous pieces; the pieces, padded to the leaf's
        ``ceil(n / world)``, fill the rows of a ``[world, width]``
        bucket (``bucket_bytes`` of input a call), reduced by one
        ``reduce_scatter_tensor(SUM)`` that leaves row ``rank`` here,
        then divided by the world size: the same sum and division as
        :meth:`all_reduce_mean`, so a piece is bit-equal to the slice of
        its result."""
        for g in leaves:
            if g.dtype != torch.float32 or g.device != self.device:
                raise ValueError(
                    f"reduce_scatter_mean takes fp32 leaves on "
                    f"{self.device}, got {g.dtype} on {g.device}")
        flats = [g.view(-1) if g.is_contiguous() else g.reshape(-1)
                 for g in leaves]
        out = [f[slice(*shard_range(f.numel(), self.rank, self.world))]
               for f in flats]
        if self.world == 1:
            return out
        t0 = time.perf_counter()
        N, me = self.world, self.rank
        for width, segs in shard_buckets([f.numel() for f in flats], N,
                                         bucket_bytes // 4):
            src = self._buf("rs_in", torch.float32, N * width)
            rows = src[:N * width].view(N, width)
            for i, j0, take, col in segs:
                for r in range(N):
                    lo, hi = shard_range(flats[i].numel(), r, N)
                    valid = max(0, min(take, hi - lo - j0))
                    if valid:
                        rows[r, col:col + valid].copy_(
                            flats[i][lo + j0:lo + j0 + valid])
                    if valid < take:
                        rows[r, col + valid:col + take].zero_()
            dst = self._buf("rs_out", torch.float32, width)
            _reduce_scatter(dst[:width], src[:N * width], self.pg)
            for i, j0, take, col in segs:
                lo, hi = shard_range(flats[i].numel(), me, N)
                valid = max(0, min(take, hi - lo - j0))
                if valid:
                    part = out[i][j0:j0 + valid]
                    part.copy_(dst[col:col + valid])
                    part.div_(N)
            self.n_rs += 1
            self.bytes_rs += 4 * N * width
        self._sync()
        self.reduce_s += time.perf_counter() - t0
        return out

    def all_gather(self, leaves: Sequence[torch.Tensor], *,
                   bucket_bytes: int = BUCKET_BYTES) -> None:
        """ZeRO-1's weight gather, in place: every rank holds its
        :func:`shard_range` piece of each leaf (one dtype for all, on
        this rank's device) up to date, and after the call every rank
        holds every piece.  Bucketed as :meth:`reduce_scatter_mean`
        (``bucket_bytes`` of output a call), one
        ``all_gather_into_tensor`` a bucket."""
        if self.world == 1 or not leaves:
            return
        dt = leaves[0].dtype
        for g in leaves:
            if g.dtype != dt or g.device != self.device:
                raise ValueError(
                    f"all_gather takes leaves of one dtype on "
                    f"{self.device}, got {g.dtype} on {g.device}")
        t0 = time.perf_counter()
        N, me = self.world, self.rank
        el = leaves[0].element_size()
        flats = [g.view(-1) for g in leaves]
        for width, segs in shard_buckets([f.numel() for f in flats], N,
                                         bucket_bytes // el):
            src = self._buf("ag_in", dt, width)
            dst = self._buf("ag_out", dt, N * width)
            for i, j0, take, col in segs:
                lo, hi = shard_range(flats[i].numel(), me, N)
                valid = max(0, min(take, hi - lo - j0))
                if valid:
                    src[col:col + valid].copy_(
                        flats[i][lo + j0:lo + j0 + valid])
            _all_gather(dst[:N * width], src[:width], self.pg)
            rows = dst[:N * width].view(N, width)
            for i, j0, take, col in segs:
                for r in range(N):
                    if r == me:
                        continue
                    lo, hi = shard_range(flats[i].numel(), r, N)
                    valid = max(0, min(take, hi - lo - j0))
                    if valid:
                        flats[i][lo + j0:lo + j0 + valid].copy_(
                            rows[r, col:col + valid])
            self.n_ag += 1
            self.bytes_ag += el * N * width
        self._sync()
        self.gather_s += time.perf_counter() - t0

    def all_reduce_scalar(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the 0-d fp32 tensor ``t`` over the group, in place
        (the clip norm's square sums); counted under ``n_stat``."""
        if self.world == 1:
            return t
        wire = t if self.transport == "nccl" else self._wire(t)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.pg)
        if wire is not t:
            t.copy_(wire)
        self.n_stat += 1
        self.bytes_stat += t.numel() * t.element_size()
        return t

    # -------------------------------------------------------- tensor axis
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor axis's activation reduction: ``t`` (any float dtype,
        on this rank's device) summed over the group, returned as a new
        tensor (``t`` is left as it is).  One ``all_reduce(SUM)``;
        counted under ``n_tp`` / ``bytes_tp``, its host wall (copies
        and, under nccl, the wait) under ``tp_s``."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        if self.transport == "gloo-host":
            wire = self._wire(t)
            dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=self.pg)
            out = wire.to(self.device)
        else:
            out = t.detach().contiguous().clone()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.pg)
            self._sync()
        self.n_tp += 1
        self.bytes_tp += t.numel() * t.element_size()
        self.tp_s += time.perf_counter() - t0
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the group, a new tensor (the
        vocab-parallel loss's shift); counted as :meth:`all_reduce_sum`."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        out = (self._wire(t) if self.transport == "gloo-host"
               else t.detach().contiguous().clone())
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.pg)
        out = out.to(self.device)
        self._sync()
        self.n_tp += 1
        self.bytes_tp += t.numel() * t.element_size()
        self.tp_s += time.perf_counter() - t0
        return out

    def all_gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` (one shape and dtype on every rank)
        concatenated along ``dim`` in rank order, on every rank: a
        tensor-sharded leaf made whole (checkpoints, tests).  Counted as
        control traffic."""
        if self.world == 1:
            return t
        wire = self._wire(t) if self.transport != "gloo" else \
            t.detach().contiguous()
        got = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(got, wire, group=self.pg)
        self.n_ctl += 1
        self.bytes_ctl += t.numel() * t.element_size()
        return torch.cat([g.to(self.device) for g in got], dim)

    def gather_rows(self, t: torch.Tensor, dim: int
                    ) -> Optional[torch.Tensor]:
        """Rank 0: every rank's ``t`` (one shape and dtype on every rank)
        concatenated along ``dim`` in rank order; the other ranks send
        theirs to rank 0 and get None.  Control messages."""
        if self.world == 1:
            return t
        if self.rank:
            self.exchange([(t, 0, TAG_CTL)], [])
            return None
        got = self.exchange([], [(tuple(t.shape), t.dtype, r, TAG_CTL)
                                 for r in range(1, self.world)])
        return torch.cat([t] + got, dim)

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj`` (small, picklable), in rank order."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.pg)
        return out


# ------------------------------------------------------- ZeRO-1 pieces
def shard_range(n: int, rank: int, world: int) -> Tuple[int, int]:
    """Rank ``rank`` of ``world``'s contiguous piece ``[lo, hi)`` of a
    leaf's ``n`` flat elements under ZeRO-1: ``floor(r·n / world)``
    cuts, so the pieces differ in length by at most one element."""
    return rank * n // world, (rank + 1) * n // world


def shard_buckets(sizes: Sequence[int], world: int, cap: int
                  ) -> List[Tuple[int, List[Tuple[int, int, int, int]]]]:
    """The buckets of a reduce-scatter or all-gather over leaves of
    ``sizes`` elements: each leaf contributes ``ceil(n / world)`` columns
    (its pieces, padded) to a ``[world, width]`` matrix of at most
    ``cap`` elements a bucket.  Returns ``[(width, [(leaf, j0, take,
    col), ...]), ...]``: columns ``[j0, j0 + take)`` of the leaf's
    pieces sit at ``[col, col + take)`` of the bucket's rows."""
    cols = max(1, cap // world)
    out: List[Tuple[int, List[Tuple[int, int, int, int]]]] = []
    segs: List[Tuple[int, int, int, int]] = []
    fill = 0
    for i, n in enumerate(sizes):
        P = -(-int(n) // world)
        j0 = 0
        while j0 < P:
            take = min(P - j0, cols - fill)
            segs.append((i, j0, take, fill))
            fill += take
            j0 += take
            if fill == cols:
                out.append((fill, segs))
                segs, fill = [], 0
    if fill:
        out.append((fill, segs))
    return out


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, pg) -> None:
    with warnings.catch_warnings():     # renamed in newer releases
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, inp, op=dist.ReduceOp.SUM,
                                   group=pg)


def _all_gather(out: torch.Tensor, inp: torch.Tensor, pg) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, inp, group=pg)


# ------------------------------------------------------------- the group
def init_stage_group(rank: int, world: int, device: str = "cuda", *,
                     store_path: Optional[str] = None,
                     timeout_s: float = 60.0,
                     cards: Optional[int] = None) -> StageGroup:
    """Join the process group as ``rank`` of ``world`` and return this
    process's :class:`StageGroup` (also :func:`current_group`).
    Rendezvous through the ``FileStore`` at ``store_path``, else the
    ``env://`` variables ``torchrun`` sets.  ``cards``: spread the ranks
    over the first this many cards (default: every card)."""
    t0 = time.perf_counter()
    dev = rank_device(rank, device, cards)
    transport = choose_transport(device, world, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if transport == "nccl" else "gloo"
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=timedelta(seconds=timeout_s))
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(**kw)
    group = StageGroup(rank, world, dev, transport, cards)
    group.t0 = t0
    group.barrier()     # NCCL's first p2p batch must not be its first call
    _CURRENT[0] = group
    return group


def init_grid(group: StageGroup, data: int, tensor: int) -> StageGroup:
    """Make ``group`` (the world of ``data · tensor`` ranks, rank
    ``d·T + t``: tensor innermost, as in the JAX package's mesh) a rank
    grid: ``group.data`` the ranks of its tensor coordinate (its data
    replicas) and ``group.tensor`` those of its data coordinate, each a
    :class:`StageGroup` on a ``dist.new_group`` sub-group (every rank
    makes every sub-group, in one order).  With ``tensor`` 1 the data
    group is ``group`` itself and there is no tensor group."""
    D, T = int(data), int(tensor)
    if D * T != group.world:
        raise ValueError(f"a ({D}, {T}) grid needs {D * T} ranks, the group "
                         f"has {group.world}")
    if T == 1:
        group.data, group.tensor = group, None
        return group
    backend = "nccl" if group.transport == "nccl" else "gloo"

    def sub(members):
        pgs = {}
        for m in members:
            pgs[m] = dist.new_group(list(m), backend=backend)
        mine = next(m for m in members if group.rank in m)
        sg = StageGroup(mine.index(group.rank), len(mine), group.device,
                        group.transport, group.cards, pg=pgs[mine],
                        ranks=mine)
        return sg
    # the data groups (one per tensor coordinate), then the tensor groups
    data_groups = [tuple(dd * T + tt for dd in range(D)) for tt in range(T)]
    tensor_groups = [tuple(dd * T + tt for tt in range(T))
                     for dd in range(D)]
    group.data = sub(data_groups) if D > 1 else StageGroup(
        0, 1, group.device, group.transport, group.cards,
        ranks=(group.rank,))
    group.tensor = sub(tensor_groups)
    return group


def current_group() -> Optional[StageGroup]:
    """This process's stage group, or None outside one."""
    return _CURRENT[0]


def close_stage_group() -> None:
    _CURRENT[0] = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def env_rank_world() -> Optional[Tuple[int, int]]:
    """(RANK, WORLD_SIZE) when a launcher such as ``torchrun`` set them."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


# ---------------------------------------------------------- placement
def chunk_rank(q: int, world: int) -> int:
    """The rank holding chunk ``q``: ``q % S``."""
    return q % world


def local_chunks(rank: int, n_chunks: int, world: int) -> Tuple[int, ...]:
    return tuple(q for q in range(n_chunks) if q % world == rank)


def head_rank(n_chunks: int, world: int) -> int:
    """The rank of the last chunk, which runs the head and reports the
    loss."""
    return (n_chunks - 1) % world


def outer_leaf_ranks(path: Sequence[str], n_chunks: int, world: int,
                     tied: bool) -> Tuple[int, ...]:
    """The ranks holding outer leaf ``path``: the rank(s) that read it.
    ``embed/tok`` is read by the embedding (rank 0) and, tied, by the
    head too; every other outer leaf (final norm, unembedding) by the
    head."""
    head = head_rank(n_chunks, world)
    if tuple(path[:2]) == ("embed", "tok"):
        return tuple(sorted({0, head})) if tied else (0,)
    return (head,)


def is_rank_part(stages, n_chunks: int, rank: int, world: int) -> bool:
    """Whether ``stages`` is one rank's part (``n_chunks`` chunk trees,
    ``{}`` exactly where another rank holds the chunk) rather than the
    whole model's trees.  With one rank the two coincide: False."""
    return (world > 1 and isinstance(stages, (tuple, list))
            and len(stages) == n_chunks
            and all((not t) == (q % world != rank)
                    for q, t in enumerate(stages)))


def rank_part(model, params, sizes: Sequence[int], rank: int, world: int,
              device: torch.device):
    """The part of ``params`` that ``rank`` of ``world`` holds, on
    ``device``: its chunk trees of the split ``sizes`` (chunk ``q`` on
    rank ``q % world``), ``{}`` for the others, and the outer leaves it
    reads (:func:`local_outer`).  ``params`` is the whole model
    (canonical or chunked: the held leaves are copied, so the caller's
    tree can be dropped) or already the rank's part
    (``Model.init_part``: taken over as it is)."""
    from repro_torch.models.layers import tree_leaves, tree_map
    C = len(sizes)
    if is_rank_part(params["stages"], C, rank, world):
        stages = params["stages"]
        got = tuple(int(tree_leaves(t["layers"])[0].shape[0]) if t else 0
                    for t in stages)
        want = tuple(n if q % world == rank else 0
                     for q, n in enumerate(sizes))
        if got != want:
            raise ValueError(f"rank {rank}'s chunks hold {got} layers, the "
                             f"split {tuple(sizes)} gives it {want}")

        def own(tree):
            return tree_map(lambda _, a: a.to(device), tree)
    else:
        stages = model.partition_stage_params(params["stages"], sizes,
                                              n_chunks=C)

        def own(tree):
            return tree_map(lambda _, a: a.detach().to(device, copy=True),
                            tree)
    return {"outer": own(local_outer(params["outer"], rank, C, world,
                                     model.cfg.tie_embeddings)),
            "stages": tuple(own(t) if q % world == rank else {}
                            for q, t in enumerate(stages))}


def local_outer(outer, rank: int, n_chunks: int, world: int, tied: bool):
    """The sub-tree of ``outer`` that ``rank`` holds (empty dicts
    dropped)."""
    def keep(tree, path):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                sub = keep(tree[k], path + (str(k),))
                if sub is not None:
                    out[k] = sub
            return out or None
        return tree if rank in outer_leaf_ranks(path, n_chunks, world,
                                                tied) else None
    return keep(outer, ()) or {}


# ------------------------------------------------------ the data rules
# (the JAX module's logical-axis rules, as pure functions over a rank
# mesh: a spec is the tuple ``tuple(PartitionSpec)`` would give)
AxisVal = Union[None, str, Tuple[str, ...]]


def logical_rules(cfg, mesh, *, zero1: bool = True) -> Dict[str, AxisVal]:
    plan = cfg.mesh_plan
    sizes = axis_sizes(mesh)
    has_pod = "pod" in sizes
    tensor = sizes.get("tensor", 1)
    batch: AxisVal = ("pod", "data") if has_pod else ("data",)

    rules: Dict[str, AxisVal] = {
        # --- params -------------------------------------------------------
        "stage": "pipe" if plan.pipe_role == "stage" else None,
        "layer": None,
        "embed": "data" if plan.fsdp else None,
        "embed2": None,
        "heads": "tensor" if cfg.n_heads % tensor == 0 else None,
        "kv": "tensor" if (cfg.n_kv_heads % tensor == 0) else None,
        "mlp": "tensor" if cfg.d_ff % tensor == 0 else None,
        "vocab": "tensor",
        "expert": "tensor",
        "ssm": "tensor",
        # --- activations ----------------------------------------------------
        "act_batch": batch,
        "act_seq": "pipe" if plan.pipe_role == "context" else None,
        # --- decode caches ------------------------------------------
        "act_kvseq": None,
        "head_dim": None,
        "state": None,
    }
    if cfg.moe is not None and cfg.moe.num_experts % tensor != 0:
        rules["expert"] = None
    return rules


def decode_rules(cfg, mesh, *, global_batch: int) -> Dict[str, AxisVal]:
    """Rules for serve_step cells.  When the request batch cannot occupy the
    data axis (long-context B=1), shard the KV-cache sequence dim over it
    instead (context-parallel cache)."""
    rules = logical_rules(cfg, mesh)
    sizes = axis_sizes(mesh)
    d_sz = sizes.get("data", 1)
    pod = sizes.get("pod", 1)
    if global_batch % (d_sz * pod) != 0:
        rules["act_batch"] = None
        rules["act_kvseq"] = "data"
    # decode has seq len 1 — never context-shard activations
    rules["act_seq"] = None
    return rules


def _resolve(axis: Optional[str], rules: Dict[str, AxisVal]) -> AxisVal:
    if axis is None:
        return None
    return rules.get(axis)


def spec_for_leaf(axes: Sequence[Optional[str]], shape: Sequence[int],
                  rules: Dict[str, AxisVal], sizes: Dict[str, int]
                  ) -> Tuple[AxisVal, ...]:
    used: set = set()
    out: List[AxisVal] = []
    for ax, dim in zip(axes, shape):
        val = _resolve(ax, rules)
        if val is None:
            out.append(None)
            continue
        names = (val,) if isinstance(val, str) else tuple(val)
        names = tuple(n for n in names if n in sizes and n not in used)
        prod = int(np.prod([sizes[n] for n in names])) if names else 1
        if not names or prod == 1 or dim % prod != 0:
            out.append(None)
            continue
        used.update(names)
        out.append(names[0] if len(names) == 1 else names)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map_axes(fn, axes_tree, sds_tree):
    """``fn(axes, leaf)`` over an axes tree (tuples of names are leaves)
    and a tree of the same structure whose leaves have ``.shape``."""
    if _is_axes(axes_tree):
        return fn(axes_tree, sds_tree)
    if isinstance(axes_tree, dict):
        if set(axes_tree) != set(sds_tree):
            raise ValueError(f"trees differ in keys: {sorted(axes_tree)} "
                             f"vs {sorted(sds_tree)}")
        return {k: _map_axes(fn, axes_tree[k], sds_tree[k])
                for k in sorted(axes_tree)}
    if isinstance(axes_tree, (tuple, list)):
        if len(axes_tree) != len(sds_tree):
            raise ValueError("trees differ in length")
        return type(axes_tree)(_map_axes(fn, a, b)
                               for a, b in zip(axes_tree, sds_tree))
    raise TypeError(f"not an axes tree: {type(axes_tree).__name__}")


def shardings_for(axes_tree: Any, sds_tree: Any, mesh,
                  rules: Dict[str, AxisVal]):
    """Spec-tuple tree for (axes, shaped-leaf) trees (the JAX function's
    ``NamedSharding`` tree, each as ``tuple(sharding.spec)``)."""
    sizes = axis_sizes(mesh)
    return _map_axes(lambda axes, sds: spec_for_leaf(axes, sds.shape, rules,
                                                     sizes),
                     axes_tree, sds_tree)


def momentum_rules(cfg, rules: Dict[str, AxisVal],
                   mesh) -> Dict[str, AxisVal]:
    """ZeRO-1: momentum additionally sharded over the data axis on the
    first shardable (so far unsharded) dim — realized by remapping the
    'embed' logical axis of optimizer-state leaves to 'data'."""
    r = dict(rules)
    if r.get("embed") is None:
        r["embed"] = "data"
    return r


def cache_specs(cfg, cache_sds: Any, mesh, rules: Dict[str, AxisVal]):
    """Decode caches (``models.model.input_specs``' cache tree: dicts of
    leaves with ``.shape``, [L, b, s, kv, hd] / states [L, b, h, ...]) ->
    spec tuples.  The JAX twin's heuristic: dim 0 (layers) unsharded;
    dim 1 over the batch axes when they divide it, else the cache length
    (dim 2) over ``data`` (long context at a tiny batch); the last
    divisible heads-like dim from the end over ``tensor``."""
    sizes = axis_sizes(mesh)
    d_sz = sizes.get("data", 1)
    t_sz = sizes.get("tensor", 1)
    bt = rules.get("act_batch") or ("data",)
    bt = (bt,) if isinstance(bt, str) else tuple(bt)

    def leaf(sds) -> Tuple[AxisVal, ...]:
        shp = tuple(sds.shape)
        spec: List[AxisVal] = [None] * len(shp)
        if len(shp) >= 2:
            bprod = int(np.prod([sizes[n] for n in bt if n in sizes]))
            if shp[1] % bprod == 0 and bprod > 1:
                spec[1] = bt[0] if len(bt) == 1 else bt
            elif len(shp) >= 3 and shp[2] % d_sz == 0:
                spec[2] = "data"   # shard seq/cache length instead
        for i in range(len(shp) - 1, 1, -1):
            if spec[i] is None and shp[i] % t_sz == 0 and t_sz > 1 and \
                    shp[i] >= t_sz:
                spec[i] = "tensor"
                break
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        return leaf(tree)
    return walk(cache_sds)


def batch_specs(cfg, batch_sds: Any, mesh, rules: Dict[str, AxisVal]):
    """Specs for a data batch: leading dim batch, second seq."""
    sizes = axis_sizes(mesh)

    def leaf(sds):
        axes = ["act_batch", "act_seq"] + [None] * (len(sds.shape) - 2)
        return spec_for_leaf(axes, sds.shape, rules, sizes)

    if isinstance(batch_sds, dict):
        return {k: batch_specs(cfg, batch_sds[k], mesh, rules)
                for k in sorted(batch_sds)}
    if isinstance(batch_sds, (tuple, list)):
        return type(batch_sds)(batch_specs(cfg, b, mesh, rules)
                               for b in batch_sds)
    return leaf(batch_sds)


# ----------------------------------------- the data axis as replicas
def data_mesh(n_replicas: int, tensor: int = 1) -> RankMesh:
    """The rank grid of a run: ``(data=N, pipe=1, tensor=T)``, tensor
    innermost as in the JAX package's mesh (rank ``d·T + t``); a rank's
    pipeline stages run inside its process."""
    return RankMesh(np.arange(n_replicas * tensor).reshape(
        n_replicas, 1, tensor), ("data", "pipe", "tensor"))


# ------------------------------------------------------ the tensor axis
def tensor_leaf_dims(cfg, model, tensor: int) -> Dict[str, int]:
    """The dim (counted from the end) each parameter leaf, by name, is
    sharded on over a tensor axis of ``tensor`` ranks, under
    :func:`logical_rules` (``spec_for_leaf`` is the one source of
    truth): e.g. ``wq`` on its heads (-1), ``wo`` on its heads (-2),
    ``tok`` on its vocabulary rows (-2).  Leaves absent are replicated.
    Raises when one name would shard on two dims."""
    mesh = data_mesh(1, tensor)
    specs = shardings_for(model.param_axes(), model.param_specs(), mesh,
                          logical_rules(cfg, mesh))
    shapes: List[Tuple[Tuple[str, ...], int]] = []
    _map_axes(lambda axes, sds: shapes.append(len(sds.shape)),
              model.param_axes(), model.param_specs())
    out: Dict[str, int] = {}
    flat: List[Tuple[Tuple[str, ...], tuple]] = []
    _spec_leaves(specs, lambda path, sp: flat.append((path, sp)))
    for (path, spec), nd in zip(flat, shapes):
        dims = [i for i, e in enumerate(spec) if "tensor" in _names(e)]
        if not dims:
            continue
        d = dims[0] - nd
        if out.setdefault(path[-1], d) != d:
            raise ValueError(f"leaf {path[-1]!r} shards over tensor on "
                             f"dims {out[path[-1]]} and {d}")
    return out


def tensor_refusal(cfg, tensor: int) -> Optional[str]:
    """Why ``cfg`` cannot train over a tensor axis of ``tensor`` ranks
    (the three-part form: the combination, why, what runs instead), or
    None.  The port splits the dense decoders' heads, KV heads, MLP and
    vocabulary, the MoE layers' experts, the rwkv6 and mamba2 heads and
    MLA's heads; the encoder-decoder and the vision frontend are not
    split, nor the widths the JAX rules would leave to another dim (an
    expert count or a mamba2 head count ``tensor`` does not divide)."""
    if tensor <= 1:
        return None
    what = None
    if cfg.is_encdec:
        what = ("an encoder-decoder", "the encoder stack and the "
                "cross-attention are not split over tensor ranks")
    elif cfg.frontend == "vision":
        what = ("the vision frontend", "the patch embedding is not "
                "split over tensor ranks")
    elif cfg.moe is not None and (cfg.moe.num_experts % tensor or (
            cfg.moe.num_shared and cfg.d_ff % tensor)):
        what = (f"{cfg.moe.num_experts} MoE experts of d_ff {cfg.d_ff}",
                f"{tensor} must divide the experts and, with shared "
                f"experts, d_ff (the JAX rules put the experts' MLP over "
                f"tensor where it does not divide the experts, or keep "
                f"the shared experts whole, neither of which is ported)")
    elif cfg.ssm is not None and cfg.ssm.kind == "mamba2":
        d_in = cfg.ssm.expand * cfg.d_model
        nh = d_in // cfg.ssm.head_dim
        if nh % tensor or cfg.n_heads % tensor:
            what = (f"{nh} mamba2 heads", f"a rank's block "
                    f"of the 'ssm' columns must be its own heads, and "
                    f"{tensor} must divide both {nh} and the {cfg.n_heads} "
                    f"'heads' of the rules")
    if what is None:
        return None
    return (f"unsupported combination: --tensor {tensor} with {cfg.name}'s "
            f"{what[0]} — {what[1]}; the port's tensor axis splits the "
            f"dense decoders' heads, KV heads, MLP and vocabulary, the MoE "
            f"experts, the rwkv6 and mamba2 heads and MLA's heads; "
            f"supported alternative: --tensor 1 (with --data and --pipe), "
            f"or a decoder that splits (granite-8b, granite-20b, "
            f"starcoder2-15b, deepseek-moe-16b, grok-1-314b, rwkv6-7b, "
            f"zamba2-1.2b, minicpm3-4b)")


# leaves a rank holds as its block of each of several equal parts of the
# sharded dim, where the JAX rules' contiguous block would not be the
# rank's own heads: mamba2's w_zx is [z | x], and a rank needs z and x
# of its heads (GSPMD reshards at the split; the port keeps the pair)
TENSOR_PARTS = {"w_zx": 2}


def tensor_block(x: torch.Tensor, dim: int, rank: int, world: int,
                 parts: int = 1) -> torch.Tensor:
    """Rank ``rank`` of ``world``'s block of ``x`` along ``dim``: a view,
    or with ``parts`` > 1 its block of each of the dim's ``parts`` equal
    parts, concatenated (a copy)."""
    n = x.shape[dim]
    if n % (world * parts):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {parts} part(s) over {world} tensor ranks")
    per = n // parts
    b = per // world
    if parts == 1:
        return x.narrow(dim, rank * b, b)
    return torch.cat([x.narrow(dim, i * per + rank * b, b)
                      for i in range(parts)], dim)


def tensor_leaf(path: Sequence[str], leaf, dims: Dict[str, int], rank: int,
                world: int):
    """The rank's block of a whole leaf at ``path`` (a copy) where
    ``dims`` shards it, else the leaf."""
    d = dims.get(path[-1]) if path else None
    if d is None or not isinstance(leaf, torch.Tensor) or leaf.dim() < -d:
        return leaf
    return tensor_block(leaf, leaf.dim() + d, rank, world,
                        TENSOR_PARTS.get(path[-1], 1)).clone()


def gather_tensor(tree, dims: Dict[str, int], group):
    """A tree of tensor-sharded leaves (params, momentum, ``pred``, the
    weight stashes: any leaf named in ``dims`` whose rank reaches the
    dim) made whole on every rank of the tensor ``group`` (a
    collective; a :data:`TENSOR_PARTS` leaf reordered into its parts);
    other leaves as they are."""
    from repro_torch.models.layers import tree_map
    if group is None or group.world == 1:
        return tree

    def one(path, leaf):
        d = dims.get(path[-1]) if path else None
        if d is None or not isinstance(leaf, torch.Tensor) or \
                leaf.dim() < -d:
            return leaf
        dim = leaf.dim() + d
        whole = group.all_gather_dim(leaf, dim)
        parts = TENSOR_PARTS.get(path[-1], 1)
        if parts == 1:
            return whole
        bs = whole.split(leaf.shape[dim] // parts, dim)  # rank-major
        return torch.cat([bs[r * parts + i] for i in range(parts)
                          for r in range(group.world)], dim)
    return tree_map(one, tree)


def _names(spec_entry) -> Tuple[str, ...]:
    if spec_entry is None:
        return ()
    return (spec_entry,) if isinstance(spec_entry, str) else spec_entry


def check_data_replicated(cfg, axes_tree, shapes_tree, mesh) -> int:
    """Every parameter leaf's spec under ``logical_rules`` must leave the
    ``data`` axis out (the replicas each hold the whole model).  Returns
    the number of leaves checked; raises ``ValueError`` in three parts
    (what, why, what runs instead) naming the first leaf that shards
    over ``data``."""
    specs = shardings_for(axes_tree, shapes_tree, mesh,
                          logical_rules(cfg, mesh))
    bad, n = [], [0]

    def one(path, spec):
        n[0] += 1
        if any("data" in _names(e) for e in spec):
            bad.append(("/".join(path), spec))
    _spec_leaves(specs, one)
    if bad:
        path, spec = bad[0]
        raise ValueError(
            f"--data with a parameter layout sharded over 'data' "
            f"({'fsdp=True, ' if cfg.mesh_plan.fsdp else ''}{len(bad)} "
            f"leaves, e.g. {path} -> {spec}) is not supported: the port "
            f"runs the data axis as replicas that each hold the whole "
            f"model and all-reduce their gradients; use a config with "
            f"fsdp=False, or --pipe to split the model over stages")
    return n[0]


def _spec_leaves(tree, fn, path: Tuple[str, ...] = ()) -> None:
    """``fn(path, spec)`` over a spec-tuple tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _spec_leaves(tree[k], fn, path + (str(k),))
    elif isinstance(tree, list) or (isinstance(tree, tuple)
                                    and not _is_spec(tree)):
        for i, t in enumerate(tree):
            _spec_leaves(t, fn, path + (str(i),))
    else:
        fn(path, tree)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(n, str) for n in e))
        for e in x)


def zero1_layout(cfg, axes_tree, shapes_tree, mesh) -> Dict[str, int]:
    """ZeRO-1's momentum layout under the JAX rules (:func:`momentum_rules`)
    over the parameter leaves: how many leaves shard over ``data`` and
    the momentum bytes a rank holds (fp32), against the replicated
    layout.  The port's pieces (:func:`shard_range` of each leaf's flat
    elements) hold exactly these bytes where every leaf shards."""
    sizes = axis_sizes(mesh)
    rules = momentum_rules(cfg, logical_rules(cfg, mesh), mesh)
    specs = shardings_for(axes_tree, shapes_tree, mesh, rules)
    out = {"leaves": 0, "sharded": 0, "replicated_bytes": 0,
           "zero1_bytes": 0}
    flat_shapes: List[Tuple[int, ...]] = []
    _map_axes(lambda _, sds: flat_shapes.append(tuple(sds.shape)),
              axes_tree, shapes_tree)
    flat_specs: List[tuple] = []
    _spec_leaves(specs, lambda _, sp: flat_specs.append(sp))
    for shape, spec in zip(flat_shapes, flat_specs):
        n = int(np.prod(shape)) * 4
        div = int(np.prod([sizes[a] for e in spec for a in _names(e)]))
        out["leaves"] += 1
        out["sharded"] += int(any("data" in _names(e) for e in spec))
        out["replicated_bytes"] += n
        out["zero1_bytes"] += n // div
    return out


def local_rows(batch: Dict[str, Any], specs: Dict[str, tuple], mesh,
               rank: int) -> Dict[str, Any]:
    """This rank's block of a global batch: each leaf cut along every dim
    its spec names, the block index the rank's coordinates on those axes
    (row-major over the named axes), as a ``data``-sharded leading dim
    places contiguous blocks of ``B / N`` rows."""
    sizes = axis_sizes(mesh)
    coords = rank_coords(mesh, rank)
    out = {}
    for k, x in batch.items():
        for dim, entry in enumerate(specs[k]):
            names = _names(entry)
            if not names:
                continue
            n = int(np.prod([sizes[a] for a in names]))
            idx = 0
            for a in names:
                idx = idx * sizes[a] + coords[a]
            size = x.shape[dim]
            if size % n:
                raise ValueError(f"batch leaf {k!r} dim {dim} of size "
                                 f"{size} does not split over {names} "
                                 f"({n} blocks)")
            blk = size // n
            sl = [slice(None)] * len(x.shape)
            sl[dim] = slice(idx * blk, (idx + 1) * blk)
            x = x[tuple(sl)]
        out[k] = x
    return out


def replica_rows(batch: Dict[str, Any], units: int, rank: int,
                 world: int) -> Dict[str, Any]:
    """Replica ``rank`` of ``world``'s rows of a global batch that runs
    as ``units`` forward units (microbatches, ticks or a round's
    microbatches) of ``B / units`` rows each, in order: :func:`local_rows`'
    block of every unit (its rows sharded over ``data``), the units kept
    in order.  Each forward on a replica then sees its block of the unit
    the one-process run would forward: what GSPMD computes when every
    unit's rows shard over ``data`` (an MoE layer's dispatch groups and
    a microbatch's loss stay the whole unit's).  ``units`` 1 gives
    :func:`local_rows`' block of the batch.  Leaves are numpy arrays or
    tensors with the batch on their leading dim; raises ``ValueError``
    when ``units · world`` does not divide it."""
    mesh = data_mesh(world)
    out = {}
    for k, x in batch.items():
        B, rest = int(x.shape[0]), tuple(x.shape[1:])
        if B % units:
            raise ValueError(f"batch leaf {k!r} of {B} rows does not split "
                             f"into {units} units")
        xs = x.reshape((units, B // units) + rest)
        blk = local_rows({k: xs}, {k: (None, "data")}, mesh, rank)[k]
        out[k] = blk.reshape((-1,) + rest)
    return out
