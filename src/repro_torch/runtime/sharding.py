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

The SPMD data/tensor rules of the JAX module (``logical_rules``,
``spec_for_leaf``, ``stream_state_shardings``, ...) are not ported.
"""
from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo-host", "gloo")
TAG_FWD, TAG_BWD, TAG_CTL, TAG_PREFILL = 1, 2, 3, 4

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
    copies and waits included."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 transport: str, cards: Optional[int] = None):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; known: "
                             f"{TRANSPORTS}")
        self.rank, self.world = rank, world
        self.device, self.transport = device, transport
        self.next, self.prev = (rank + 1) % world, (rank - 1) % world
        self.cards = cards
        self.t0 = time.perf_counter()   # when the rank began to join
        self.reset_counters()

    def reset_counters(self) -> None:
        self.n_sent = self.bytes_sent = 0
        self.n_recv = self.bytes_recv = 0
        self.n_ctl = self.bytes_ctl = 0
        self.transport_s = 0.0

    def counters(self) -> Dict[str, float]:
        return {"n_sent": self.n_sent, "bytes_sent": self.bytes_sent,
                "n_recv": self.n_recv, "bytes_recv": self.bytes_recv,
                "n_ctl": self.n_ctl, "bytes_ctl": self.bytes_ctl,
                "transport_s": self.transport_s}

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
                ops.append(dist.P2POp(dist.isend, self._wire(t), dst,
                                      tag=tag))
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
                ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
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
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj`` (small, picklable), in rank order."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


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
