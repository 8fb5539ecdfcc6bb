"""PipeDream-style stage partitioning (1806.03377 §3.1); twin of
``repro/planner/partition.py``, pure Python, copied from the JAX package.

Splits a contiguous layer list into N pipeline stages minimizing the
*bottleneck*: the steady-state throughput of a 1F1B pipeline is set by
its slowest stage, where a stage's cost is its per-layer compute plus the
cost of receiving its input activations over the inter-GPU link.

``dp_split`` is the exact O(L²·N) dynamic program over per-layer scalar
costs; ``partition_profile`` wraps it for :mod:`repro_torch.planner.profiler`
profiles, converting FLOPs and activation bytes to seconds with the
hardware constants of the paper's platform (4×P40 over PCIe 3.0 x16).
``uniform`` is the equal-layer-count baseline the repo used to hardcode.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

# the paper's platform (§4.1), as the JAX twin models it
PEAK_FLOPS = 11.76e12 * 0.35    # fp32 peak × achievable efficiency
LINK_BW = 12.0e9                # bytes/s effective per PCIe link
BWD_FWD_RATIO = 2.0             # bwd ≈ 2× fwd compute


@dataclass(frozen=True)
class Partition:
    """Contiguous stage split: stage s owns layers
    ``[boundaries[s], boundaries[s+1])``."""
    boundaries: Tuple[int, ...]

    @property
    def n_stages(self) -> int:
        return len(self.boundaries) - 1

    @property
    def n_layers(self) -> int:
        return self.boundaries[-1]

    def stages(self) -> Tuple[Tuple[int, int], ...]:
        b = self.boundaries
        return tuple((b[s], b[s + 1]) for s in range(self.n_stages))

    def sizes(self) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.stages())

    def stage_of(self, layer: int) -> int:
        for s, (lo, hi) in enumerate(self.stages()):
            if lo <= layer < hi:
                return s
        raise ValueError(f"layer {layer} outside partition")


def _check(n_layers: int, n_stages: int) -> None:
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layers < n_stages:
        raise ValueError(
            f"cannot split {n_layers} layers into {n_stages} stages")


def uniform(n_layers: int, n_stages: int) -> Partition:
    """Equal-count contiguous split (remainder spread over early stages)."""
    _check(n_layers, n_stages)
    base, rem = divmod(n_layers, n_stages)
    bounds = [0]
    for s in range(n_stages):
        bounds.append(bounds[-1] + base + (1 if s < rem else 0))
    return Partition(tuple(bounds))


def stage_cost(compute: Sequence[float], cut_cost: Sequence[float],
               lo: int, hi: int) -> float:
    """Cost of a stage covering layers [lo, hi): compute plus the
    transfer cost of its incoming activation cut (0 for stage 0)."""
    c = sum(compute[lo:hi])
    if lo > 0:
        c += cut_cost[lo - 1]
    return c


def bottleneck(compute: Sequence[float], cut_cost: Sequence[float],
               part: Partition) -> float:
    return max(stage_cost(compute, cut_cost, lo, hi)
               for lo, hi in part.stages())


def dp_split(compute: Sequence[float], cut_cost: Sequence[float],
             n_stages: int) -> Partition:
    """Exact bottleneck-minimizing contiguous split.

    ``compute[j]``  — cost of executing layer j on a stage;
    ``cut_cost[j]`` — cost of cutting *after* layer j (transferring its
    output activations, fwd + cotangents bwd, to the next stage).

    DP over (prefix length, stage count):
      T[m][j] = min over i of max(T[m−1][i], stage_cost(i, j))
    with prefix sums making each stage_cost O(1).
    """
    L = len(compute)
    _check(L, n_stages)
    if len(cut_cost) not in (L, L - 1):
        raise ValueError(f"cut_cost length {len(cut_cost)} for {L} layers")

    prefix = [0.0]
    for c in compute:
        prefix.append(prefix[-1] + float(c))

    def cost(lo: int, hi: int) -> float:
        c = prefix[hi] - prefix[lo]
        if lo > 0:
            c += float(cut_cost[lo - 1])
        return c

    INF = float("inf")
    # T[m][j]: best bottleneck splitting layers [0, j) into m stages
    T = [[INF] * (L + 1) for _ in range(n_stages + 1)]
    arg = [[-1] * (L + 1) for _ in range(n_stages + 1)]
    T[0][0] = 0.0
    for m in range(1, n_stages + 1):
        for j in range(m, L + 1):
            best, best_i = INF, -1
            for i in range(m - 1, j):
                if T[m - 1][i] == INF:
                    continue
                v = max(T[m - 1][i], cost(i, j))
                if v < best:
                    best, best_i = v, i
            T[m][j] = best
            arg[m][j] = best_i
    bounds = [L]
    j = L
    for m in range(n_stages, 0, -1):
        j = arg[m][j]
        bounds.append(j)
    return Partition(tuple(reversed(bounds)))


# ---------------------------------------------------------------------------
# profile-level wrappers


def _costs_from_profile(profile, *, peak_flops: float = PEAK_FLOPS,
                        link_bw: float = LINK_BW
                        ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """(compute seconds per layer, cut seconds after each layer).

    Compute counts fwd + bwd (≈3× fwd cost); measured wall time
    (``time_s``, the ``timed`` profile method) is preferred over the
    FLOPs/peak model when present — PipeDream's "profile, don't model".
    A cut moves the boundary activations forward and their cotangents
    backward (2× the bytes).
    """
    compute = tuple(
        (1.0 + BWD_FWD_RATIO) * (lp.time_s if lp.time_s > 0.0
                                 else lp.flops / peak_flops)
        for lp in profile.layers)
    cut = tuple(2.0 * lp.act_bytes / link_bw for lp in profile.layers)
    return compute, cut


def partition_profile(profile, n_stages: int, *, method: str = "dp",
                      peak_flops: float = PEAK_FLOPS,
                      link_bw: float = LINK_BW) -> Partition:
    compute, cut = _costs_from_profile(profile, peak_flops=peak_flops,
                                       link_bw=link_bw)
    if method == "uniform":
        return uniform(len(compute), n_stages)
    if method == "dp":
        return dp_split(compute, cut, n_stages)
    raise ValueError(f"unknown partition method {method!r}")


def profile_bottleneck(profile, part: Partition, *,
                       peak_flops: float = PEAK_FLOPS,
                       link_bw: float = LINK_BW) -> float:
    compute, cut = _costs_from_profile(profile, peak_flops=peak_flops,
                                       link_bw=link_bw)
    return bottleneck(compute, cut, part)


def profile_stage_costs(profile, part: Partition, *,
                        peak_flops: float = PEAK_FLOPS,
                        link_bw: float = LINK_BW) -> Tuple[float, ...]:
    """Modelled per-stage seconds (compute + incoming cut) for a
    partition — the realized per-stage cost a run under this plan pays;
    its max is :func:`profile_bottleneck`."""
    compute, cut = _costs_from_profile(profile, peak_flops=peak_flops,
                                       link_bw=link_bw)
    return tuple(stage_cost(compute, cut, lo, hi)
                 for lo, hi in part.stages())
