"""Rank grids: the port's counterpart of ``repro/runtime/mesh_utils.py``.

The JAX package lays its devices out in a ``jax.sharding.Mesh`` and lets
the SPMD compiler place every shard.  The port has no SPMD compiler: a
mesh axis becomes a set of processes (the ``pipe`` axis one rank per
stage, the ``data`` axis one replica per rank).  A :class:`RankMesh` is
therefore an integer array of ranks with its axis names; it needs no
device, so the production grids (256 or 512 ranks) are shape arithmetic
that the sharding rules (``runtime/sharding.py``) read.

:func:`refine_mesh` and :func:`axis_sizes` follow the JAX functions
line for line (``(pod?, data, model) -> (pod?, data, pipe, tensor)``,
the same ``ValueError``); :func:`axis_groups` gives the rank tuples
along one axis, the groups ``torch.distributed.new_group`` takes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class RankMesh:
    """An integer array of ranks (``devices``, as the JAX ``Mesh`` names
    its array) and one name per axis (``axis_names``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d rank array with axis "
                             f"names {self.axis_names}")
        if self.devices.dtype.kind not in "iu":
            raise ValueError(f"a rank mesh holds integer ranks, got "
                             f"{self.devices.dtype}")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"RankMesh({axis_sizes(self)})"


def refine_mesh(mesh, pipe: int, tensor: int) -> RankMesh:
    """(pod?, data, model) -> (pod?, data, pipe, tensor)."""
    names = mesh.axis_names
    devs = np.asarray(mesh.devices)
    model = devs.shape[-1]
    if pipe * tensor != model:
        raise ValueError(f"pipe*tensor={pipe * tensor} != model={model}")
    new_shape = devs.shape[:-1] + (pipe, tensor)
    new_names = tuple(names[:-1]) + ("pipe", "tensor")
    return RankMesh(devs.reshape(new_shape), new_names)


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, np.asarray(mesh.devices).shape))


def axis_groups(mesh, axis: str) -> List[Tuple[int, ...]]:
    """The rank tuples along ``axis``: one tuple for every coordinate of
    the other axes, in row-major order of those coordinates, each
    holding the ranks that differ only in ``axis`` (ascending along
    it)."""
    names = tuple(mesh.axis_names)
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r} axis")
    devs = np.moveaxis(np.asarray(mesh.devices), names.index(axis), -1)
    return [tuple(int(r) for r in row)
            for row in devs.reshape(-1, devs.shape[-1])]


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """``rank``'s coordinate on every axis of ``mesh``."""
    hit = np.argwhere(np.asarray(mesh.devices) == rank)
    if len(hit) != 1:
        raise ValueError(f"rank {rank} occurs {len(hit)} times in {mesh}")
    return dict(zip(mesh.axis_names, (int(i) for i in hit[0])))
