"""Meshes of devices for the distributed transform.

The counterpart of ``sventt_tpu/parallel/mesh.py``.  The port is single
controller, as the JAX package is: one process holds the D shards of a
vector, one per mesh device, and drives every device itself.  A mesh is the
devices in order, the axis names and the shape; a multi-axis mesh lists its
devices in row-major order of its axes, as ``jax.make_mesh`` does.

A mesh may name one device more than once: its shards are then *logical
shards* of that device (``["cuda:0"] * 4`` on one card, ``["cpu"] * 8`` in
the tests).  The caller asks for them explicitly; by default a mesh takes
distinct CUDA cards.  Building a mesh of two or more cards turns on peer
access between each pair, which the ring all-to-all (``comm="ring"``) needs
to read a peer's memory; a pair that cannot raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

AXIS = "shard"


@dataclass(frozen=True)
class Mesh:
    """``devices`` in row-major order over ``axis_names`` of sizes
    ``axis_sizes``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(
                f"mesh shape {self.axis_sizes} needs {math.prod(self.axis_sizes)} devices, "
                f"got {len(self.devices)}"
            )

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def devices_along(self, axes: tuple[str, ...]) -> tuple[torch.device, ...]:
        """The devices in the order of the combined axis ``axes`` (row-major
        over ``axes`` as given), which must name every axis of the mesh."""
        if sorted(axes) != sorted(self.axis_names):
            raise ValueError(f"axes {axes} do not cover the mesh axes {self.axis_names}")
        strides = {}
        step = 1
        for name, size in reversed(tuple(zip(self.axis_names, self.axis_sizes))):
            strides[name] = step
            step *= size
        order = [0]
        for name in axes:
            size = self.shape[name]
            order = [i + j * strides[name] for i in order for j in range(size)]
        return tuple(self.devices[i] for i in order)


    def replica_groups(self, axes: tuple[str, ...]) -> tuple[tuple[torch.device, ...], ...]:
        """The devices along the collective axis ``axes`` (row-major over
        ``axes`` as given), once per combination of the other axes'
        indices (row-major in the mesh's order): the groups among which a
        vector sharded over ``axes`` is replicated, as ``P(axes)`` lays it
        out in ``shard_map``.  One group when ``axes`` names every axis."""
        if len(set(axes)) != len(axes) or not set(axes) <= set(self.axis_names):
            raise ValueError(f"axes {axes} are not distinct axes of {self.axis_names}")
        strides, step = {}, 1
        for name, size in reversed(tuple(zip(self.axis_names, self.axis_sizes))):
            strides[name] = step
            step *= size

        def offsets(names) -> list[int]:
            out = [0]
            for name in names:
                out = [i + j * strides[name] for i in out for j in range(self.shape[name])]
            return out

        rest = [a for a in self.axis_names if a not in axes]
        along = offsets(axes)
        return tuple(
            tuple(self.devices[base + i] for i in along) for base in offsets(rest)
        )


def _devices(devices, count: int | None) -> tuple[torch.device, ...]:
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if count is None:
        count = len(devices)
    if count > len(devices) or count < 1:
        raise ValueError(f"requested {count} devices, have {len(devices)}")
    out = []
    for d in devices[:count]:
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {d}")
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return tuple(out)


def _enable_peers(devices: tuple[torch.device, ...]) -> None:
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    if len(cards) > 1:
        from .ring import enable_peer_access

        enable_peer_access(cards)


def make_mesh(axis_sizes: tuple[int, ...], axis_names: tuple[str, ...], *, devices=None) -> Mesh:
    """A mesh of shape ``axis_sizes`` over the first prod(axis_sizes) of
    ``devices`` (default: the CUDA cards), row-major."""
    devs = _devices(devices, math.prod(axis_sizes))
    mesh = Mesh(devs, tuple(axis_names), tuple(axis_sizes))
    _enable_peers(devs)
    return mesh


def make_ntt_mesh(n_devices: int | None = None, axis: str = AXIS, *, devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all) of
    ``devices``, or of the CUDA cards when ``devices`` is None."""
    devs = _devices(devices, n_devices)
    return make_mesh((len(devs),), (axis,), devices=devs)
