"""Mesh builders (the port of ``repro.launch.mesh``).

Functions, not module constants: building a :class:`SimMesh` allocates
nothing, so the production meshes serve as descriptors (specs, shard
shapes, bytes) without 256 devices' worth of memory.
"""

from __future__ import annotations

from repro_torch.dist.sharding import SimMesh


def make_production_mesh(*, multi_pod: bool = False) -> SimMesh:
    """The reference's ``(16, 16)`` ``("data", "model")`` mesh, or with
    ``multi_pod`` its ``(2, 16, 16)`` ``("pod", "data", "model")`` mesh."""
    if multi_pod:
        return SimMesh((2, 16, 16), ("pod", "data", "model"))
    return SimMesh((16, 16), ("data", "model"))


def make_host_mesh(ranks: int) -> SimMesh:
    """A 1-D data mesh: ``ranks`` simulated ranks on one device, or the
    processes of a ``torch.distributed`` group (its world size)."""
    return SimMesh(ranks)
