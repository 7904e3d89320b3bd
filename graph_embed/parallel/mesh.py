"""Device mesh helpers.

The reference is single-node shared-memory (OpenMP only, CMakeLists.txt:
18-24); here the scaling axis is the edge list sharded over a 1D mesh with
vertex-block sharding for the dense terms (SURVEY.md SS2.2, SS5
long-context row).  Collectives are XLA's (NCCL on GPUs).  The cards of one
host are joined all to all, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

EDGE_AXIS = "x"


def make_mesh(n_devices: int | None = None, *,
              axis: str = EDGE_AXIS) -> Mesh:
    """1D device mesh over the first ``n_devices`` devices of the default
    backend (all of them by default).  Asking for more devices than the
    backend has is an error; tests get virtual CPU devices from
    ``--xla_force_host_platform_device_count`` instead."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, the "
                         f"{devs[0].platform} backend has {len(devs)}")
    return jax.make_mesh((n_devices,), (axis,), devices=devs[:n_devices])


def edge_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(EDGE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
