"""Multi-host initialization and sharding helpers.

The reference is strictly single-node (OpenMP, CMakeLists.txt:18-24).
Across hosts, XLA's collectives are the backend (SURVEY.md SS5
distributed-comm row): this module only wraps ``jax.distributed`` bootstrap
and global-mesh construction; the sharded FA step in parallel/sharded.py is
topology-agnostic (its 1D edge axis simply spans all hosts' devices, with
psum_scatter/all_gather riding the intra-host links and the network
across hosts).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

from .mesh import EDGE_AXIS


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bootstrap multi-process JAX (no-op if already initialized or
    single-process).  Pass all three arguments where no cluster runtime
    sets them (a single GPU host: ``coordinator_address="localhost:<port>"``,
    one process id per process)."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process


def global_mesh(axis: str = EDGE_AXIS) -> Mesh:
    """1D mesh over every device of every process."""
    return jax.make_mesh((len(jax.devices()),), (axis,))


def process_local_edge_slice(num_edges_padded: int) -> tuple[int, int]:
    """[start, stop) of the edge axis this process should materialize when
    building sharded arrays with ``jax.make_array_from_callback`` (avoids
    loading the full edge list on every host)."""
    nproc = jax.process_count()
    pid = jax.process_index()
    per = num_edges_padded // nproc
    return pid * per, (pid + 1) * per


def shard_edges_global(arrays, mesh: Mesh, axis: str = EDGE_AXIS):
    """Assemble edge-axis-sharded global arrays without materializing the
    full edge list on every host: each 1-D input is sliced per device shard
    through ``jax.make_array_from_callback``.  ``arrays`` may be host numpy
    (each process passes at least its own slice; a memory-mapped or
    process-local view works) -- the callback only reads the rows the local
    devices own.  Single-process this reduces to a sharded device_put, so
    the same assembly path is exercised by the virtual-mesh dryrun."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))

    def one(a):
        shape = a.shape
        return jax.make_array_from_callback(
            shape, sharding, lambda idx: a[idx])

    return tuple(one(a) for a in arrays)
