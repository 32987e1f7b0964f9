"""Multi-host (multi-process) entry points.

The single-process mesh machinery (parallel/mesh.py + shardesa.py)
covers one host's devices; a cluster runs one process per host and
needs ``jax.distributed`` initialized BEFORE any device is touched.
This module is that entry point plus the global-mesh helper, mirroring
how the reference's distribution seams (superbuckets
vdfstrav.c:419-499, mergeesa.c text sharding) map onto devices and
hosts:

- rank-range (superbucket) sharding of one index stays among the
  devices of one host — shard_map collectives in shardesa.py;
- text sharding across hosts (one sub-database per host, merged by
  index/merge.py rank arithmetic) is the inter-host seam: each host
  builds its shard locally, the cross-counts of merge_indexes are the
  only inter-host traffic.

Usage (one process per host)::

    from vstree_tpu.parallel.distributed import (
        init_multihost, global_mesh)
    init_multihost()                    # env-driven, or pass args
    mesh = global_mesh()                # all devices of all hosts
    esa = build_esa(ms, alpha, mesh=mesh)

Driven by the standard JAX env variables
(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or by
explicit arguments.
"""

from __future__ import annotations

import os


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """Initialize jax.distributed for a multi-process run.

    Arguments default to the JAX_* environment variables; returns
    False (no-op) when neither arguments nor environment describe a
    multi-process setup — single-process runs stay untouched.
    """
    import jax

    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        v = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("JAX_PROCESS_ID")
        process_id = int(v) if v else None
    if not coordinator_address or not num_processes \
            or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return True


def global_mesh():
    """(dp, sp) mesh over EVERY device of EVERY initialized process
    (jax.devices() is global after init_multihost)."""
    import jax

    from .mesh import make_mesh

    return make_mesh(jax.devices())
