"""Multi-host (multi-process) execution: jax.distributed init, global
meshes, and process-local batch assembly.

The reference is strictly single-process (SURVEY.md §2.9: a thread pool over
BEAGLE instances, no MPI/NCCL). The scale-out model here is SPMD:

  * every host runs the same program over its local devices;
  * the particle/tree axis ("dp") shards across ALL devices in the job — the
    per-host sampler contributes its local slice of the global batch
    (jax.make_array_from_process_local_data) and XLA allreduces the ELBO
    gradients;
  * the pattern axis ("sp") shards within a host (per-pattern terms dot
    pattern weights commute with psum).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> bool:
    """Initialize jax.distributed for a multi-host job.

    Arguments default to LIBSBN_COORDINATOR / LIBSBN_NUM_PROCESSES /
    LIBSBN_PROCESS_ID. With neither a coordinator nor a process count the
    run is single-process and nothing is initialized. Returns True if
    distributed mode was initialized. Idempotent."""
    if getattr(initialize, "_done", False):
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "LIBSBN_COORDINATOR"
    )
    if num_processes is None and "LIBSBN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LIBSBN_NUM_PROCESSES"])
    if process_id is None and "LIBSBN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LIBSBN_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    initialize._done = True
    return jax.process_count() > 1


def global_mesh(dp: Optional[int] = None, sp: int = 1) -> Mesh:
    """A (dp, sp) mesh over ALL devices in the job (every process must call
    this with the same arguments)."""
    from jax.experimental import mesh_utils

    n = len(jax.devices())
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"dp*sp = {dp}*{sp} != {n} devices"
    devices = mesh_utils.create_device_mesh((dp, sp))
    return Mesh(devices, axis_names=("dp", "sp"))


def local_particle_count(mesh: Mesh, global_count: int) -> int:
    """This process's share of a dp-sharded particle axis."""
    procs = jax.process_count()
    assert global_count % procs == 0, (
        f"global particle count {global_count} must divide process count "
        f"{procs}"
    )
    return global_count // procs


def from_process_local(sharding, local_rows: np.ndarray, global_rows: int):
    """Assemble a global dp-sharded array from this process's local rows
    (jax.make_array_from_process_local_data). Single-process: device_put."""
    if jax.process_count() == 1:
        return jax.device_put(local_rows, sharding)
    global_shape = (global_rows,) + tuple(local_rows.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, local_rows, global_shape
    )
