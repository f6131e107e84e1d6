"""Device meshes and sharding for multi-chip scaling.

The reference's only parallelism is a thread pool fanning trees over BEAGLE
instances (fat_beagle.hpp:119-149); the replacement here is SPMD over a
jax.sharding Mesh:

  * "dp"  — data parallel over particles/trees (the FatBeagleParallelize
    axis);
  * "sp"  — sequence parallel over site patterns (per-pattern log-likelihood
    terms dot pattern weights commute with psum, gp_engine.cpp:213-220);

Gradients reduce with XLA-inserted collectives (psum over dp for parameter
gradients, psum over sp inside each tree's likelihood). The cards of one
host are joined all to all, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    sp: int = 1,
    devices=None,
) -> Mesh:
    """A (dp, sp) mesh over the first n devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if dp is None:
        dp = n_devices // sp
    assert dp * sp == n_devices, f"{dp} * {sp} != {n_devices}"
    return Mesh(devices.reshape(dp, sp), axis_names=("dp", "sp"))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (particles/trees) over dp; replicate the rest."""
    return NamedSharding(mesh, P("dp"))

def pattern_sharding(mesh: Mesh, pattern_axis: int = -1) -> NamedSharding:
    """Shard the trailing pattern axis over sp."""
    spec = [None] * max(1, pattern_axis + 1) if pattern_axis >= 0 else None
    if pattern_axis < 0:
        return NamedSharding(mesh, P(*(["sp"])))
    spec = [None] * pattern_axis + ["sp"]
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_particle_batch(mesh: Mesh, *arrays):
    """Device-put arrays with axis 0 sharded over dp."""
    sh = particle_sharding(mesh)
    return tuple(jax.device_put(np.asarray(a), sh) for a in arrays)


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Pad axis to a multiple (sharded axes must divide evenly); returns
    (padded, original_size)."""
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array, n
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - n)
    return np.pad(array, pad, mode="edge"), n
