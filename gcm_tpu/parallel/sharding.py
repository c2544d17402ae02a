"""Spatial domain decomposition as sharding metadata, not code.

Counterpart of the reference's MPI distribution (SURVEY.md §2
component 17, §5.8): the reference splits its CubicGrid along one axis
across MPI ranks and hand-codes halo Sendrecv per stage. Here the *same
global program* (gcm_tpu.solver.gcm) runs under jit over a
``jax.sharding.Mesh``; the stencil shifts (slice+concat in
gcm_tpu.ops.interp.shift) partition into neighbor collective-permutes,
and the boundary-slab writes land on edge shards — XLA's SPMD
partitioner derives all communication. Sharded and unsharded executions are
numerically identical (tests/test_sharding.py).

Mesh axes are named after the spatial axes they split: ``('sx', 'sy')``.
The innermost (last) spatial axis is never sharded: it is the contiguous
axis in memory, so every shard keeps whole contiguous rows for the stage
sweeps and the halo slabs of the sharded axes are contiguous blocks.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into two near-square factors (a*b == n, a >= b)."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


def domain_mesh(
    dim: int,
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, ...]] = None,
) -> Mesh:
    """Build a device mesh over the shardable spatial axes.

    dim 1 → 1D mesh ('sx',) — but a 1D domain shards its only axis;
    dim 2 → ('sx',) over the first axis (the second stays contiguous);
    dim 3 → ('sx', 'sy') near-square over the first two axes.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dim >= 3:
        a, b = _factor2(n) if shape is None else shape
        dev = np.asarray(devices).reshape(a, b)
        return Mesh(dev, ("sx", "sy"))
    dev = np.asarray(devices)
    if shape is not None:
        dev = dev.reshape(shape)
    return Mesh(dev, ("sx",))


def field_sharding(mesh: Mesh, dim: int) -> NamedSharding:
    """Sharding for the state array u[ncomp, *spatial]."""
    spatial = _spatial_spec(mesh, dim)
    return NamedSharding(mesh, P(None, *spatial))


def material_sharding(mesh: Mesh, dim: int) -> NamedSharding:
    """Sharding for per-node material fields [*spatial]."""
    return NamedSharding(mesh, P(*_spatial_spec(mesh, dim)))


def _spatial_spec(mesh: Mesh, dim: int) -> Tuple:
    # a mesh may carry only one of the two axis names (e.g. the
    # canonical+sharded contact composition shards ONLY the middle axis
    # via a ('sy',)-mesh, keeping the leading contact axis whole)
    names = mesh.axis_names
    sx = "sx" if "sx" in names else None
    if dim == 1:
        return (sx,)
    if dim == 2:
        return (sx, None)
    return (sx, "sy" if "sy" in names else None, None)


def shard_state(u, mat, mesh: Mesh):
    """Place state + materials onto the mesh with domain-decomposed layout."""
    dim = u.ndim - 1
    u = jax.device_put(u, field_sharding(mesh, dim))
    ms = material_sharding(mesh, dim)
    mat = jax.tree.map(lambda a: jax.device_put(a, ms), mat)
    return u, mat
