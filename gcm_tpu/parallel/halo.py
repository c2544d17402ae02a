"""Explicit halo exchange + shard_map step: the manual distribution path.

Two distribution paths exist (SURVEY.md §5.8):

1. **GSPMD (gcm_tpu.parallel.sharding)**: jit the global program over
   sharded arrays; XLA derives the halo collectives.
2. **shard_map + explicit halo (this module, the engines' mesh path)**:
   each shard runs the jnp sweep on its local block extended by an r-deep
   halo fetched from neighbors with ``lax.ppermute`` (the reference's
   MPI_Sendrecv analogue, SURVEY.md §2 component 17; on GPUs XLA hands the
   permutes to NCCL).

Border conditions: the raw sweep runs border-free on the extended block;
global-edge shards then apply the exactly-equivalent post-fixup
(solver.boundary.apply_borders_post), gated by traced ``axis_index``
predicates — one program for every shard.

Materials are static: engines pass a ONCE-prepared per-axis halo-extended
material pytree (:func:`extend_mats_once`), so the per-step exchange moves
only the state. Passing a plain material pytree still works (setup-free
callers, tests) and re-exchanges it each sweep.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcm_tpu.materials import MaterialFields
from gcm_tpu.models.spec import Model
from gcm_tpu.ops.interp import stencil_radius
from gcm_tpu.solver.boundary import apply_borders_post
from gcm_tpu.solver.gcm import stage as jnp_stage
from gcm_tpu.task import BorderSpec

Borders = Dict[Tuple[int, int], BorderSpec]


def halo_exchange(f: jnp.ndarray, axis_name: str, ax: int, r: int):
    """Extend the local block by r-deep neighbor slabs along spatial ``ax``.

    Edge shards (no neighbor on that side) get edge-replicated values, so
    the extended block reproduces the global edge-clamped stencil locally.
    Returns an array with ``shape[ax] + 2r``.
    """
    n_sh = lax.axis_size(axis_name)
    n = f.shape[ax]
    if n_sh == 1:
        # static single-shard axis: pure edge replication, no collective
        edge_lo = jnp.repeat(lax.slice_in_dim(f, 0, 1, axis=ax), r, axis=ax)
        edge_hi = jnp.repeat(lax.slice_in_dim(f, n - 1, n, axis=ax), r,
                             axis=ax)
        return jnp.concatenate([edge_lo, f, edge_hi], axis=ax)
    idx = lax.axis_index(axis_name)

    lo_own = lax.slice_in_dim(f, 0, r, axis=ax)          # my first r rows
    hi_own = lax.slice_in_dim(f, n - r, n, axis=ax)      # my last r rows

    # receive left neighbor's high rows / right neighbor's low rows
    from_left = lax.ppermute(
        hi_own, axis_name, [(i, i + 1) for i in range(n_sh - 1)])
    from_right = lax.ppermute(
        lo_own, axis_name, [(i + 1, i) for i in range(n_sh - 1)])

    # edge shards: replicate own edge row (global edge-clamp semantics)
    edge_lo = jnp.repeat(lax.slice_in_dim(f, 0, 1, axis=ax), r, axis=ax)
    edge_hi = jnp.repeat(lax.slice_in_dim(f, n - 1, n, axis=ax), r, axis=ax)
    from_left = jnp.where(idx == 0, edge_lo, from_left)
    from_right = jnp.where(idx == n_sh - 1, edge_hi, from_right)

    return jnp.concatenate([from_left, f, from_right], axis=ax)


def _crop(f: jnp.ndarray, ax: int, r: int):
    return lax.slice_in_dim(f, r, f.shape[ax] - r, axis=ax)


def _spatial_names(model_dim: int, mesh: Mesh) -> Dict[int, Optional[str]]:
    """Mesh-axis name per spatial dim ('sx' on dim 0, 'sy' on dim 1 in 3D;
    the last, contiguous dim is never sharded). Tolerates meshes without 'sx' — e.g.
    the canonical+sharded ('sy',)-mesh (sharding._spatial_spec supports
    it; hard-coding 'sx' here produced confusing shard_map spec errors,
    code-review r5)."""
    names: Dict[int, Optional[str]] = {a: None for a in range(model_dim)}
    if "sx" in mesh.axis_names:
        names[0] = "sx"
    if model_dim >= 3 and "sy" in mesh.axis_names:
        names[1] = "sy"
    if not any(names.values()):
        raise ValueError(
            f"mesh axes {mesh.axis_names} carry no spatial axis this "
            "module shards ('sx' on dim 0; 'sy' on dim 1 in 3D)")
    return names


def _mat_spec(model_dim: int, mesh: Mesh) -> P:
    names = _spatial_names(model_dim, mesh)
    return P(*[names[a] for a in range(model_dim)])


def extend_mats_once(mat, mesh: Mesh, model_dim: int, order: int) -> Dict:
    """Per-sharded-axis halo-extended copies of the static material pytree,
    built once at setup by an on-device exchange (no host gather).

    Returns ``{"base": mat, "ax<axis>": mat_extended_along_axis, ...}`` — the
    form the step/stage functions detect and consume without any per-step
    material collectives. The sweep along a sharded axis needs materials
    extended along that axis only; border fixups use the local-shape base.
    """
    r = stencil_radius(order)
    m_spec = _mat_spec(model_dim, mesh)
    out: Dict = {"base": mat}
    for a, name in _spatial_names(model_dim, mesh).items():
        if name is None:
            continue

        def ext(m, _name=name, _a=a):
            return jax.tree.map(
                lambda f: halo_exchange(f, _name, _a, r), m)

        specs = jax.tree.map(lambda _: m_spec, mat)
        out[f"ax{a}"] = jax.jit(jax.shard_map(
            ext, mesh=mesh, in_specs=(specs,), out_specs=specs,
            check_vma=False))(mat)
    return out


def make_spmd_raw_stage(
    model: Model,
    mesh: Mesh,
    dt: float,
    h: Sequence[float],
    order: int,
):
    """Border-free single-sweep shard_map stage: ``stage(u, mat, axis)``.

    The raw building block for post-fixup compositions (multi-body sharded
    path: raw sweeps here, borders/contacts as GSPMD slab fixups outside).
    """
    dim = model.dim
    r = stencil_radius(order)
    spatial_names = _spatial_names(dim, mesh)

    def raw(u, mat, axis):
        return jnp_stage(model, u, mat, dt, h, axis, order, None)

    def local_stage(u, mats, axis, prepared):
        mat = mats["base"] if prepared else mats
        name = spatial_names.get(axis)
        if name is None:
            return raw(u, mat, axis)
        u_ext = halo_exchange(u, name, axis + 1, r)
        mat_ext = mats[f"ax{axis}"] if prepared else jax.tree.map(
            lambda a: halo_exchange(a, name, axis, r), mat)
        return _crop(raw(u_ext, mat_ext, axis), axis + 1, r)

    u_spec = P(None, *_mat_spec(dim, mesh))
    m_spec = _mat_spec(dim, mesh)

    _cache: Dict[Tuple[int, bool], object] = {}

    def stage(u, mats, axis: int):
        prepared = isinstance(mats, dict) and "base" in mats
        fn = _cache.get((axis, prepared))
        if fn is None:
            fn = jax.jit(jax.shard_map(
                partial(local_stage, axis=axis, prepared=prepared),
                mesh=mesh,
                in_specs=(u_spec, jax.tree.map(lambda _: m_spec, mats)),
                out_specs=u_spec,
                check_vma=False,
            ))
            _cache[(axis, prepared)] = fn
        return fn(u, mats)

    return stage


def make_spmd_step(
    model: Model,
    mesh: Mesh,
    dt: float,
    h: Sequence[float],
    order: int,
    borders: Optional[Borders] = None,
):
    """Build a jitted shard_map full step over ``mesh`` (axes 'sx'[, 'sy']).

    Returns ``step(u, mat) -> u`` operating on globally-shaped (sharded)
    arrays with the framework's standard domain decomposition.
    """
    dim = model.dim
    r = stencil_radius(order)
    spatial_names = _spatial_names(dim, mesh)

    def raw_stage(u, mat, axis):
        return jnp_stage(model, u, mat, dt, h, axis, order, None)

    def local_step(u, mats, axes, prepared):
        mat = mats["base"] if prepared else mats
        for axis in axes:
            name = spatial_names.get(axis)
            u_old = u
            if name is None:
                u_new = raw_stage(u, mat, axis)
            else:
                u_ext = halo_exchange(u, name, axis + 1, r)
                mat_ext = mats[f"ax{axis}"] if prepared else jax.tree.map(
                    lambda a: halo_exchange(a, name, axis, r), mat)
                u_new = _crop(raw_stage(u_ext, mat_ext, axis), axis + 1, r)
            if borders:
                if name is None or lax.axis_size(name) == 1:
                    active = (True, True)
                else:
                    i_sh = lax.axis_index(name)
                    active = (i_sh == 0, i_sh == lax.axis_size(name) - 1)
                u_new = apply_borders_post(
                    model, u_old, u_new, mat, axis, borders, active)
            u = u_new
        return u

    u_spec = P(None, *_mat_spec(dim, mesh))
    m_spec = _mat_spec(dim, mesh)

    _cache: Dict[Tuple, object] = {}

    def step(u, mats, axes: Optional[Tuple[int, ...]] = None):
        axes = tuple(range(dim)) if axes is None else tuple(axes)
        prepared = isinstance(mats, dict) and "base" in mats
        fn = _cache.get((axes, prepared))
        if fn is None:
            fn = jax.jit(jax.shard_map(
                partial(local_step, axes=axes, prepared=prepared),
                mesh=mesh,
                in_specs=(u_spec, jax.tree.map(lambda _: m_spec, mats)),
                out_specs=u_spec,
                check_vma=False,
            ))
            _cache[(axes, prepared)] = fn
        return fn(u, mats)

    return step
