"""The grid-characteristic time step: stages + borders + zero invariants.

Counterpart of the reference's ``DefaultSolver::nextTimeStep`` /
``stage(axis, dt)`` (SURVEY.md §2 components 7+10, §3.1): one time step is a
sequence of 1D characteristic sweeps (dimensional splitting), with the axis
order reversed on alternate steps for second-order splitting accuracy
(SURVEY.md §0.3). Everything is expressed in *global* array terms; under a
sharded ``jax.Array`` the XLA SPMD partitioner turns the stencil shifts into
halo exchanges and the boundary-slab writes into edge-shard updates, which
is this framework's equivalent of the reference's MPI halo logic.

All functions are pure; ``model``/``order``/``borders`` are static Python
structure, traced once under jit.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax.numpy as jnp

from gcm_tpu.materials import MaterialFields
from gcm_tpu.models.spec import Model
from gcm_tpu.ops.stage import (
    apply_zero_invariants,
    reconstruct_pair,
    stage_pair_updates,
)
from gcm_tpu.solver.boundary import correct_pair_at_face
from gcm_tpu.task import BorderSpec

Borders = Dict[Tuple[int, int], BorderSpec]


def cfl_dt(mat: MaterialFields, h: Sequence[float], cfl: float) -> float:
    """Static global time step: dt = cfl * min_a(h_a) / max(c_p).

    Materials are time-invariant, so dt is computed once host-side — no
    per-step device→host sync (SURVEY.md §7 "dt inside jit"). The reference
    recomputes this each step with an MPI allreduce; here it is a constant.
    """
    return float(cfl * min(h) / mat.max_cp())


def stage(
    model: Model,
    u: jnp.ndarray,
    mat: MaterialFields,
    dt: float,
    h: Sequence[float],
    axis: int,
    order: int,
    borders: Optional[Borders] = None,
    dim_axis: Optional[int] = None,
) -> jnp.ndarray:
    """One characteristic sweep along ``axis`` over the whole field array.

    ``dim_axis`` separates the spatial array dimension from the physical
    axis for permuted layouts (physics — stage spec, impedances, h,
    border lookup — always follows ``axis``; slicing/shifting follows
    ``dim_axis``)."""
    ax = dim_axis if dim_axis is not None else axis
    st = model.stage(axis)
    view = mat.axis_view(axis, st)
    pair_ws = stage_pair_updates(model, u, view, dt / h[axis], axis, order,
                                 dim_axis=ax)

    comps: Dict[int, jnp.ndarray] = {}
    for k, (w_l, w_r, p) in pair_ws.items():
        z = view.pair_z[k]
        if borders is not None:
            for side in (0, 1):
                bc = borders.get((axis, side))
                if bc is not None:
                    val = bc.pair_value(p.traction_axis, st.axis)
                    w_l, w_r = correct_pair_at_face(
                        w_l, w_r, z, model.sign, bc, ax, side, val
                    )
        A_new, B_new = reconstruct_pair(w_l, w_r, z, u[p.vel], model.sign)
        comps[p.sigma] = A_new
        comps[p.vel] = B_new

    apply_zero_invariants(model, u, comps, view, axis)
    return jnp.stack([comps.get(i, u[i]) for i in range(model.ncomp)])


def step(
    model: Model,
    u: jnp.ndarray,
    mat: MaterialFields,
    dt: float,
    h: Sequence[float],
    order: int,
    borders: Optional[Borders] = None,
    axes: Optional[Sequence[int]] = None,
) -> jnp.ndarray:
    """One full time step: sweep every axis in the given (static) order."""
    if axes is None:
        axes = range(model.dim)
    for a in axes:
        u = stage(model, u, mat, dt, h, a, order, borders)
    return u


def axes_order(dim: int, step_index: int, symmetrize: bool) -> Tuple[int, ...]:
    """Splitting axis order for a given step (reversed on odd steps)."""
    fwd = tuple(range(dim))
    if symmetrize and (step_index % 2 == 1):
        return fwd[::-1]
    return fwd
