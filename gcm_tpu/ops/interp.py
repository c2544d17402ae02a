"""Semi-Lagrangian interpolation stencils for the grid-characteristic method.

Counterpart of the reference's ``EqualDistanceLineInterpolator``
(SURVEY.md §2 component 8; reference mount empty this round — contract is
SURVEY.md §0.3): on a uniform grid line, the characteristic foot of a wave
with node-local speed ``c`` lies at offset ``delta = -sign(lambda) * nu``
cells from the node, where ``nu = c*dt/h in [0, 1]`` is the local Courant
number. Interpolating the field there is an ``(order+1)``-point Lagrange
stencil whose *offsets are static* and whose *weights are per-node fields*
(functions of ``nu`` only) — which is exactly what makes the GCM stage a
fused, gather-free, whole-array op.

Conventions
-----------
- ``direction d`` is the static sign of the foot offset: the interpolated
  value is the field at position ``i + d*nu`` (in cells). A characteristic
  with speed ``+c`` has its foot at ``i - nu`` (``d = -1``); speed ``-c``
  has ``d = +1``.
- Offsets are expressed relative to ``d``: order 1 uses points ``{0, d}``,
  order 2 uses ``{-d, 0, d}``, order 3 uses ``{-d, 0, d, 2d}`` (biased
  toward the foot interval), order 4 uses ``{-2d, .., 2d}``.
- Out-of-domain neighbors are edge-clamped (``shift`` replicates the edge
  plane). Boundary nodes are subsequently overwritten by the characteristic
  boundary/contact corrections (gcm_tpu.solver.boundary), so clamping only
  affects the *outgoing*-invariant stencil at the boundary, a standard
  one-order local reduction.

The weight formulas are plain arithmetic on whatever array type is passed
(numpy or jax.numpy), so this module is shared by the vectorized solver,
and the NumPy test oracle.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

MAX_ORDER = 4

#: offsets (in units of the direction sign d) per interpolation order
_REL_OFFSETS = {
    1: (0, 1),
    2: (-1, 0, 1),
    3: (-1, 0, 1, 2),
    4: (-2, -1, 0, 1, 2),
}


def stencil_offsets(order: int, direction: int):
    """Static node offsets (in cells) of the stencil, for foot at ``d*nu``."""
    if order not in _REL_OFFSETS:
        raise ValueError(f"unsupported interpolation order {order}")
    if direction not in (-1, 1):
        raise ValueError(f"direction must be ±1, got {direction}")
    return tuple(direction * r for r in _REL_OFFSETS[order])


def stencil_weights(order: int, nu):
    """Lagrange weights at the foot, as functions of the Courant number field.

    ``nu`` is the nonnegative per-node Courant number (array or scalar);
    returns one weight per entry of ``stencil_offsets(order, d)`` — the
    weights are direction-independent because offsets are direction-relative.
    Exact on polynomials of degree <= order; weights sum to 1.
    """
    t = nu
    if order == 1:
        return (1.0 - t, t)
    if order == 2:
        return (0.5 * t * (t - 1.0), 1.0 - t * t, 0.5 * t * (t + 1.0))
    if order == 3:
        return (
            -t * (t - 1.0) * (t - 2.0) / 6.0,
            (t + 1.0) * (t - 1.0) * (t - 2.0) / 2.0,
            -(t + 1.0) * t * (t - 2.0) / 2.0,
            (t + 1.0) * t * (t - 1.0) / 6.0,
        )
    if order == 4:
        return (
            (t + 1.0) * t * (t - 1.0) * (t - 2.0) / 24.0,
            -(t + 2.0) * t * (t - 1.0) * (t - 2.0) / 6.0,
            (t + 2.0) * (t + 1.0) * (t - 1.0) * (t - 2.0) / 4.0,
            -(t + 2.0) * (t + 1.0) * t * (t - 2.0) / 6.0,
            (t + 2.0) * (t + 1.0) * t * (t - 1.0) / 24.0,
        )
    raise ValueError(f"unsupported interpolation order {order}")


def stencil_radius(order: int) -> int:
    """Maximum |offset| of the stencil — the halo depth needed per stage."""
    return max(abs(r) for r in _REL_OFFSETS[order])


def shift(f, j: int, axis: int):
    """Edge-clamped shift: ``out[i] == f[clamp(i + j)]`` along ``axis``.

    Implemented as slice+concat so XLA's SPMD partitioner turns it into a
    neighbor halo exchange (collective-permute) when ``f`` is sharded along
    ``axis`` — the analogue of the reference's MPI halo Sendrecv
    (SURVEY.md §2 component 17).
    """
    if j == 0:
        return f
    n = f.shape[axis]
    if abs(j) >= n:
        raise ValueError(f"shift {j} exceeds extent {n} along axis {axis}")
    if j > 0:
        body = lax.slice_in_dim(f, j, n, axis=axis)
        edge = lax.slice_in_dim(f, n - 1, n, axis=axis)
        parts = [body] + [edge] * j
    else:
        body = lax.slice_in_dim(f, 0, n + j, axis=axis)
        edge = lax.slice_in_dim(f, 0, 1, axis=axis)
        parts = [edge] * (-j) + [body]
    return jnp.concatenate(parts, axis=axis)


def interp_at_foot(f, nu, direction: int, order: int, axis: int):
    """Field value at the characteristic foot ``i + direction*nu`` (cells).

    ``f``: field array; ``nu``: per-node Courant field (broadcastable to f);
    ``direction``: static ±1; returns an array like ``f``.
    """
    offs = stencil_offsets(order, direction)
    wts = stencil_weights(order, nu)
    out = None
    for o, w in zip(offs, wts):
        term = w * shift(f, o, axis)
        out = term if out is None else out + term
    return out


def edge_pad(f, axis: int, r: int):
    """Edge-replicate pad of width ``r`` along ``axis`` (both sides).

    Padding once and slicing per stencil offset (interp_padded) lets XLA
    fuse the shifted reads into the consuming elementwise ops — one
    materialization per field per sweep instead of one per shift.
    """
    widths = [(0, 0)] * f.ndim
    widths[axis] = (r, r)
    return jnp.pad(f, widths, mode="edge")


def shifted_slice(fp, j: int, axis: int, r: int, n: int):
    """View of the padded array equal to ``shift(f, j, axis)`` (|j| <= r)."""
    return lax.slice_in_dim(fp, r + j, r + j + n, axis=axis)


def interp_padded(fp, wts, direction: int, order: int, axis: int, r: int, n: int):
    """interp_at_foot on a pre-padded field with precomputed weights."""
    offs = stencil_offsets(order, direction)
    out = None
    for o, w in zip(offs, wts):
        term = w * shifted_slice(fp, o, axis, r, n)
        out = term if out is None else out + term
    return out
