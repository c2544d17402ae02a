"""Non-conforming contact: interface interpolation maps between face grids.

Counterpart of the reference's contact between *independently
meshed* bodies (SURVEY.md §2 component 11: "two-mesh contact ... pairs of
border nodes" — the reference pairs arbitrary border nodes across bodies,
it does not require collocated interface nodes). Round-2 verdict missing #4
/ next-round item 5: bodies with spacing h and 2h (or offset node lattices)
must couple.

Design — everything static, built once at setup (the discipline that
runs through the whole framework: no data-dependent addressing inside jit):

- The interface region is the geometric overlap of body_a's high face and
  body_b's low face on the contact axis, computed from the two ``GridSpec``
  geometries. Each side contributes the contiguous index range of its face
  nodes that fall inside the overlap (``lo``/``span`` per side — the spans
  now differ between sides).
- For each side, a **static linear interpolation table** per transverse
  axis maps the *other* side's full-face arrays onto this side's overlap
  nodes: index pairs + convex weights (``jnp.take`` + 2-term blend per
  axis, separable tensor-product in 3D). Tables are numpy at build time,
  constants inside the jitted step.
- The two-impedance contact algebra (solver.contact._pair_incoming — the
  same bonded/slip/Coulomb-friction/fracture logic) is then solved
  **pointwise per side**: at a's overlap nodes with a's native outgoing
  invariant and b's interpolated outgoing invariant/impedance, and
  symmetrically at b's. Conforming interfaces make both solves identical
  to the collocated path (the tables degenerate to identity), which is the
  parity anchor tested in tests/test_contact_nonconforming.py.
- Fracture state is **per side**: each side's overlap nodes carry their own
  bond mask, broken permanently by their own interface solve's normal
  traction. (With collocated nodes the two masks evolve identically.)

The solve is applied as a post-sweep fixup on raw (border/contact-free)
sweeps — the same invertible-reconstruction composition as
solver.contact.apply_contact_post — so it rides every multi-body path
(in-stage, sharded post-fixup) unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from gcm_tpu.solver.contact import (
    ContactSpec, _pair_incoming, _require_normal_pair, _split_normal,
    face_sub_index,
)


# ---------------------------------------------------------------- geometry

@dataclasses.dataclass(frozen=True)
class AxisMap:
    """1D linear interpolation from another face's node line.

    ``value_at_targets = src[idx[:,0]] * w[:,0] + src[idx[:,1]] * w[:,1]``
    """

    idx: np.ndarray   # [n_target, 2] int32, indices into the source line
    w: np.ndarray     # [n_target, 2] float64, convex weights


@dataclasses.dataclass(frozen=True)
class SideMaps:
    """One side's overlap sub-face + tables interpolating the other side."""

    lo: Tuple[int, ...]            # overlap start index per transverse axis
    span: Tuple[int, ...]          # overlap node count per transverse axis
    from_other: Tuple[AxisMap, ...]  # per transverse axis, other's full face


@dataclasses.dataclass(frozen=True)
class InterfaceMaps:
    """Static interface maps for one non-conforming contact."""

    a: SideMaps
    b: SideMaps


def _axis_map(targets: np.ndarray, src: np.ndarray) -> AxisMap:
    """Linear-interpolation table evaluating at ``targets`` from the source
    node line ``src`` (uniformly spaced, ascending). Targets outside the
    source range clamp to the end nodes (they are eps-close by
    construction — the overlap is the intersection of both ranges)."""
    hs = float(src[1] - src[0]) if len(src) > 1 else 1.0
    t = (targets - src[0]) / hs
    j0 = np.clip(np.floor(t).astype(np.int64), 0, max(len(src) - 2, 0))
    frac = np.clip(t - j0, 0.0, 1.0)
    idx = np.stack([j0, np.minimum(j0 + 1, len(src) - 1)], axis=-1)
    w = np.stack([1.0 - frac, frac], axis=-1)
    return AxisMap(idx.astype(np.int32), w)


def build_interface_maps(grid_a, grid_b, axis: int,
                         tol: float = 1e-9) -> InterfaceMaps:
    """Maps for a contact between grid_a's high face and grid_b's low face.

    ``grid_*`` are GridSpec-likes (shape/h/origin/coords()). The overlap
    must contain at least 2 nodes of each side per transverse axis.
    """
    dim = grid_a.dim
    if grid_b.dim != dim:
        raise ValueError("contacting bodies must share dimensionality")
    ca = grid_a.coords()
    cb = grid_b.coords()
    t_axes = [d for d in range(dim) if d != axis]

    lo_a, span_a, lo_b, span_b = [], [], [], []
    maps_a, maps_b = [], []
    for d in t_axes:
        eps = tol * max(grid_a.h[d], grid_b.h[d])
        olo = max(ca[d][0], cb[d][0]) - eps
        ohi = min(ca[d][-1], cb[d][-1]) + eps
        sel_a = np.nonzero((ca[d] >= olo) & (ca[d] <= ohi))[0]
        sel_b = np.nonzero((cb[d] >= olo) & (cb[d] <= ohi))[0]
        if len(sel_a) < 2 or len(sel_b) < 2:
            raise ValueError(
                f"contact faces overlap in fewer than 2 nodes on axis {d}")
        lo_a.append(int(sel_a[0]))
        span_a.append(len(sel_a))
        lo_b.append(int(sel_b[0]))
        span_b.append(len(sel_b))
        maps_a.append(_axis_map(ca[d][sel_a], cb[d]))
        maps_b.append(_axis_map(cb[d][sel_b], ca[d]))

    return InterfaceMaps(
        a=SideMaps(tuple(lo_a), tuple(span_a), tuple(maps_a)),
        b=SideMaps(tuple(lo_b), tuple(span_b), tuple(maps_b)),
    )


def faces_conform(grid_a, grid_b, axis: int, tol: float = 1e-9) -> bool:
    """True iff the two faces have collocated nodes (the fast shared-solve
    path of solver.contact applies with no lo/span)."""
    dim = grid_a.dim
    for d in range(dim):
        if d == axis:
            continue
        if grid_a.shape[d] != grid_b.shape[d]:
            return False
        eps = tol * max(grid_a.h[d], grid_b.h[d])
        if abs(grid_a.h[d] - grid_b.h[d]) > eps:
            return False
        if abs(grid_a.origin[d] - grid_b.origin[d]) > eps:
            return False
    return True


# ------------------------------------------------------------- interpolation

def interp_face(vals: jnp.ndarray, maps: Sequence[AxisMap]) -> jnp.ndarray:
    """Interpolate a full-face array onto the target nodes, axis by axis.

    ``vals`` has one array axis per transverse axis (in increasing global
    axis order — the layout face_sub_index produces)."""
    out = vals
    for d, m in enumerate(maps):
        lo = jnp.take(out, jnp.asarray(m.idx[:, 0]), axis=d)
        hi = jnp.take(out, jnp.asarray(m.idx[:, 1]), axis=d)
        sh = [1] * out.ndim
        sh[d] = len(m.idx)
        w0 = jnp.asarray(m.w[:, 0], dtype=vals.dtype).reshape(sh)
        w1 = jnp.asarray(m.w[:, 1], dtype=vals.dtype).reshape(sh)
        out = lo * w0 + hi * w1
    return out


# ------------------------------------------------------------------ the solve

def init_bonded_nc(maps: InterfaceMaps, dtype=jnp.float32) -> Dict:
    """Fresh per-side bond masks over the overlap sub-faces."""
    return {"a": jnp.ones(maps.a.span, dtype=dtype),
            "b": jnp.ones(maps.b.span, dtype=dtype)}


def _solve_side(spec: ContactSpec, model, u_old, u_new, view, axis_side,
                sub_idx, out_other_full, z_other_full, maps_side,
                glue):
    """Interface solve at ONE side's overlap nodes.

    ``axis_side``: +1 for body_a's high face (outgoing = w_R), -1 for
    body_b's low face (outgoing = w_L). ``out_other_full``/``z_other_full``:
    per-pair dicts of the other side's full-face outgoing invariant and
    impedance, interpolated here through ``maps_side.from_other``.
    Returns the fixed-up state and the normal-traction slab (for fracture).
    """
    ax = spec.axis
    st = model.stage(ax)
    # physical-axis normal identification (see contact.apply_contact_post)
    nax = st.axis
    sign = model.sign
    s_star_n = None
    sigma_c = None
    sigma_fixed: Dict[int, jnp.ndarray] = {}
    pairs = {k: (None, None, p) for k, p in enumerate(st.pairs)}

    for k in _split_normal(pairs, nax):
        p = st.pairs[k]
        is_normal = p.traction_axis == nax
        z_own = view.pair_z[k][sub_idx]
        A = u_new[p.sigma][sub_idx]
        B = u_new[p.vel][sub_idx]
        z_oth = interp_face(z_other_full[k], maps_side.from_other)
        out_oth = interp_face(out_other_full[k], maps_side.from_other)
        if axis_side > 0:   # body_a's high face: own outgoing is w_R
            out_own = A - sign * z_own * B
            in_own, _, s_star = _pair_incoming(
                spec, is_normal, out_own, out_oth, z_own, z_oth,
                glue, sigma_c)
            A2 = 0.5 * (in_own + out_own)
            B2 = jnp.where(z_own > 0,
                           sign * (in_own - out_own)
                           / (2.0 * jnp.maximum(z_own, 1e-30)), B)
        else:               # body_b's low face: own outgoing is w_L
            out_own = A + sign * z_own * B
            _, in_own, s_star = _pair_incoming(
                spec, is_normal, out_oth, out_own, z_oth, z_own,
                glue, sigma_c)
            A2 = 0.5 * (out_own + in_own)
            B2 = jnp.where(z_own > 0,
                           sign * (out_own - in_own)
                           / (2.0 * jnp.maximum(z_own, 1e-30)), B)
        if is_normal:
            s_star_n = s_star
            sigma_c = jnp.maximum(-s_star, 0.0)
        u_new = u_new.at[(p.sigma,) + sub_idx].set(A2)
        u_new = u_new.at[(p.vel,) + sub_idx].set(B2)
        sigma_fixed[p.sigma] = A2

    # re-propagate the zero-speed invariants at the fixed sub-face
    for j, zc in enumerate(st.zeros):
        if zc.src in sigma_fixed:
            kap = view.zero_kappa[j][sub_idx]
            z_new = u_old[zc.comp][sub_idx] + kap * (
                sigma_fixed[zc.src] - u_old[zc.src][sub_idx])
            u_new = u_new.at[(zc.comp,) + sub_idx].set(z_new)
    return u_new, s_star_n


def apply_contact_nc_post(
    spec: ContactSpec,
    model,
    maps: InterfaceMaps,
    u_old_a: jnp.ndarray,
    u_a: jnp.ndarray,
    u_old_b: jnp.ndarray,
    u_b: jnp.ndarray,
    view_a,
    view_b,
    bonded: Optional[Dict],
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[Dict]]:
    """Non-conforming contact solve as a post-fixup on raw sweeps.

    Mirrors solver.contact.apply_contact_post, but solves the interface
    algebra pointwise per side through the static interpolation tables.
    ``bonded`` is the per-side mask dict from :func:`init_bonded_nc` (or
    None when fracture is off).
    """
    ax = spec.axis
    dim = model.dim
    st = model.stage(ax)
    _require_normal_pair(spec, st.pairs, st.axis)
    sign = model.sign

    sub_a = face_sub_index(ax, 1, dim, maps.a.lo, maps.a.span)
    sub_b = face_sub_index(ax, 0, dim, maps.b.lo, maps.b.span)
    full_a = face_sub_index(ax, 1, dim, None, None)
    full_b = face_sub_index(ax, 0, dim, None, None)

    # full-face outgoing invariants + impedances of each side (sources for
    # the other side's interpolation)
    out_a_full: Dict[int, jnp.ndarray] = {}
    out_b_full: Dict[int, jnp.ndarray] = {}
    z_a_full: Dict[int, jnp.ndarray] = {}
    z_b_full: Dict[int, jnp.ndarray] = {}
    for k, p in enumerate(st.pairs):
        z_a = view_a.pair_z[k][full_a]
        z_b = view_b.pair_z[k][full_b]
        out_a_full[k] = u_a[p.sigma][full_a] - sign * z_a * u_a[p.vel][full_a]
        out_b_full[k] = u_b[p.sigma][full_b] + sign * z_b * u_b[p.vel][full_b]
        z_a_full[k] = z_a
        z_b_full[k] = z_b

    glue_a = (bonded["a"] > 0.5) if bonded is not None else None
    glue_b = (bonded["b"] > 0.5) if bonded is not None else None

    u_a, s_n_a = _solve_side(
        spec, model, u_old_a, u_a, view_a, +1, sub_a,
        out_b_full, z_b_full, maps.a, glue_a)
    u_b, s_n_b = _solve_side(
        spec, model, u_old_b, u_b, view_b, -1, sub_b,
        out_a_full, z_a_full, maps.b, glue_b)

    new_bonded = bonded
    if bonded is not None and spec.tensile_strength is not None:
        keep_a = (s_n_a <= spec.tensile_strength).astype(bonded["a"].dtype)
        keep_b = (s_n_b <= spec.tensile_strength).astype(bonded["b"].dtype)
        new_bonded = {"a": bonded["a"] * keep_a, "b": bonded["b"] * keep_b}
    return u_a, u_b, new_bonded
