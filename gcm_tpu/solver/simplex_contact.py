"""Contact between simplex-mesh bodies: paired-node characteristic solves.

The reference handles contact between arbitrary meshes through pairs of
border nodes (SURVEY.md §2 component 11); round-1 covered structured-
structured interfaces only.  Here two simplex bodies meet along a
grid-conforming contact plane normal to ``axis`` (collocated interface
nodes, body_a on the low side / body_b on the high side); the pairing is
precomputed host-side by coordinate matching, and the interface solve runs
as a **post-sweep fixup on the paired nodes** — static-index gathers and
scatters, the static-index form of the reference's per-node-pair loop:

- during body_a's sweep along ``axis`` the invariant entering from the
  high side is unknown (its characteristic foot leaves the hull — the
  border condition fills it, and this fixup overwrites it);
- the fixup reconstructs both bodies' invariants at the paired nodes from
  the raw-swept state (the reconstruction is invertible), applies the
  same two-impedance solve as structured contact
  (gcm_tpu.solver.contact._pair_incoming — bonded / slip / Coulomb
  friction / fracture), and re-propagates the zero-speed invariants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from gcm_tpu.grids.simplex import SimplexGrid
from gcm_tpu.solver.contact import (
    CONTACT_KINDS, _fracture, _pair_incoming, _require_normal_pair,
    _split_normal,
)


@dataclasses.dataclass(frozen=True)
class SimplexContactSpec:
    """Contact between two simplex bodies along ``axis``.

    body_a is on the LOW side of the contact plane (its paired nodes see
    the +axis characteristic leave the hull), body_b on the high side.
    Same kinds/criteria as the structured ContactSpec.
    """

    body_a: str
    body_b: str
    axis: int
    kind: str = "bonded"
    tensile_strength: Optional[float] = None
    broken_kind: str = "free"
    friction_mu: float = 0.0

    def __post_init__(self):
        if self.kind not in CONTACT_KINDS:
            raise ValueError(f"unknown contact kind {self.kind!r}")
        if self.broken_kind not in ("free", "slip", "friction"):
            raise ValueError(f"unknown broken kind {self.broken_kind!r}")


def pair_contact_nodes(
    grid_a: SimplexGrid,
    grid_b: SimplexGrid,
    tol: float = 1e-9,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pair collocated hull nodes of two bodies (idx_a, idx_b) by
    coordinate matching — the conforming-interface discovery step.

    Matches are required to be MUTUAL nearest neighbors (advisor r2):
    one-directional matching could pair two a-nodes to the same b-node,
    and duplicated scatter indices in apply_simplex_contact_post would
    make one update win arbitrarily. Mutual matching makes the pairing a
    partial bijection; a uniqueness assert guards the invariant.
    """
    from scipy.spatial import cKDTree

    ha = np.flatnonzero(grid_a.hull_mask())
    hb = np.flatnonzero(grid_b.hull_mask())
    tree_b = cKDTree(grid_b.points[hb])
    d_ab, j = tree_b.query(grid_a.points[ha], k=1)
    tree_a = cKDTree(grid_a.points[ha])
    _, i_back = tree_a.query(grid_b.points[hb[j]], k=1)
    keep = (d_ab <= tol) & (i_back == np.arange(len(ha)))
    idx_a = ha[keep].astype(np.int32)
    idx_b = hb[j[keep]].astype(np.int32)
    if len(idx_a) == 0:
        raise ValueError("no collocated interface nodes found")
    assert np.unique(idx_b).size == idx_b.size, "non-bijective contact pairing"
    return idx_a, idx_b


def apply_simplex_contact_post(
    spec: SimplexContactSpec,
    model,
    u_old_a: jnp.ndarray,
    u_a: jnp.ndarray,
    u_old_b: jnp.ndarray,
    u_b: jnp.ndarray,
    view_a,
    view_b,
    idx_a: jnp.ndarray,
    idx_b: jnp.ndarray,
    bonded: Optional[jnp.ndarray],
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]:
    """One contact's interface solve on the paired nodes, post-sweep.

    ``u_*`` are [ncomp, N] raw-swept states of the ``spec.axis`` sweep;
    ``view_*`` the bodies' AxisViews of that sweep. Returns the fixed
    states and the updated bond mask.
    """
    ax = spec.axis
    st = model.stage(ax)
    # physical-axis normal identification via the shared helper (see
    # contact._split_normal / apply_contact_post — code-review r5)
    nax = st.axis
    _require_normal_pair(spec, st.pairs, nax)
    sign = model.sign

    pairs_d = {k: (None, None, p) for k, p in enumerate(st.pairs)}
    order_ks = _split_normal(pairs_d, nax)

    glue = (bonded > 0.5) if bonded is not None else None
    s_star_n = None
    sigma_c = None
    sigma_fixed_a: Dict[int, jnp.ndarray] = {}
    sigma_fixed_b: Dict[int, jnp.ndarray] = {}

    for k in order_ks:
        p = st.pairs[k]
        is_normal = p.traction_axis == nax
        z_a = view_a.pair_z[k][idx_a]
        z_b = view_b.pair_z[k][idx_b]
        A_a, B_a = u_a[p.sigma][idx_a], u_a[p.vel][idx_a]
        A_b, B_b = u_b[p.sigma][idx_b], u_b[p.vel][idx_b]
        # body_a is on the low side: its outgoing invariant at the plane is
        # w_R (foot inside A); body_b's is w_L
        out_a = A_a - sign * z_a * B_a
        out_b = A_b + sign * z_b * B_b
        in_a, in_b, s_star = _pair_incoming(
            spec, is_normal, out_a, out_b, z_a, z_b, glue, sigma_c)
        if is_normal:
            s_star_n = s_star
            sigma_c = jnp.maximum(-s_star, 0.0)
        A_a2 = 0.5 * (in_a + out_a)
        B_a2 = jnp.where(z_a > 0,
                         sign * (in_a - out_a)
                         / (2.0 * jnp.maximum(z_a, 1e-30)), B_a)
        A_b2 = 0.5 * (out_b + in_b)
        B_b2 = jnp.where(z_b > 0,
                         sign * (out_b - in_b)
                         / (2.0 * jnp.maximum(z_b, 1e-30)), B_b)
        u_a = u_a.at[p.sigma, idx_a].set(A_a2)
        u_a = u_a.at[p.vel, idx_a].set(B_a2)
        u_b = u_b.at[p.sigma, idx_b].set(A_b2)
        u_b = u_b.at[p.vel, idx_b].set(B_b2)
        sigma_fixed_a[p.sigma] = A_a2
        sigma_fixed_b[p.sigma] = A_b2

    for j, zc in enumerate(st.zeros):
        if zc.src in sigma_fixed_a:
            kap_a = view_a.zero_kappa[j][idx_a]
            z_new = u_old_a[zc.comp][idx_a] + kap_a * (
                sigma_fixed_a[zc.src] - u_old_a[zc.src][idx_a])
            u_a = u_a.at[zc.comp, idx_a].set(z_new)
            kap_b = view_b.zero_kappa[j][idx_b]
            z_new = u_old_b[zc.comp][idx_b] + kap_b * (
                sigma_fixed_b[zc.src] - u_old_b[zc.src][idx_b])
            u_b = u_b.at[zc.comp, idx_b].set(z_new)

    return u_a, u_b, _fracture(spec, bonded, s_star_n)


# ------------------------------------------------ non-conforming interfaces

@dataclasses.dataclass(frozen=True)
class SimplexInterfaceMaps:
    """Static interpolation tables for a non-conforming simplex contact.

    ``idx_*``: each side's interface node indices (global node numbering).
    ``nbr_a``/``w_a``: for each a-interface node, K neighbor positions into
    ``idx_b``-LOCAL numbering + convex weights interpolating b-side values
    at a's node (and vice versa). K = dim on the interface manifold + 1
    (2 on a line, 3 on a surface).
    """

    idx_a: np.ndarray
    idx_b: np.ndarray
    nbr_a: np.ndarray
    w_a: np.ndarray
    nbr_b: np.ndarray
    w_b: np.ndarray


def _interface_interp(targets: np.ndarray, sources: np.ndarray):
    """Linear interpolation tables on the (dim-1)-d interface manifold.

    ``targets``/``sources`` are transverse coordinates ([n, dim-1]).
    1D interfaces use bracketing linear weights (clamped at the ends);
    2D interfaces use Delaunay barycentric weights with nearest-node
    fallback outside the source hull. Exact on affine data inside the hull.
    """
    nt = len(targets)
    if targets.shape[1] == 1:
        order = np.argsort(sources[:, 0])
        s = sources[order, 0]
        t = targets[:, 0]
        j = np.clip(np.searchsorted(s, t) - 1, 0, max(len(s) - 2, 0))
        denom = np.maximum(s[j + 1] - s[j], 1e-300)
        frac = np.clip((t - s[j]) / denom, 0.0, 1.0)
        nbr = np.stack([order[j], order[np.minimum(j + 1, len(s) - 1)]], 1)
        w = np.stack([1.0 - frac, frac], 1)
        return nbr.astype(np.int32), w
    from scipy.spatial import Delaunay, cKDTree

    tri = Delaunay(sources)
    simplex = tri.find_simplex(targets)
    K = sources.shape[1] + 1
    nbr = np.zeros((nt, K), dtype=np.int64)
    w = np.zeros((nt, K))
    inside = simplex >= 0
    if inside.any():
        sx = simplex[inside]
        T = tri.transform[sx]
        bary = np.einsum("nij,nj->ni", T[:, :-1],
                         targets[inside] - T[:, -1])
        w_in = np.concatenate(
            [bary, 1.0 - bary.sum(axis=1, keepdims=True)], axis=1)
        nbr[inside] = tri.simplices[sx]
        w[inside] = w_in
    if (~inside).any():
        _, nearest = cKDTree(sources).query(targets[~inside], k=1)
        nbr[~inside, 0] = nearest
        w[~inside, 0] = 1.0
    return nbr.astype(np.int32), w


def pair_contact_maps(
    grid_a: SimplexGrid,
    grid_b: SimplexGrid,
    axis: int,
    plane_tol: Optional[float] = None,
) -> SimplexInterfaceMaps:
    """Interface maps for two INDEPENDENTLY meshed bodies meeting on the
    plane normal to ``axis`` (body_a below, body_b above).

    The reference pairs arbitrary border nodes of independently meshed
    bodies (SURVEY.md §2 component 11); collocation is not assumed. Each
    side contributes its hull nodes lying on the contact plane; static
    linear tables interpolate the other side's interface values at them
    (same per-side algebra as solver.contact_nc on structured grids).
    """
    xa = grid_a.points[:, axis]
    xb = grid_b.points[:, axis]
    x_c_a = xa.max()
    x_c_b = xb.min()
    if plane_tol is None:
        ext = max(xa.max() - xa.min(), xb.max() - xb.min())
        plane_tol = 1e-6 * max(ext, 1.0)
    if abs(x_c_a - x_c_b) > plane_tol:
        raise ValueError(
            f"contact planes disagree: a ends at {x_c_a}, b starts at "
            f"{x_c_b}")
    ha = np.flatnonzero(grid_a.hull_mask() & (np.abs(xa - x_c_a) <= plane_tol))
    hb = np.flatnonzero(grid_b.hull_mask() & (np.abs(xb - x_c_b) <= plane_tol))
    if len(ha) < 2 or len(hb) < 2:
        raise ValueError("fewer than 2 interface nodes on a side")
    t_axes = [d for d in range(grid_a.points.shape[1]) if d != axis]
    ta = grid_a.points[np.ix_(ha, t_axes)]
    tb = grid_b.points[np.ix_(hb, t_axes)]
    nbr_a, w_a = _interface_interp(ta, tb)
    nbr_b, w_b = _interface_interp(tb, ta)
    return SimplexInterfaceMaps(
        idx_a=ha.astype(np.int32), idx_b=hb.astype(np.int32),
        nbr_a=nbr_a, w_a=w_a, nbr_b=nbr_b, w_b=w_b)


def interface_is_conforming(maps: SimplexInterfaceMaps,
                            grid_a: SimplexGrid,
                            grid_b: SimplexGrid,
                            tol: float = 1e-9) -> bool:
    """True iff the two interface node sets are collocated (equal counts,
    each a-node within ``tol`` of a b-node). Corner nodes shared between
    otherwise-mismatched meshes make naive collocated pairing succeed
    spuriously — completeness over the whole interface is the real test."""
    if len(maps.idx_a) != len(maps.idx_b):
        return False
    from scipy.spatial import cKDTree

    d, _ = cKDTree(grid_b.points[maps.idx_b]).query(
        grid_a.points[maps.idx_a], k=1)
    return bool(d.max() <= tol)


def init_simplex_bonded_nc(maps: SimplexInterfaceMaps, dtype=jnp.float32):
    """Per-side bond masks over the interface node sets."""
    return {"a": jnp.ones((len(maps.idx_a),), dtype=dtype),
            "b": jnp.ones((len(maps.idx_b),), dtype=dtype)}


def apply_simplex_contact_nc_post(
    spec: SimplexContactSpec,
    model,
    maps: SimplexInterfaceMaps,
    u_old_a: jnp.ndarray,
    u_a: jnp.ndarray,
    u_old_b: jnp.ndarray,
    u_b: jnp.ndarray,
    view_a,
    view_b,
    bonded: Optional[Dict],
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[Dict]]:
    """Non-conforming interface solve, pointwise per side through the
    static tables (the unstructured mirror of
    solver.contact_nc.apply_contact_nc_post)."""
    ax = spec.axis
    st = model.stage(ax)
    nax = st.axis      # physical-axis normal identification (review r5)
    _require_normal_pair(spec, st.pairs, nax)
    sign = model.sign
    idx_a = jnp.asarray(maps.idx_a)
    idx_b = jnp.asarray(maps.idx_b)
    nbr_a = jnp.asarray(maps.nbr_a)
    nbr_b = jnp.asarray(maps.nbr_b)
    w_a = None
    w_b = None

    glue_a = (bonded["a"] > 0.5) if bonded is not None else None
    glue_b = (bonded["b"] > 0.5) if bonded is not None else None

    pairs_d = {k: (None, None, p) for k, p in enumerate(st.pairs)}
    order_ks = _split_normal(pairs_d, nax)

    s_n = {"a": None, "b": None}
    sigma_c = {"a": None, "b": None}
    sigma_fixed_a: Dict[int, jnp.ndarray] = {}
    sigma_fixed_b: Dict[int, jnp.ndarray] = {}

    for k in order_ks:
        p = st.pairs[k]
        is_normal = p.traction_axis == nax
        z_a = view_a.pair_z[k][idx_a]
        z_b = view_b.pair_z[k][idx_b]
        out_a = u_a[p.sigma][idx_a] - sign * z_a * u_a[p.vel][idx_a]
        out_b = u_b[p.sigma][idx_b] + sign * z_b * u_b[p.vel][idx_b]
        if w_a is None:
            w_a = jnp.asarray(maps.w_a, dtype=out_a.dtype)
            w_b = jnp.asarray(maps.w_b, dtype=out_a.dtype)

        def interp(vals, nbr, w):
            return (vals[nbr] * w).sum(axis=1)

        # a-side solve: own outgoing + interpolated b outgoing/impedance
        in_a, _, s_a = _pair_incoming(
            spec, is_normal, out_a, interp(out_b, nbr_a, w_a),
            z_a, interp(z_b, nbr_a, w_a), glue_a, sigma_c["a"])
        # b-side solve
        _, in_b, s_b = _pair_incoming(
            spec, is_normal, interp(out_a, nbr_b, w_b), out_b,
            interp(z_a, nbr_b, w_b), z_b, glue_b, sigma_c["b"])
        if is_normal:
            s_n = {"a": s_a, "b": s_b}
            sigma_c = {"a": jnp.maximum(-s_a, 0.0),
                       "b": jnp.maximum(-s_b, 0.0)}
        A_a2 = 0.5 * (in_a + out_a)
        B_a2 = jnp.where(z_a > 0,
                         sign * (in_a - out_a)
                         / (2.0 * jnp.maximum(z_a, 1e-30)),
                         u_a[p.vel][idx_a])
        A_b2 = 0.5 * (out_b + in_b)
        B_b2 = jnp.where(z_b > 0,
                         sign * (out_b - in_b)
                         / (2.0 * jnp.maximum(z_b, 1e-30)),
                         u_b[p.vel][idx_b])
        u_a = u_a.at[p.sigma, idx_a].set(A_a2)
        u_a = u_a.at[p.vel, idx_a].set(B_a2)
        u_b = u_b.at[p.sigma, idx_b].set(A_b2)
        u_b = u_b.at[p.vel, idx_b].set(B_b2)
        sigma_fixed_a[p.sigma] = A_a2
        sigma_fixed_b[p.sigma] = A_b2

    for j, zc in enumerate(st.zeros):
        if zc.src in sigma_fixed_a:
            kap_a = view_a.zero_kappa[j][idx_a]
            z_new = u_old_a[zc.comp][idx_a] + kap_a * (
                sigma_fixed_a[zc.src] - u_old_a[zc.src][idx_a])
            u_a = u_a.at[zc.comp, idx_a].set(z_new)
            kap_b = view_b.zero_kappa[j][idx_b]
            z_new = u_old_b[zc.comp][idx_b] + kap_b * (
                sigma_fixed_b[zc.src] - u_old_b[zc.src][idx_b])
            u_b = u_b.at[zc.comp, idx_b].set(z_new)

    new_bonded = bonded
    if bonded is not None and spec.tensile_strength is not None:
        keep_a = (s_n["a"] <= spec.tensile_strength).astype(
            bonded["a"].dtype)
        keep_b = (s_n["b"] <= spec.tensile_strength).astype(
            bonded["b"].dtype)
        new_bonded = {"a": bonded["a"] * keep_a, "b": bonded["b"] * keep_b}
    return u_a, u_b, new_bonded
