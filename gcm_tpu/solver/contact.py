"""Contact and fracture between bodies: paired characteristic face solves.

Counterpart of the reference's ``ContactCondition`` + fracture
(SURVEY.md §2 component 11; BASELINE.json config 4 "free-surface +
contact/fracture"). Two bodies meet along a grid-conforming interface
(body_a's high face ↔ body_b's low face on the contact axis, collocated
interface nodes). The interface may cover the **whole face** of both bodies
(the round-1 scope) or an **offset sub-rectangle** of each face
(``lo_a``/``lo_b``/``span``): face nodes outside the overlap keep the
body's own border condition — e.g. the exposed ledge of a step is a free
surface.

During the sweep along the contact axis, the incoming invariant of each
body's face is set from the *two-impedance interface solve* instead of a
border condition.  With elastic pairs (sign s = +1), known outgoing
invariants at the face
    a = w_R of body_a (= sigma* − z_a v*),   b = w_L of body_b (= sigma* + z_b v*)
adhesion (continuity of traction & velocity) gives
    v*     = (b − a) / (z_a + z_b)
    sigma* = (z_b a + z_a b) / (z_a + z_b)
and the incoming invariants  w_L(a-side) = sigma* + z_a v*,
                             w_R(b-side) = sigma* − z_b v*.

Kinds:
- ``bonded``:   adhesion on all pairs (P and S);
- ``slip``:     adhesion on the normal (P) pair, tangential tractions zero
                (free) on both sides;
- ``friction``: Coulomb contact — the normal pair is **unilateral**
                (adhesion while in compression, traction-free when the
                interface opens), each tangential pair *sticks* (adhesion)
                while the stick traction satisfies |tau*| <= mu·max(−sigma_n*, 0)
                and *slides* at the capped traction
                tau_c = sign(tau*)·mu·max(−sigma_n*, 0) otherwise.  The cap
                is applied per tangential component — the axis-split
                approximation consistent with dimensional splitting.
- fracture:     a per-interface-node ``bonded`` state array flips to broken
                (slip or full free) where the interface normal traction
                exceeds a tensile strength; broken is permanent.

Everything is dense masked math on interface slabs: the per-face state is a
float mask carried in the step pytree, so fracture evolution stays inside
jit (no data-dependent control flow).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax.numpy as jnp

CONTACT_KINDS = ("bonded", "slip", "friction")


@dataclasses.dataclass(frozen=True)
class ContactSpec:
    """Contact between body_a's high face and body_b's low face on ``axis``.

    ``lo_a``/``lo_b``/``span`` (transverse node index tuples, one entry per
    non-contact axis in increasing-axis order) restrict the interface to a
    sub-rectangle of each face: body_a's nodes ``lo_a : lo_a+span`` are
    collocated with body_b's ``lo_b : lo_b+span``.  ``None`` means full
    faces (requires equal transverse shapes).

    ``tensile_strength``: if set, fracture is enabled — interface nodes
    whose normal traction sigma* exceeds it (tension-positive) become
    permanently broken and behave as ``broken_kind`` ('free' = traction-free
    crack faces, 'slip' = frictionless contact that still transmits
    compression, 'friction' = Coulomb crack faces: unilateral normal +
    stick/slide tangential cap — the reference's bonded-to-frictional
    fracture transition, SURVEY.md §0.4).

    ``friction_mu``: Coulomb coefficient for ``kind='friction'`` and for
    ``broken_kind='friction'`` crack faces.
    """

    body_a: str
    body_b: str
    axis: int
    kind: str = "bonded"
    tensile_strength: Optional[float] = None
    broken_kind: str = "free"
    lo_a: Optional[Tuple[int, ...]] = None
    lo_b: Optional[Tuple[int, ...]] = None
    span: Optional[Tuple[int, ...]] = None
    friction_mu: float = 0.0

    def __post_init__(self):
        if self.kind not in CONTACT_KINDS:
            raise ValueError(f"unknown contact kind {self.kind!r}")
        if self.broken_kind not in ("free", "slip", "friction"):
            raise ValueError(f"unknown broken kind {self.broken_kind!r}")
        given = (self.lo_a, self.lo_b, self.span)
        if any(g is not None for g in given) and any(g is None for g in given):
            raise ValueError("lo_a, lo_b and span must be given together")


def face_sub_index(ax: int, side: int, dim: int,
                   lo: Optional[Tuple[int, ...]],
                   span: Optional[Tuple[int, ...]]) -> Tuple:
    """Index tuple selecting the (sub-rectangle of the) boundary face."""
    idx = []
    t = 0
    for d in range(dim):
        if d == ax:
            idx.append(0 if side == 0 else -1)
        elif lo is None:
            idx.append(slice(None))
        else:
            idx.append(slice(lo[t], lo[t] + span[t]))
            t += 1
    return tuple(idx)


def _adhesion(a, b, z_a, z_b):
    """Interface solve: returns (w_in_a, w_in_b, sigma*) for the glued case."""
    denom = jnp.maximum(z_a + z_b, 1e-30)
    v_star = (b - a) / denom
    s_star = (z_b * a + z_a * b) / denom
    return s_star + z_a * v_star, s_star - z_b * v_star, s_star


def _pair_incoming(
    spec: ContactSpec,
    is_normal: bool,
    out_a, out_b, z_a, z_b,
    glue,
    sigma_c,
):
    """Incoming invariants of one pair from the outgoing ones — all kind
    (bonded/slip/friction), fracture and unilateral logic in one place.
    ``sigma_c`` is the contact compression from the normal solve (consumed
    by tangential friction pairs). Returns (in_a, in_b, sigma*)."""
    in_a_glued, in_b_glued, s_star = _adhesion(out_a, out_b, z_a, z_b)
    in_a_free = -out_a
    in_b_free = -out_b

    def unilateral():
        # adhesion while in compression, traction-free when open
        closed = s_star < 0.0
        return (jnp.where(closed, in_a_glued, in_a_free),
                jnp.where(closed, in_b_glued, in_b_free))

    def coulomb_tangential(mu):
        # stick while |tau*| <= mu*sigma_c, else slide at the capped
        # traction (prescribed equal traction both sides)
        cap = mu * sigma_c
        stick = jnp.abs(s_star) <= cap
        tau_c = jnp.sign(s_star) * cap
        return (jnp.where(stick, in_a_glued, 2.0 * tau_c - out_a),
                jnp.where(stick, in_b_glued, 2.0 * tau_c - out_b))

    # intact behavior by kind
    if spec.kind == "bonded":
        intact_a, intact_b = in_a_glued, in_b_glued
    elif spec.kind == "slip":
        if is_normal:
            intact_a, intact_b = in_a_glued, in_b_glued
        else:
            intact_a, intact_b = in_a_free, in_b_free
    else:  # friction
        if is_normal:
            intact_a, intact_b = unilateral()
        else:
            intact_a, intact_b = coulomb_tangential(spec.friction_mu)

    if glue is None:
        return intact_a, intact_b, s_star
    # broken behavior: 'free' cracks are traction-free; 'slip' cracks
    # still transmit compression on the normal pair; 'friction' cracks
    # are Coulomb contacts (the reference's bonded-to-frictional fracture
    # transition, SURVEY.md §0.4)
    if is_normal and spec.broken_kind in ("slip", "friction"):
        broken_a, broken_b = unilateral()
    elif not is_normal and spec.broken_kind == "friction":
        broken_a, broken_b = coulomb_tangential(spec.friction_mu)
    else:
        broken_a, broken_b = in_a_free, in_b_free
    return (jnp.where(glue, intact_a, broken_a),
            jnp.where(glue, intact_b, broken_b), s_star)


def _split_normal(pairs: Dict[int, tuple], ax: int):
    keys = sorted(pairs)
    normal = [k for k in keys if pairs[k][2].traction_axis == ax]
    return normal + [k for k in keys if k not in normal]


def _require_normal_pair(spec, pair_specs, ax: int) -> None:
    """Friction needs the normal solve's sigma_c before any tangential
    pair; without a pair whose traction_axis == contact axis, sigma_c
    stays None and the Coulomb cap would raise a TypeError deep inside
    jit tracing (advisor r2) — fail with the physics reason instead."""
    needs = (spec.kind == "friction"
             or getattr(spec, "broken_kind", None) == "friction")
    if needs and not any(
            p.traction_axis == ax for p in pair_specs):
        raise ValueError(
            f"friction contact on axis {ax} requires a characteristic "
            "pair with traction_axis == axis (the normal solve feeds "
            "the Coulomb cap), but this model's stage has none")


def _fracture(spec: ContactSpec, bonded, s_star_n):
    if bonded is None or s_star_n is None or spec.tensile_strength is None:
        return bonded
    still = (s_star_n <= spec.tensile_strength).astype(bonded.dtype)
    return bonded * still


def apply_contact(
    spec: ContactSpec,
    dim: int,
    pairs_a: Dict[int, tuple],
    pairs_b: Dict[int, tuple],
    view_a,
    view_b,
    bonded: Optional[jnp.ndarray],
    normal_axis: Optional[int] = None,
) -> Tuple[Dict[int, tuple], Dict[int, tuple], Optional[jnp.ndarray]]:
    """Apply one contact's interface solves to both bodies' invariants.

    ``pairs_*``: pair_index -> (w_l, w_r, PairSpec) full-domain invariant
    arrays from the raw sweep along ``spec.axis``.  The normal pair is
    solved first (its sigma* feeds the unilateral/friction/fracture
    logic of the tangential pairs), then each tangential pair.  Returns the
    updated dicts and the new bonded mask (or None).

    ``normal_axis``: the PHYSICAL axis of the sweep's stage (st.axis) —
    pair ``traction_axis`` labels are physical, so under a permuted
    (canonical) layout comparing them against the ARRAY axis
    ``spec.axis`` would flag a shear pair as the interface normal
    (code-review r5). Defaults to ``spec.axis`` (identical layouts).
    """
    ax = spec.axis
    nax = normal_axis if normal_axis is not None else ax
    _require_normal_pair(spec, [pairs_a[k][2] for k in pairs_a], nax)
    idx_a = face_sub_index(ax, 1, dim, spec.lo_a, spec.span)
    idx_b = face_sub_index(ax, 0, dim, spec.lo_b, spec.span)

    glue = (bonded > 0.5) if bonded is not None else None
    s_star_n = None
    sigma_c = None
    order_ks = _split_normal(pairs_a, nax)

    for k in order_ks:
        is_normal = pairs_a[k][2].traction_axis == nax
        w_l_a, w_r_a, p = pairs_a[k]
        w_l_b, w_r_b, pb = pairs_b[k]
        in_a, in_b, s_star = _pair_incoming(
            spec, is_normal,
            w_r_a[idx_a], w_l_b[idx_b],
            view_a.pair_z[k][idx_a], view_b.pair_z[k][idx_b],
            glue, sigma_c)
        if is_normal:
            s_star_n = s_star
            sigma_c = jnp.maximum(-s_star, 0.0)
        pairs_a[k] = (w_l_a.at[idx_a].set(in_a), w_r_a, p)
        pairs_b[k] = (w_l_b, w_r_b.at[idx_b].set(in_b), pb)

    return pairs_a, pairs_b, _fracture(spec, bonded, s_star_n)


def apply_contact_post(
    spec: ContactSpec,
    model,
    u_old_a: jnp.ndarray,
    u_a: jnp.ndarray,
    u_old_b: jnp.ndarray,
    u_b: jnp.ndarray,
    view_a,
    view_b,
    bonded: Optional[jnp.ndarray],
    idx_axis: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]:
    """Contact solve as a post-fixup on raw (border/contact-free) sweeps.

    The pair reconstruction is invertible, so the interface condition can
    be applied after the sweep from the face slabs alone — the composition
    point that lets the multi-body engine run raw per-body sweeps (sharded
    halo stages, full steps) and stitch contacts with cheap slab math
    (mirrors solver.boundary.apply_borders_post). ``u_old_*`` are the pre-sweep
    states (needed to re-propagate the zero-speed invariants at the face).

    ``idx_axis``: spatial array dimension of the interface normal when the
    arrays are in a permuted layout (physics follows ``spec.axis``).
    """
    ax = spec.axis
    dim = model.dim
    st = model.stage(ax)
    # normal identification is by PHYSICAL axis: under a permuted
    # (canonical) model, stage(ax).axis is the physical sweep axis and
    # pair traction_axis labels are physical — comparing against the
    # array axis ``ax`` would pick a shear pair as the normal
    # (code-review r5)
    nax = st.axis
    _require_normal_pair(spec, st.pairs, nax)
    sign = model.sign
    ax_idx = idx_axis if idx_axis is not None else ax
    idx_a = face_sub_index(ax_idx, 1, dim, spec.lo_a, spec.span)
    idx_b = face_sub_index(ax_idx, 0, dim, spec.lo_b, spec.span)

    glue = (bonded > 0.5) if bonded is not None else None
    s_star_n = None
    sigma_c = None
    sigma_fixed_a: Dict[int, jnp.ndarray] = {}
    sigma_fixed_b: Dict[int, jnp.ndarray] = {}
    pairs = {k: (None, None, p) for k, p in enumerate(st.pairs)}

    for k in _split_normal(pairs, nax):
        p = st.pairs[k]
        is_normal = p.traction_axis == nax
        z_a = view_a.pair_z[k][idx_a]
        z_b = view_b.pair_z[k][idx_b]
        A_a, B_a = u_a[p.sigma][idx_a], u_a[p.vel][idx_a]
        A_b, B_b = u_b[p.sigma][idx_b], u_b[p.vel][idx_b]
        out_a = A_a - sign * z_a * B_a      # w_R at body_a's high face
        out_b = A_b + sign * z_b * B_b      # w_L at body_b's low face
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
        u_a = u_a.at[(p.sigma,) + idx_a].set(A_a2)
        u_a = u_a.at[(p.vel,) + idx_a].set(B_a2)
        u_b = u_b.at[(p.sigma,) + idx_b].set(A_b2)
        u_b = u_b.at[(p.vel,) + idx_b].set(B_b2)
        sigma_fixed_a[p.sigma] = A_a2
        sigma_fixed_b[p.sigma] = A_b2

    # re-propagate the zero-speed invariants at the fixed face slabs
    for j, zc in enumerate(st.zeros):
        if zc.src in sigma_fixed_a:
            kap_a = view_a.zero_kappa[j][idx_a]
            z_new = u_old_a[zc.comp][idx_a] + kap_a * (
                sigma_fixed_a[zc.src] - u_old_a[zc.src][idx_a])
            u_a = u_a.at[(zc.comp,) + idx_a].set(z_new)
            kap_b = view_b.zero_kappa[j][idx_b]
            z_new = u_old_b[zc.comp][idx_b] + kap_b * (
                sigma_fixed_b[zc.src] - u_old_b[zc.src][idx_b])
            u_b = u_b.at[(zc.comp,) + idx_b].set(z_new)

    return u_a, u_b, _fracture(spec, bonded, s_star_n)
