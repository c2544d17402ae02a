"""Multi-body stepping: per-body sweeps stitched by contact solves.

Counterpart of the reference Engine's multi-mesh handling
(SURVEY.md §3.1 "contact correction between meshes"). All bodies advance
each sweep together; on sweeps along a contact's axis, the two bodies'
interface faces exchange outgoing invariants and receive the contact solve
instead of a border condition. Bodies live in one dict pytree, so a single
jit covers the whole system and XLA schedules bodies concurrently.

Bodies must share the model and interpolation order; each body has its own
grid shape, materials (isotropic or orthotropic — anything exposing
``axis_view``), and border conditions. Contact interfaces may be
grid-conforming (collocated nodes — optionally **offset sub-rectangles**
of the two faces via ContactSpec lo_a/lo_b/span: face nodes outside the
overlap keep the body's own border condition, so stepped assemblies work)
or **non-conforming** (mismatched spacing/alignment): pass static
interface-interpolation maps per contact index (``ncmaps``, built by
solver.contact_nc.build_interface_maps) and the interface algebra is
solved pointwise per side through them. Friction contacts (Coulomb cap)
are solved normal-pair-first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp

from gcm_tpu.materials import MaterialFields
from gcm_tpu.models.spec import Model
from gcm_tpu.ops.stage import (
    apply_zero_invariants, reconstruct_pair, stage_pair_updates,
)
from gcm_tpu.solver.boundary import correct_pair_at_face
from gcm_tpu.solver.contact import ContactSpec, apply_contact
from gcm_tpu.task import BorderSpec

BodyStates = Dict[str, jnp.ndarray]
BondedState = Dict[int, jnp.ndarray]   # contact index -> interface mask


def stage_multi(
    model: Model,
    us: BodyStates,
    mats: Dict[str, MaterialFields],
    dt: float,
    hs: Dict[str, Sequence[float]],
    axis: int,
    order: int,
    borders: Dict[str, Dict[Tuple[int, int], BorderSpec]],
    contacts: Sequence[ContactSpec],
    bonded: BondedState,
    ncmaps: Optional[Dict[int, object]] = None,
) -> Tuple[BodyStates, BondedState]:
    """One sweep along ``axis`` for every body, with contact coupling."""
    ncmaps = ncmaps or {}
    # 1. raw invariant updates per body
    pair_ws: Dict[str, Dict[int, tuple]] = {}
    views = {}
    st = model.stage(axis)
    for name, u in us.items():
        views[name] = mats[name].axis_view(axis, st)
        pair_ws[name] = stage_pair_updates(
            model, u, views[name], dt / hs[name][axis], axis, order)

    # faces fully consumed by a contact: the body's own border condition is
    # skipped there.  Partial-overlap contacts (lo/span set) leave the face's
    # border condition in force — the contact solve then overwrites only the
    # overlap sub-rectangle (step 3 runs after step 2), so the exposed part
    # of a stepped face keeps e.g. its free surface.
    full_contact_faces = set()
    for ci, c in enumerate(contacts):
        if c.axis == axis and c.span is None and ci not in ncmaps:
            full_contact_faces.add((c.body_a, axis, 1))
            full_contact_faces.add((c.body_b, axis, 0))

    # 2. border corrections on every (non-fully-contacted) face
    for name in us:
        view = views[name]
        for k, (w_l, w_r, p) in pair_ws[name].items():
            z = view.pair_z[k]
            for side in (0, 1):
                if (name, axis, side) in full_contact_faces:
                    continue
                bc = borders.get(name, {}).get((axis, side))
                if bc is not None:
                    val = bc.pair_value(p.traction_axis, st.axis)
                    w_l, w_r = correct_pair_at_face(
                        w_l, w_r, z, model.sign, bc, axis, side, val
                    )
            pair_ws[name][k] = (w_l, w_r, p)

    # 3. contact solves on this axis (normal pair first — its sigma* feeds
    # friction/unilateral/fracture logic; overwrites the overlap sub-slabs)
    new_bonded = dict(bonded)
    for ci, c in enumerate(contacts):
        if c.axis != axis or ci in ncmaps:
            continue
        pa, pb, nb = apply_contact(
            c, model.dim, pair_ws[c.body_a], pair_ws[c.body_b],
            views[c.body_a], views[c.body_b], bonded.get(ci),
            normal_axis=st.axis,
        )
        pair_ws[c.body_a] = pa
        pair_ws[c.body_b] = pb
        if nb is not None:
            new_bonded[ci] = nb

    # 4. reconstruction
    out: BodyStates = {}
    for name, u in us.items():
        view = views[name]
        comps: Dict[int, jnp.ndarray] = {}
        for k, (w_l, w_r, p) in pair_ws[name].items():
            z = view.pair_z[k]
            A_new, B_new = reconstruct_pair(w_l, w_r, z, u[p.vel], model.sign)
            comps[p.sigma] = A_new
            comps[p.vel] = B_new
        apply_zero_invariants(model, u, comps, view, axis)
        out[name] = jnp.stack([comps.get(i, u[i]) for i in range(model.ncomp)])

    # 5. non-conforming contacts: per-side mapped solves as post-fixups
    # (the reconstruction is invertible, so this is the same composition
    # point as stage_multi_fast's)
    for ci, c in enumerate(contacts):
        if c.axis != axis or ci not in ncmaps:
            continue
        from gcm_tpu.solver.contact_nc import apply_contact_nc_post

        ua, ub, nb = apply_contact_nc_post(
            c, model, ncmaps[ci], us[c.body_a], out[c.body_a],
            us[c.body_b], out[c.body_b],
            views[c.body_a], views[c.body_b], bonded.get(ci))
        out[c.body_a], out[c.body_b] = ua, ub
        if nb is not None:
            new_bonded[ci] = nb
    return out, new_bonded


def stage_multi_fast(
    model: Model,
    us: BodyStates,
    mats: Dict[str, MaterialFields],
    axis: int,
    borders: Dict[str, Dict[Tuple[int, int], BorderSpec]],
    contacts: Sequence[ContactSpec],
    bonded: BondedState,
    raw_stage,
    ncmaps: Optional[Dict[int, object]] = None,
) -> Tuple[BodyStates, BondedState]:
    """One sweep with per-body RAW sweeps + post-fixups.

    ``raw_stage(name, u, axis)`` runs a border/contact-free sweep for one
    body — on a device mesh, the shard_map halo stage (parallel.halo).
    Borders and contacts are then applied as exactly-equivalent slab
    fixups (solver.boundary.apply_borders_post /
    solver.contact.apply_contact_post): the invariant reconstruction is
    invertible, so correcting the face slabs after the sweep reproduces
    the in-sweep conditions bit-for-bit.
    """
    from gcm_tpu.solver.boundary import apply_borders_post
    from gcm_tpu.solver.contact import apply_contact_post

    ncmaps = ncmaps or {}
    st = model.stage(axis)
    views = {name: mats[name].axis_view(axis, st) for name in us}

    full_contact_faces = set()
    for ci, c in enumerate(contacts):
        if c.axis == axis and c.span is None and ci not in ncmaps:
            full_contact_faces.add((c.body_a, axis, 1))
            full_contact_faces.add((c.body_b, axis, 0))

    out: BodyStates = {}
    for name, u in us.items():
        u_raw = raw_stage(name, u, axis)
        bcs = {f: b for f, b in borders.get(name, {}).items()
               if f[0] == axis and (name,) + f not in full_contact_faces}
        out[name] = apply_borders_post(
            model, u, u_raw, mats[name], axis, bcs) if bcs else u_raw

    new_bonded = dict(bonded)
    for ci, c in enumerate(contacts):
        if c.axis != axis:
            continue
        if ci in ncmaps:
            from gcm_tpu.solver.contact_nc import apply_contact_nc_post

            ua, ub, nb = apply_contact_nc_post(
                c, model, ncmaps[ci], us[c.body_a], out[c.body_a],
                us[c.body_b], out[c.body_b],
                views[c.body_a], views[c.body_b], bonded.get(ci))
        else:
            ua, ub, nb = apply_contact_post(
                c, model, us[c.body_a], out[c.body_a],
                us[c.body_b], out[c.body_b],
                views[c.body_a], views[c.body_b], bonded.get(ci))
        out[c.body_a], out[c.body_b] = ua, ub
        if nb is not None:
            new_bonded[ci] = nb
    return out, new_bonded


def step_multi_fast(
    model: Model,
    us: BodyStates,
    mats: Dict[str, MaterialFields],
    borders: Dict[str, Dict[Tuple[int, int], BorderSpec]],
    contacts: Sequence[ContactSpec],
    bonded: BondedState,
    raw_stage,
    axes: Optional[Sequence[int]] = None,
    ncmaps: Optional[Dict[int, object]] = None,
) -> Tuple[BodyStates, BondedState]:
    if axes is None:
        axes = range(model.dim)
    for a in axes:
        us, bonded = stage_multi_fast(
            model, us, mats, a, borders, contacts, bonded, raw_stage, ncmaps)
    return us, bonded


def fused_contacts_ok(model: Model, shapes: Dict[str, Tuple[int, ...]],
                      contacts: Sequence[ContactSpec], order: int,
                      ncmaps: Optional[Dict[int, object]] = None) -> bool:
    """Whether :func:`step_multi_fused`'s face-slab fixup composition is
    exact for this contact topology.  Requirements:

    - conforming contacts only (non-conforming maps change the fixup rows);
    - per body, contacts on a single axis (contacts on two axes couple at
      the shared face-edge line, which the independent per-contact fixups
      cannot see);
    - at most one contact per (body, axis, side) face (two sub-rectangle
      contacts on one face would each rewrite the whole face row);
    - every contacted body deeper than the r+1 fixup slab along the axis.
    """
    from gcm_tpu.ops.interp import stencil_radius

    if ncmaps:
        return False
    depth = stencil_radius(order) + 1
    body_axes: Dict[str, set] = {}
    seen_faces = set()
    for c in contacts:
        for name, side in ((c.body_a, 1), (c.body_b, 0)):
            body_axes.setdefault(name, set()).add(c.axis)
            face = (name, c.axis, side)
            if face in seen_faces:
                return False
            seen_faces.add(face)
            if shapes[name][c.axis] <= depth:
                return False
    return all(len(s) == 1 for s in body_axes.values())


def step_multi_fused(
    model: Model,
    us: BodyStates,
    mats: Dict[str, MaterialFields],
    dt: float,
    hs: Dict[str, Sequence[float]],
    order: int,
    borders: Dict[str, Dict[Tuple[int, int], BorderSpec]],
    contacts: Sequence[ContactSpec],
    bonded: BondedState,
    fused_body,
    axes: Optional[Sequence[int]] = None,
) -> Tuple[BodyStates, BondedState]:
    """Full step per body in ONE pass + contact face-slab fixups.

    ``fused_body(name, u, axes)`` runs a body's complete time step (all
    sweeps, its own non-contact border conditions in place, raw edge-clamp
    at full-contact faces) — the canonical-layout composition of
    MultiBodyEngine.

    Why a face-row fixup after the *full* step is exact:

    - during the sweep along the contact axis ``a``, only the interface
      face row consumes out-of-domain values — every interior row's
      stencil stays in-domain, so the kernel's raw step and the per-sweep
      reference agree everywhere except that row;
    - sweeps along other axes never move data across ``a`` (dimensional
      splitting is 1D), so the contamination stays in the face row for the
      rest of the step;
    - the correct face row is recomputable from the PRE-step state on an
      (r+1)-deep slab: redo the pre-``a`` sweeps on the slab (transverse
      stencils are full-extent there), apply the contact solve via the
      invertible-reconstruction fixup (apply_contact_post), then redo the
      post-``a`` sweeps on the 1-deep face row.

    Eligibility is :func:`fused_contacts_ok`; callers fall back to
    :func:`step_multi_fast` otherwise.
    """
    axes = tuple(axes) if axes is not None else tuple(range(model.dim))
    out: BodyStates = {name: fused_body(name, u, axes)
                       for name, u in us.items()}
    return apply_contact_fixups(model, us, out, mats, dt, hs, order,
                                borders, contacts, bonded, axes)


def apply_contact_fixups(
    model: Model,
    us: BodyStates,
    out: BodyStates,
    mats: Dict[str, MaterialFields],
    dt: float,
    hs: Dict[str, Sequence[float]],
    order: int,
    borders: Dict[str, Dict[Tuple[int, int], BorderSpec]],
    contacts: Sequence[ContactSpec],
    bonded: BondedState,
    axes: Tuple[int, ...],
) -> Tuple[BodyStates, BondedState]:
    """The face-slab fixup phase of :func:`step_multi_fused`, standalone:
    pure jnp on (pre-step states, raw full-step outputs).  Exposed
    separately so callers can jit the per-body steps and this phase as
    independent programs.
    """
    import jax

    from gcm_tpu.ops.interp import stencil_radius
    from gcm_tpu.solver.contact import apply_contact_post
    from gcm_tpu.solver.gcm import stage

    axes = tuple(axes)
    r = stencil_radius(order)
    depth = r + 1
    dim = model.dim

    def slab_idx(a: int, side: int, n: int) -> Tuple:
        sl = [slice(None)] * dim
        sl[a] = slice(-n, None) if side == 1 else slice(0, n)
        return tuple(sl)

    out = dict(out)
    new_bonded = dict(bonded)

    for ci, c in enumerate(contacts):
        a = c.axis
        pos = axes.index(a)
        before, after = axes[:pos], axes[pos + 1:]
        st = model.stage(a)
        # Permute slabs so the thin (depth r+1 / 1) contact axis moves to
        # the FRONT of the spatial dims, keeping the full-extent axes
        # contiguous. Physics stays on the physical axis via
        # stage(dim_axis=...)/apply_contact_post(idx_axis=...); a == 0
        # makes every transpose a no-op.
        perm = (a,) + tuple(d for d in range(dim) if d != a)
        inv_perm = tuple(perm.index(d) for d in range(dim))
        dim_of = {b: perm.index(b) for b in range(dim)}

        def pm_u(x):
            return jnp.transpose(x, (0,) + tuple(1 + p for p in perm))

        def unpm_u(x):
            return jnp.transpose(x, (0,) + tuple(1 + p for p in inv_perm))

        pre = {}
        swept = {}
        matsl = {}
        for name, side in ((c.body_a, 1), (c.body_b, 0)):
            idx = slab_idx(a, side, depth)
            usl = pm_u(us[name][(slice(None),) + idx])
            msl = jax.tree.map(lambda x: jnp.transpose(x[idx], perm),
                               mats[name])
            # transverse borders apply on the slab (full extent there);
            # the slab's interior cut along ``a`` is not a domain face
            bcs_t = {f: b for f, b in borders.get(name, {}).items()
                     if f[0] != a}
            for b_ax in before:
                usl = stage(model, usl, msl, dt, hs[name], b_ax, order,
                            bcs_t, dim_axis=dim_of[b_ax])
            pre[name] = usl
            matsl[name] = msl
            # the contact-axis sweep on the slab: only the face row is
            # consumed.  Partial-overlap contacts first apply the body's
            # own face BC (stage_multi's ordering: BC, then the contact
            # solve overwrites the overlap sub-rectangle).
            bc_face = borders.get(name, {}).get((a, side))
            bcs_a = ({(a, side): bc_face}
                     if (bc_face is not None and c.span is not None)
                     else None)
            swept[name] = stage(model, usl, msl, dt, hs[name], a, order,
                                bcs_a, dim_axis=0)

        ua_fix, ub_fix, nb = apply_contact_post(
            c, model, pre[c.body_a], swept[c.body_a],
            pre[c.body_b], swept[c.body_b],
            matsl[c.body_a].axis_view(a, st),
            matsl[c.body_b].axis_view(a, st),
            bonded.get(ci), idx_axis=0)
        if nb is not None:
            new_bonded[ci] = nb

        for name, ufix in ((c.body_a, ua_fix), (c.body_b, ub_fix)):
            side = 1 if name == c.body_a else 0
            pidx = slab_idx(0, side, 1)        # permuted layout: axis 0
            frow = ufix[(slice(None),) + pidx]
            mrow = jax.tree.map(lambda x: x[pidx], matsl[name])
            bcs_t = {f: b for f, b in borders.get(name, {}).items()
                     if f[0] != a}
            for b_ax in after:
                frow = stage(model, frow, mrow, dt, hs[name], b_ax, order,
                             bcs_t, dim_axis=dim_of[b_ax])
            fidx = slab_idx(a, side, 1)
            out[name] = out[name].at[(slice(None),) + fidx].set(
                unpm_u(frow))

    return out, new_bonded


def step_multi(
    model: Model,
    us: BodyStates,
    mats: Dict[str, MaterialFields],
    dt: float,
    hs: Dict[str, Sequence[float]],
    order: int,
    borders: Dict[str, Dict[Tuple[int, int], BorderSpec]],
    contacts: Sequence[ContactSpec],
    bonded: BondedState,
    axes: Optional[Sequence[int]] = None,
    ncmaps: Optional[Dict[int, object]] = None,
) -> Tuple[BodyStates, BondedState]:
    if axes is None:
        axes = range(model.dim)
    for a in axes:
        us, bonded = stage_multi(
            model, us, mats, dt, hs, a, order, borders, contacts, bonded,
            ncmaps,
        )
    return us, bonded
