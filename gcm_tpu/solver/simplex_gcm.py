"""Grid-characteristic method on simplex meshes: gather-based sweeps.

Counterpart of the reference's simplex GCM specialization
(SURVEY.md §2 component 9, §3.3; BASELINE config 5). Same pair/zero
characteristic algebra as the cubic solver (gcm_tpu.models.spec), but the
semi-Lagrangian interpolation is a barycentric gather over precomputed
static tables (gcm_tpu.grids.simplex.build_foot_tables) — ``jnp.take`` over
node arrays, fully static indices.

State layout: ``u[ncomp, N]``; material fields ``[N]``. Border conditions:
the full characteristic set (absorbing, free, fixed_force, fixed_velocity),
applied where the characteristic foot leaves the hull (the unstructured
analogue of incoming-invariant overwrites on boundary slabs). Pass a kind
string / task.BorderSpec (one condition for the whole hull) or a
:class:`NodeBorders` table (per-node conditions assigned by Area — free
surface on top, absorbing sides, etc.; build with build_node_borders).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np

from gcm_tpu.grids.simplex import FootTables, SimplexGrid
from gcm_tpu.materials import MaterialFields
from gcm_tpu.models.spec import Model
from gcm_tpu.task import BORDER_KINDS, Area, BorderSpec

_Z_EPS = 1e-30

#: border-kind codes for the per-node tables (order matches BORDER_KINDS)
BORDER_CODES = {k: i for i, k in enumerate(BORDER_KINDS)}


@dataclasses.dataclass
class NodeBorders:
    """Per-node border assignment — the unstructured analogue of the
    reference's BCs-by-Area (SURVEY.md §2 component 14): e.g. free surface
    on the top of a body, absorbing on its sides.

    - ``kind [N] int32``: BORDER_CODES of each node's condition (only hull
      nodes matter — interior feet never leave the domain);
    - ``value [N, dim, dim]``: value[n, a, t] is the prescribed
      traction/velocity for the pair with traction axis ``t`` in the sweep
      along ``a`` (BorderSpec.pair_value semantics, resolved per node).
    """

    kind: np.ndarray
    value: np.ndarray


def build_node_borders(
    grid: SimplexGrid,
    assignments: Sequence[Tuple[Union[Area, np.ndarray], BorderSpec]],
    default: BorderSpec = BorderSpec("absorbing"),
) -> NodeBorders:
    """Assign BorderSpecs to hull nodes by Area (or explicit node mask),
    later assignments winning where areas overlap."""
    n, dim = grid.npoints, grid.dim
    kind = np.full(n, BORDER_CODES[default.kind], np.int32)
    value = np.zeros((n, dim, dim))
    for a in range(dim):
        for t in range(dim):
            value[:, a, t] = default.pair_value(t, a)
    for selector, spec in assignments:
        if isinstance(selector, Area):
            m = selector.contains(grid.points)
        else:
            m = np.asarray(selector, bool)
        kind[m] = BORDER_CODES[spec.kind]
        for a in range(dim):
            for t in range(dim):
                value[m, a, t] = spec.pair_value(t, a)
    return NodeBorders(kind=kind, value=value)


def _gather_interp(f: jnp.ndarray, ids: jnp.ndarray, wts: jnp.ndarray):
    """Barycentric interpolation: sum_j wts[:, j] * f[ids[:, j]]."""
    return (jnp.take(f, ids, axis=0) * wts).sum(axis=1)


def _border_kind_value(border_kind, pair, axis):
    """Normalize the border argument: a kind string or a BorderSpec.

    A BorderSpec applies its per-traction-axis value exactly as on
    structured faces (task.BorderSpec.pair_value).
    """
    if isinstance(border_kind, str):
        return border_kind, 0.0
    return border_kind.kind, border_kind.pair_value(pair.traction_axis, axis)


def simplex_stage(
    model: Model,
    u: jnp.ndarray,
    mat: MaterialFields,
    tables: Dict[Tuple, FootTables],
    axis: int,
    border_kind: Union[str, BorderSpec, NodeBorders] = "absorbing",
) -> jnp.ndarray:
    """One characteristic sweep along coordinate axis ``axis``.

    ``tables`` may be keyed ``(axis, wave, dir)`` (isotropic: one table per
    wave family) or ``(axis, pair_index, dir)`` (anisotropic: per-pair feet,
    built by grids.simplex.build_foot_tables_for_model). Impedances come
    from the material's ``axis_view`` — the same anisotropy point as the
    structured sweeps — so isotropic and orthotropic media share this code.
    """
    st = model.stage(axis)
    sign = model.sign
    view = mat.axis_view(axis, st)
    comps: Dict[int, jnp.ndarray] = {}

    # ---- batched interpolation: ONE row-gather per distinct foot table.
    # Fetching all components a table serves in one [N, K, m] gather
    # issues one gather per table instead of one per component (shared
    # P/S tables serve two S pairs in 3D: 12 gathers/stage become 4).
    table_comps: Dict[Tuple, list] = {}
    pair_keys = {}
    for k, p in enumerate(st.pairs):
        key_p = (axis, k, +1) if (axis, k, +1) in tables else (axis, p.wave, +1)
        if key_p not in tables:
            continue
        pair_keys[k] = key_p
        for key in (key_p, key_p[:2] + (-1,)):
            lst = table_comps.setdefault(key, [])
            for c in (p.sigma, p.vel):
                if c not in lst:
                    lst.append(c)
    interp: Dict[Tuple, Dict[int, jnp.ndarray]] = {}
    gather_by_k: Dict[int, list] = {}
    stencil_keys = []
    for key, clist in table_comps.items():
        t = tables[key]
        if getattr(t, "stencil", None) is not None:
            stencil_keys.append(key)
        else:
            gather_by_k.setdefault(int(t.ids.shape[1]), []).append(key)
    for key in stencil_keys:
        # compressed-stencil form (grids.simplex.compress_foot_tables):
        # the gather regroups by index delta into |D| weighted rolls of
        # the table's OWN component rows — no gathers.  Out-of-range
        # rolled rows wrap circularly, but their weight is structurally
        # zero.  Comp-major throughout: no transposes.  Per-table narrow
        # rolls: rolling the FULL 9-comp u once per stage moves more
        # data than the op-count saving is worth.
        t = tables[key]
        clist = table_comps[key]
        deltas, wst = t.stencil
        usel = u[jnp.asarray(clist)]                 # [m, N]
        wj = jnp.asarray(wst, dtype=u.dtype)         # [nd, N]
        acc = None
        for i, d in enumerate(deltas):
            term = wj[i] * jnp.roll(usel, -int(d), axis=1)
            acc = term if acc is None else acc + term
        interp[key] = {c: acc[j] for j, c in enumerate(clist)}
    if gather_by_k:
        # fallback for non-compressible tables: ONE merged node-major
        # row-gather per stencil width — gathering all ncomp per row and
        # merging tables saves the per-table transposes and dispatches
        u_nm = u.T                                       # [N, ncomp]
        for kw, keys_k in gather_by_k.items():
            ids_all = jnp.concatenate(
                [jnp.asarray(tables[k].ids) for k in keys_k], 0)
            wts_all = jnp.concatenate(
                [jnp.asarray(tables[k].weights, dtype=u.dtype)
                 for k in keys_k], 0)
            rows = jnp.take(u_nm, ids_all, axis=0)       # [sumN, K, ncomp]
            vals = (rows * wts_all[:, :, None]).sum(1)   # [sumN, ncomp]
            off = 0
            for k in keys_k:
                nn = tables[k].ids.shape[0]
                v = vals[off:off + nn]
                off += nn
                interp[k] = {c: v[:, c] for c in table_comps[k]}

    for k, p in enumerate(st.pairs):
        if k not in pair_keys:
            continue  # wave family absent (e.g. S in a fluid)
        key_p = pair_keys[k]
        tp = tables[key_p]
        tm = tables[key_p[:2] + (-1,)]
        z = view.pair_z[k]
        A, B = u[p.sigma], u[p.vel]
        szb = sign * z

        ip, im = interp[key_p], interp[key_p[:2] + (-1,)]
        w_l = ip[p.sigma] + szb * ip[p.vel]
        w_r = im[p.sigma] - szb * im[p.vel]

        # border: feet outside the hull are incoming invariants, overwritten
        # from the physical constraint using the node's outgoing invariant
        # (same characteristic algebra as solver.boundary, SURVEY.md §0.4)
        out_p = jnp.asarray(tp.outside)   # w_l incoming where its foot left
        out_m = jnp.asarray(tm.outside)   # w_r incoming where its foot left
        w_l0, w_r0 = w_l, w_r
        if isinstance(border_kind, NodeBorders):
            # per-node kinds/values (BCs-by-area): build the incoming
            # invariant for every kind and select by node code
            code = jnp.asarray(border_kind.kind)
            val = jnp.asarray(
                border_kind.value[:, axis, p.traction_axis], dtype=u.dtype)
            zero = jnp.zeros_like(w_l0)
            inc_l = jnp.where(
                code == 0, zero, jnp.where(
                    code == 1, -w_r0, jnp.where(
                        code == 2, 2.0 * val - w_r0,
                        w_r0 + 2.0 * sign * z * val)))
            inc_r = jnp.where(
                code == 0, zero, jnp.where(
                    code == 1, -w_l0, jnp.where(
                        code == 2, 2.0 * val - w_l0,
                        w_l0 - 2.0 * sign * z * val)))
            w_l = jnp.where(out_p, inc_l, w_l)
            w_r = jnp.where(out_m, inc_r, w_r)
        else:
            kind, val = _border_kind_value(border_kind, p, axis)
            if kind == "absorbing":
                w_l = jnp.where(out_p, 0.0, w_l)
                w_r = jnp.where(out_m, 0.0, w_r)
            elif kind == "free":
                w_l = jnp.where(out_p, -w_r0, w_l)
                w_r = jnp.where(out_m, -w_l0, w_r)
            elif kind == "fixed_force":
                w_l = jnp.where(out_p, 2.0 * val - w_r0, w_l)
                w_r = jnp.where(out_m, 2.0 * val - w_l0, w_r)
            elif kind == "fixed_velocity":
                w_l = jnp.where(out_p, w_r0 + 2.0 * sign * z * val, w_l)
                w_r = jnp.where(out_m, w_l0 - 2.0 * sign * z * val, w_r)
            else:  # pragma: no cover
                raise ValueError(kind)

        A_new = 0.5 * (w_l + w_r)
        B_prop = sign * (w_l - w_r) / (2.0 * jnp.maximum(z, _Z_EPS))
        B_new = jnp.where(z > 0, B_prop, B)
        comps[p.sigma] = A_new
        comps[p.vel] = B_new

    for j, zc in enumerate(st.zeros):
        if zc.src in comps:
            comps[zc.comp] = u[zc.comp] + view.zero_kappa[j] * (
                comps[zc.src] - u[zc.src])

    return jnp.stack([comps.get(i, u[i]) for i in range(model.ncomp)])


def simplex_step(
    model: Model,
    u: jnp.ndarray,
    mat: MaterialFields,
    tables: Dict[Tuple[int, str, int], FootTables],
    border_kind: Union[str, BorderSpec, NodeBorders] = "absorbing",
    axes: Optional[Sequence[int]] = None,
) -> jnp.ndarray:
    if axes is None:
        axes = range(model.dim)
    for a in axes:
        u = simplex_stage(model, u, mat, tables, a, border_kind)
    return u
