"""Characteristic border conditions as masked boundary-slab corrections.

Counterpart of the reference's border correctors (SURVEY.md §2
component 10; §0.4). At a domain face, the invariant *leaving* the domain
(w_L at a low face never leaves — see below) is known from the interior
interpolation; the invariant *entering* is chosen to satisfy the physical
constraint. With the pair convention of gcm_tpu.models.spec:

- ``w_L = A + s z B`` rides speed −c → enters at the HIGH face, leaves at
  the LOW face;
- ``w_R = A − s z B`` rides speed +c → enters at the LOW face.

Low face (side=0), known outgoing ``w_L``:
    absorbing       : w_R = 0
    free            : A = 0      → w_R = −w_L
    fixed_force  F  : A = F      → w_R = 2F − w_L
    fixed_velocity V: B = V      → w_R = w_L − 2 s z V
High face (side=1) mirrors with L↔R and ``w_L = w_R + 2 s z V``.

These are exact characteristic BCs (not sponge layers): the absorbing face
is perfectly non-reflecting for normal incidence, and the free face enforces
zero traction to round-off. All ops are slab reads + ``.at[].set`` writes —
under GSPMD they land only on the edge shards.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from gcm_tpu.task import BorderSpec


def face_index(ax: int, side: int) -> Tuple:
    """Index tuple selecting the boundary slab of a spatial-rank array."""
    return (slice(None),) * ax + (0 if side == 0 else -1,)


def apply_borders_post(
    model,
    u_old: jnp.ndarray,
    u_raw: jnp.ndarray,
    mat,
    axis: int,
    borders,
    active=(True, True),
):
    """Exactly reproduce stage-with-borders from a border-free sweep.

    The pair reconstruction is invertible (w_L = A + s z B, w_R = A − s z B),
    so the characteristic border correction can be applied *after* a raw
    sweep by recomputing the slab invariants from the raw update, replacing
    the incoming one, re-reconstructing, and re-propagating the zero-speed
    invariants at the slab. This is what makes the sweep kernel composable
    with shard_map: interior shards run the raw sweep; only global-edge
    shards apply this fixup, gated by the traced ``active`` flags.

    ``active``: per-side booleans (python or traced); traced flags select
    with jnp.where so the same program serves every shard.
    """
    st = model.stage(axis)
    sign = model.sign
    view = mat.axis_view(axis, st)
    u_new = u_raw
    for side in (0, 1):
        bc = borders.get((axis, side)) if borders else None
        if bc is None:
            continue
        act = active[side]
        if act is False:
            continue
        idx = face_index(axis, side)
        sigma_fixed = {}
        for k, p in enumerate(st.pairs):
            z_b = view.pair_z[k][idx]
            A_b = u_new[p.sigma][idx]
            B_b = u_new[p.vel][idx]
            szb = sign * z_b
            w_l = A_b + szb * B_b
            w_r = A_b - szb * B_b
            val = bc.pair_value(p.traction_axis, st.axis)
            if side == 0:
                out = w_l
                if bc.kind == "absorbing":
                    inc = jnp.zeros_like(out)
                elif bc.kind == "free":
                    inc = -out
                elif bc.kind == "fixed_force":
                    inc = 2.0 * val - out
                elif bc.kind == "fixed_velocity":
                    inc = out - 2.0 * sign * z_b * val
                w_l2, w_r2 = w_l, inc
            else:
                out = w_r
                if bc.kind == "absorbing":
                    inc = jnp.zeros_like(out)
                elif bc.kind == "free":
                    inc = -out
                elif bc.kind == "fixed_force":
                    inc = 2.0 * val - out
                elif bc.kind == "fixed_velocity":
                    inc = out + 2.0 * sign * z_b * val
                w_l2, w_r2 = inc, w_r
            A2 = 0.5 * (w_l2 + w_r2)
            B2 = jnp.where(
                z_b > 0,
                sign * (w_l2 - w_r2) / (2.0 * jnp.maximum(z_b, 1e-30)),
                B_b,
            )
            if act is not True:
                A2 = jnp.where(act, A2, A_b)
                B2 = jnp.where(act, B2, B_b)
            u_new = u_new.at[(p.sigma,) + idx].set(A2)
            u_new = u_new.at[(p.vel,) + idx].set(B2)
            sigma_fixed[p.sigma] = A2
        for j, zc in enumerate(st.zeros):
            if zc.src in sigma_fixed:
                kap = view.zero_kappa[j][idx]
                z_new = u_old[zc.comp][idx] + kap * (
                    sigma_fixed[zc.src] - u_old[zc.src][idx]
                )
                if act is not True:
                    z_new = jnp.where(act, z_new, u_new[zc.comp][idx])
                u_new = u_new.at[(zc.comp,) + idx].set(z_new)
    return u_new


def correct_pair_at_face(
    w_l: jnp.ndarray,
    w_r: jnp.ndarray,
    z: jnp.ndarray,
    sign: int,
    bc: BorderSpec,
    ax: int,
    side: int,
    value: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Overwrite the incoming invariant of one pair on one face."""
    idx = face_index(ax, side)
    z_b = z[idx]
    if side == 0:
        out = w_l[idx]
        if bc.kind == "absorbing":
            inc = jnp.zeros_like(out)
        elif bc.kind == "free":
            inc = -out
        elif bc.kind == "fixed_force":
            inc = 2.0 * value - out
        elif bc.kind == "fixed_velocity":
            inc = out - 2.0 * sign * z_b * value
        else:  # pragma: no cover
            raise ValueError(bc.kind)
        return w_l, w_r.at[idx].set(inc)
    else:
        out = w_r[idx]
        if bc.kind == "absorbing":
            inc = jnp.zeros_like(out)
        elif bc.kind == "free":
            inc = -out
        elif bc.kind == "fixed_force":
            inc = 2.0 * value - out
        elif bc.kind == "fixed_velocity":
            inc = out + 2.0 * sign * z_b * value
        else:  # pragma: no cover
            raise ValueError(bc.kind)
        return w_l.at[idx].set(inc), w_r
