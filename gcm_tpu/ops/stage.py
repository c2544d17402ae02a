"""The grid-characteristic stage: one dimensional-splitting sweep, whole-array.

Counterpart of the reference's hot loop
``GridCharacteristicMethod::stage`` (SURVEY.md §2 component 7, §3.2): where
the reference iterates per node doing R^{-1}·u matvecs, 1D interpolation and
R·w back-transforms, here the closed-form pair/zero decomposition
(gcm_tpu.models.spec) turns the whole stage into a handful of fused
elementwise ops + static edge-clamped shifts over the full field arrays —
one pass, no gathers. This jnp formulation is the semantics of record;
gcm_tpu.ops.hopper_step runs the same numerics as one CUDA pass per step.

Material quantities arrive as a per-axis ``AxisView`` (materials.axis_view):
per-pair wave-speed and impedance fields and per-zero coupling ratios —
the single generalization point that serves isotropic and orthotropic media
with the same sweep code.

State layout: ``u[ncomp, *spatial]`` float32/float64, material fields
``[*spatial]`` (struct-of-arrays, SURVEY.md §2 component 6).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import jax.numpy as jnp

from gcm_tpu.materials import AxisView
from gcm_tpu.models.spec import Model, PairSpec
from gcm_tpu.ops.interp import (
    edge_pad, interp_at_foot, interp_padded, stencil_radius, stencil_weights,
)

_Z_EPS = 1e-30

#: 'pad' = pad-once/slice-many (fewer materializations, default);
#: 'concat' = per-shift slice+concat. Both are numerically identical —
#: the switch exists because compiler behavior can differ per backend.
_INTERP_IMPL = os.environ.get("GCM_TPU_INTERP", "pad")


def pair_invariants_at_feet(
    A, B, z, nu, sign: int, order: int, ax: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """New values of the two Riemann invariants of a pair, at every node.

    ``w_L = A + s z B`` rides speed −c (foot at +nu cells);
    ``w_R = A − s z B`` rides speed +c (foot at −nu cells).
    ``z``/``nu`` are node-local (frozen-coefficient GCM, SURVEY.md §0.2), so
    invariants are formed with the *target node's* impedance applied to the
    interpolated neighbor fields.
    """
    if _INTERP_IMPL == "concat":
        A_p = interp_at_foot(A, nu, +1, order, ax)
        B_p = interp_at_foot(B, nu, +1, order, ax)
        A_m = interp_at_foot(A, nu, -1, order, ax)
        B_m = interp_at_foot(B, nu, -1, order, ax)
    else:
        r = stencil_radius(order)
        n = A.shape[ax]
        A_pad = edge_pad(A, ax, r)
        B_pad = edge_pad(B, ax, r)
        wts = stencil_weights(order, nu)  # direction-independent (offsets
        # are direction-relative), so one weight set serves both feet
        A_p = interp_padded(A_pad, wts, +1, order, ax, r, n)
        B_p = interp_padded(B_pad, wts, +1, order, ax, r, n)
        A_m = interp_padded(A_pad, wts, -1, order, ax, r, n)
        B_m = interp_padded(B_pad, wts, -1, order, ax, r, n)
    szb = sign * z
    w_l = A_p + szb * B_p
    w_r = A_m - szb * B_m
    return w_l, w_r


def reconstruct_pair(w_l, w_r, z, B_old, sign: int):
    """Invert the pair transform: (w_L, w_R) → (A, B).

    Degenerate impedance (z == 0, e.g. S pairs inside an acoustic/fluid
    region of an elastic run) means the pair does not propagate: keep B.
    """
    A = 0.5 * (w_l + w_r)
    B_prop = sign * (w_l - w_r) / (2.0 * jnp.maximum(z, _Z_EPS))
    B = jnp.where(z > 0, B_prop, B_old)
    return A, B


def stage_pair_updates(
    model: Model,
    u: jnp.ndarray,
    view: AxisView,
    dt_over_h,
    axis: int,
    order: int,
    dim_axis: int = None,
) -> Dict[int, Tuple[jnp.ndarray, jnp.ndarray, PairSpec]]:
    """Compute raw (pre-boundary-correction) invariant updates for each pair.

    Returns ``{pair_index: (w_l, w_r, pair_spec)}`` so the caller can apply
    characteristic boundary / contact corrections in invariant space before
    reconstruction (SURVEY.md §0.4).

    ``dim_axis``: spatial array dimension the sweep runs along, when it
    differs from the PHYSICAL ``axis`` (permuted slab layouts — contact
    fixups move thin slab axes to the front; see
    solver.multi.apply_contact_fixups).
    """
    ax = dim_axis if dim_axis is not None else axis
    out = {}
    for k, p in enumerate(model.stage(axis).pairs):
        A, B = u[p.sigma], u[p.vel]
        z = view.pair_z[k]
        nu = view.pair_c[k] * dt_over_h
        w_l, w_r = pair_invariants_at_feet(A, B, z, nu, model.sign, order, ax)
        out[k] = (w_l, w_r, p)
    return out


def apply_zero_invariants(
    model: Model,
    u_old: jnp.ndarray,
    comps: Dict[int, jnp.ndarray],
    view: AxisView,
    axis: int,
) -> None:
    """Update zero-speed invariants in ``comps`` (in place on the dict).

    Each transverse normal stress obeys d/dt(sigma_bb − kappa*sigma_aa) = 0
    along this sweep, so ``sigma_bb += kappa * (sigma_aa_new − sigma_aa_old)``
    using the *final* (post-BC) sigma_aa. Untouched components (e.g. the
    transverse shear in 3D) carry over implicitly.
    """
    for j, zc in enumerate(model.stage(axis).zeros):
        d_src = comps[zc.src] - u_old[zc.src]
        comps[zc.comp] = u_old[zc.comp] + view.zero_kappa[j] * d_src
