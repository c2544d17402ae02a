"""Declarative characteristic structure of the supported PDE systems.

The governing system is first-order hyperbolic velocity–stress elastodynamics
(SURVEY.md §0.1):  du/dt + A_x du/dx + A_y du/dy + A_z du/dz = 0.

Along any axis ``a`` the isotropic system decouples in closed form
(SURVEY.md §0.2) into:

- a **P pair** ``(sigma_aa, v_a)`` with invariants
  ``w_L = sigma + s*z_p*v`` (speed −c_p, foot at +nu_p cells) and
  ``w_R = sigma − s*z_p*v`` (speed +c_p, foot at −nu_p cells);
- **S pairs** ``(sigma_ab, v_b)`` for each transverse axis b, same algebra
  with (z_s, c_s);
- **zero-speed invariants**: each remaining normal stress obeys
  ``d/dt (sigma_bb − kappa*sigma_aa) = 0`` with
  ``kappa = lambda/(lambda+2mu)``; transverse-transverse shears are frozen.

``sign s`` distinguishes the elastic convention (tension-positive stress,
``v_t = (1/rho) d sigma/da``, s=+1) from the acoustic pressure convention
(``v_t = −(1/rho) dp/da``, s=−1): the invariant/reconstruction algebra is
identical up to this sign, so one generic kernel serves both models.

Reconstruction: ``A = (w_L + w_R)/2``, ``B = s*(w_L − w_R)/(2z)``.

Component ordering (the public state-vector contract, BASELINE.json configs):
- elastic 3D: [vx, vy, vz, sxx, sxy, sxz, syy, syz, szz]  (9)
- elastic 2D: [vx, vy, sxx, sxy, syy]                     (5)
- elastic 1D: [v, sxx]                                    (2)
- acoustic dD: [v_1..v_d, p]                              (d+1)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PairSpec:
    """A coupled (stress-like, velocity) characteristic pair along one axis."""

    sigma: int          # component index of the stress-like variable
    vel: int            # component index of the velocity variable
    wave: str           # 'p' or 's' — selects impedance z and speed c fields
    traction_axis: int  # which spatial axis this traction/velocity acts on
                        # (used to pick BC values from a face's vector data)


@dataclasses.dataclass(frozen=True)
class ZeroSpec:
    """A zero-speed invariant: comp_new = comp + kappa*(src_new − src_old)."""

    comp: int
    src: int


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """The characteristic structure of one dimensional-splitting stage."""

    axis: int
    pairs: Tuple[PairSpec, ...]
    zeros: Tuple[ZeroSpec, ...]


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    dim: int
    ncomp: int
    comp_names: Tuple[str, ...]
    sign: int                      # +1 elastic, −1 acoustic (see module doc)
    stages: Tuple[StageSpec, ...]  # one per axis, index == axis

    @property
    def vel_slice(self) -> slice:
        """Velocity components are always the leading ``dim`` entries."""
        return slice(0, self.dim)

    def comp(self, name: str) -> int:
        return self.comp_names.index(name)

    def stage(self, axis: int) -> StageSpec:
        return self.stages[axis]


_AX = "xyz"


def elastic_model(dim: int) -> Model:
    """Isotropic elastic velocity–stress model in ``dim`` dimensions."""
    if dim == 1:
        comp = ("v", "sxx")
        stages = (StageSpec(0, (PairSpec(1, 0, "p", 0),), ()),)
        return Model("elastic1d", 1, 2, comp, +1, stages)

    vel = tuple(f"v{_AX[i]}" for i in range(dim))
    # stress components in lexicographic (i<=j) row-major upper-triangular order
    sig = tuple(
        f"s{_AX[i]}{_AX[j]}" for i in range(dim) for j in range(i, dim)
    )
    comp = vel + sig
    idx = {n: k for k, n in enumerate(comp)}

    def s(i: int, j: int) -> int:
        i, j = min(i, j), max(i, j)
        return idx[f"s{_AX[i]}{_AX[j]}"]

    stages = []
    for a in range(dim):
        pairs = [PairSpec(s(a, a), idx[f"v{_AX[a]}"], "p", a)]
        for b in range(dim):
            if b != a:
                pairs.append(PairSpec(s(a, b), idx[f"v{_AX[b]}"], "s", b))
        zeros = [ZeroSpec(s(b, b), s(a, a)) for b in range(dim) if b != a]
        stages.append(StageSpec(a, tuple(pairs), tuple(zeros)))
    return Model(f"elastic{dim}d", dim, len(comp), comp, +1, tuple(stages))


def acoustic_model(dim: int) -> Model:
    """Acoustic (pressure–velocity) model in ``dim`` dimensions."""
    vel = tuple(f"v{_AX[i]}" for i in range(dim)) if dim > 1 else ("v",)
    comp = vel + ("p",)
    p = len(comp) - 1
    stages = tuple(
        StageSpec(a, (PairSpec(p, a, "p", a),), ()) for a in range(dim)
    )
    return Model(f"acoustic{dim}d", dim, len(comp), comp, -1, stages)


ELASTIC_1D = elastic_model(1)
ELASTIC_2D = elastic_model(2)
ELASTIC_3D = elastic_model(3)
ACOUSTIC_1D = acoustic_model(1)
ACOUSTIC_2D = acoustic_model(2)
ACOUSTIC_3D = acoustic_model(3)

_REGISTRY = {
    m.name: m
    for m in (ELASTIC_1D, ELASTIC_2D, ELASTIC_3D, ACOUSTIC_1D, ACOUSTIC_2D, ACOUSTIC_3D)
}


def get_model(name: str) -> Model:
    return _REGISTRY[name]


def permuted_model(model: Model, perm: Tuple[int, ...]) -> Model:
    """Model for state arrays stored with spatial dims permuted by ``perm``
    (array dim d holds physical axis perm[d]): the stage LIST is reordered
    so sweeping ARRAY axis d applies physical axis perm[d]'s
    characteristic structure. Component ordering and every StageSpec
    (including its physical ``axis`` field, which border-value lookups
    use) are unchanged.

    This is the engines' opt-in canonical layout: a contact-coupled
    multi-body run moves the contact axis to array dim 0 and steps with
    the permuted model.
    """
    if sorted(perm) != list(range(model.dim)):
        raise ValueError(f"perm {perm} is not a permutation of axes")
    stages = tuple(model.stages[perm[d]] for d in range(model.dim))
    return dataclasses.replace(model, stages=stages)
