"""Material models and per-node material fields.

Counterpart of the reference's ``IsotropicMaterial`` /
``OrthotropicMaterial`` (SURVEY.md §2 component 2; BASELINE.json: "material
model (Lame parameters, density)"). Heterogeneous media are represented as
device-resident per-node arrays of the *derived* characteristic quantities the
stage kernel actually consumes — wave speeds, impedances, and the
zero-invariant coupling ratio — so the hot kernel does no divisions/sqrt.

All quantities are SI: rho [kg/m^3], lambda/mu [Pa], speeds [m/s].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class IsotropicMaterial:
    """Linear isotropic elastic material (rho, Lame lambda, mu).

    For acoustic media set ``mu = 0`` (then ``c_p = sqrt(lambda/rho)`` is the
    sound speed and ``lambda`` is the bulk modulus K).
    """

    rho: float
    lam: float
    mu: float = 0.0

    @staticmethod
    def from_speeds(rho: float, cp: float, cs: float = 0.0) -> "IsotropicMaterial":
        mu = rho * cs * cs
        lam = rho * cp * cp - 2.0 * mu
        return IsotropicMaterial(rho=rho, lam=lam, mu=mu)

    @property
    def cp(self) -> float:
        return math.sqrt((self.lam + 2.0 * self.mu) / self.rho)

    @property
    def cs(self) -> float:
        return math.sqrt(self.mu / self.rho)


@dataclasses.dataclass(frozen=True)
class OrthotropicMaterial:
    """Orthotropic elastic material (rho + 9 stiffness constants c_ij).

    Counterpart of the reference's OrthotropicMaterial (SURVEY.md §2
    component 2). The per-axis characteristic decomposition is closed-form
    (P speed sqrt(c_aa/rho) along axis a, shear speeds sqrt(c_44..66/rho));
    it is fully supported in the structured sweeps, in
    contact solves and on simplex meshes via ``OrthotropicMaterialFields``.
    """

    rho: float
    c11: float
    c12: float
    c13: float
    c22: float
    c23: float
    c33: float
    c44: float  # yz shear
    c55: float  # xz shear
    c66: float  # xy shear

    @staticmethod
    def from_isotropic(m: "IsotropicMaterial") -> "OrthotropicMaterial":
        """Isotropic limit: c_ii = lam+2mu, off-diagonals = lam, shears = mu."""
        d, o, s = m.lam + 2.0 * m.mu, m.lam, m.mu
        return OrthotropicMaterial(rho=m.rho, c11=d, c12=o, c13=o,
                                   c22=d, c23=o, c33=d, c44=s, c55=s, c66=s)

    def constants(self) -> dict:
        """The 9 stiffnesses as a {name: value} dict (from_constants input)."""
        return {k: getattr(self, k)
                for k in ("c11", "c12", "c13", "c22", "c23", "c33",
                          "c44", "c55", "c66")}


@dataclasses.dataclass
class MaterialFields:
    """Per-node derived characteristic fields (struct-of-arrays pytree).

    Every array has the spatial shape of the grid. These are the only
    material quantities the stage kernels read:

    - ``cp``, ``cs``  : P/S wave speeds (cs == 0 for acoustic media)
    - ``zp``, ``zs``  : acoustic impedances rho*cp, rho*cs
    - ``kappa``       : lambda/(lambda+2mu) — couples the zero-speed stress
                        invariants to the P update (SURVEY.md §0.2)
    - ``rho``         : kept for sources/diagnostics
    """

    cp: Any
    cs: Any
    zp: Any
    zs: Any
    kappa: Any
    rho: Any

    @staticmethod
    def from_arrays(rho, lam, mu, xp=np, dtype=None) -> "MaterialFields":
        """Build derived fields from rho/lambda/mu arrays (any array lib)."""
        dtype = dtype or xp.float32
        rho = xp.asarray(rho, dtype=dtype)
        lam = xp.asarray(lam, dtype=dtype)
        mu = xp.asarray(mu, dtype=dtype)
        m2 = lam + 2.0 * mu
        cp = xp.sqrt(m2 / rho)
        cs = xp.sqrt(mu / rho)
        return MaterialFields(
            cp=cp,
            cs=cs,
            zp=rho * cp,
            zs=rho * cs,
            kappa=lam / m2,
            rho=rho,
        )

    @staticmethod
    def uniform(material: IsotropicMaterial, shape, xp=np, dtype=None) -> "MaterialFields":
        ones = xp.ones(shape, dtype=dtype or xp.float32)
        return MaterialFields.from_arrays(
            material.rho * ones, material.lam * ones, material.mu * ones,
            xp=xp, dtype=dtype,
        )

    def max_cp(self) -> float:
        return float(self.cp.max())

    def z(self, wave: str):
        return {"p": self.zp, "s": self.zs}[wave]

    def c(self, wave: str):
        return {"p": self.cp, "s": self.cs}[wave]

    def axis_view(self, axis: int, stage_spec) -> "AxisView":
        """Per-sweep-axis characteristic fields (isotropic: axis-independent)."""
        pc = [self.c(p.wave) for p in stage_spec.pairs]
        pz = [self.z(p.wave) for p in stage_spec.pairs]
        zk = [self.kappa for _ in stage_spec.zeros]
        return AxisView(pair_c=pc, pair_z=pz, zero_kappa=zk)


@dataclasses.dataclass
class AxisView:
    """Characteristic quantities of one dimensional-splitting sweep:
    per-pair wave speed and impedance fields, per-zero coupling ratios.

    This is the generalization point for anisotropy: isotropic media give
    the same (cp, zp)/(cs, zs) on every axis, orthotropic media give
    axis-dependent speeds (sqrt(c_aa/rho) for the P pair, sqrt(c_66/rho)
    etc. for each shear pair) and per-zero kappas (c_ab/c_aa).
    """

    pair_c: Any
    pair_z: Any
    zero_kappa: Any


@dataclasses.dataclass
class OrthotropicMaterialFields:
    """Per-node orthotropic characteristic fields (SURVEY.md §2 comp. 2).

    Stores rho and the 9 stiffness arrays; ``axis_view`` produces the
    closed-form per-axis decomposition quantities consumed by the same
    generic sweep machinery as the isotropic path. Orthotropy is supported
    in structured sweeps, contact solves and simplex-mesh
    sweeps (tests/test_orthotropic.py, test_contact.py, test_simplex.py).
    """

    rho: Any
    c11: Any; c12: Any; c13: Any          # noqa: E702
    c22: Any; c23: Any; c33: Any          # noqa: E702
    c44: Any; c55: Any; c66: Any          # noqa: E702

    @staticmethod
    def from_constants(rho, c, xp=np, dtype=None) -> "OrthotropicMaterialFields":
        """``c``: dict with keys c11..c66 of scalars or arrays."""
        dtype = dtype or xp.float32
        conv = lambda a: xp.asarray(a, dtype=dtype)
        return OrthotropicMaterialFields(
            rho=conv(rho),
            c11=conv(c["c11"]), c12=conv(c["c12"]), c13=conv(c["c13"]),
            c22=conv(c["c22"]), c23=conv(c["c23"]), c33=conv(c["c33"]),
            c44=conv(c["c44"]), c55=conv(c["c55"]), c66=conv(c["c66"]),
        )

    def _diag(self, axis: int):
        return (self.c11, self.c22, self.c33)[axis]

    def _shear(self, a: int, b: int):
        a, b = min(a, b), max(a, b)
        return {(1, 2): self.c44, (0, 2): self.c55, (0, 1): self.c66}[(a, b)]

    def _offdiag(self, a: int, b: int):
        a, b = min(a, b), max(a, b)
        return {(0, 1): self.c12, (0, 2): self.c13, (1, 2): self.c23}[(a, b)]

    def max_cp(self) -> float:
        """Largest characteristic speed of any pair on any sweep axis.

        The CFL step uses this; shear stiffnesses are included because a
        positive-definite orthotropic tensor may have c44/c55/c66 exceeding
        a diagonal stiffness, which would otherwise make dt unstable.
        """
        import numpy as _np

        return float(max(
            _np.sqrt(_np.max(_np.asarray(c) / _np.asarray(self.rho)))
            for c in (self.c11, self.c22, self.c33,
                      self.c44, self.c55, self.c66)
        ))

    def axis_view(self, axis: int, stage_spec) -> AxisView:
        import jax.numpy as jnp

        def spd(stiff):
            return jnp.sqrt(stiff / self.rho)

        pc, pz = [], []
        for p in stage_spec.pairs:
            if p.traction_axis == axis:          # P pair along this axis
                stiff = self._diag(axis)
            else:                                 # shear pair
                stiff = self._shear(axis, p.traction_axis)
            c = spd(stiff)
            pc.append(c)
            pz.append(self.rho * c)
        # zero invariants: sigma_bb_t = c_{ab} dv_a/da during the a-sweep,
        # so sigma_bb − (c_ab/c_aa) sigma_aa is frozen
        zk = []
        for zc in stage_spec.zeros:
            b = _DIAG_AXIS_OF_COMP[zc.comp]
            zk.append(self._offdiag(axis, b) / self._diag(axis))
        return AxisView(pair_c=pc, pair_z=pz, zero_kappa=zk)


#: diagonal-stress component index -> its axis, for the 3D/2D elastic models
#: (elastic3d: sxx=3, syy=6, szz=8; elastic2d: sxx=2, syy=4) — validated in
#: tests against models.spec orderings.
_DIAG_AXIS_OF_COMP = {3: 0, 6: 1, 8: 2, 2: 0, 4: 1}


def _register_pytree() -> None:
    import jax

    jax.tree_util.register_pytree_node(
        MaterialFields,
        lambda m: ((m.cp, m.cs, m.zp, m.zs, m.kappa, m.rho), None),
        lambda _, leaves: MaterialFields(*leaves),
    )
    ortho_fields = [f.name for f in dataclasses.fields(OrthotropicMaterialFields)]
    jax.tree_util.register_pytree_node(
        OrthotropicMaterialFields,
        lambda m: (tuple(getattr(m, f) for f in ortho_fields), None),
        lambda _, leaves: OrthotropicMaterialFields(*leaves),
    )


_register_pytree()
