"""Scenario configuration — the analogue of the reference ``Task``.

The reference describes a whole simulation as one plain struct tree: grid
geometry, materials-by-area, initial conditions-by-area, border conditions
per face, time/CFL and snapshot settings (SURVEY.md §2 component 14).
Here the same role is played by typed dataclasses; ``Area`` shapes rasterize
to boolean masks host-side (numpy) at engine build time, so nothing dynamic
reaches the jitted step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from gcm_tpu.materials import IsotropicMaterial, OrthotropicMaterial

AnyMaterial = Union[IsotropicMaterial, OrthotropicMaterial]

Axis = int          # 0, 1, 2
Side = int          # 0 = low face, 1 = high face
Face = Tuple[Axis, Side]


# ---------------------------------------------------------------- geometry

@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Uniform structured (cubic) grid: shape, spacing and origin per axis.

    The grid itself is implicit — array shape + metadata (SURVEY.md §2
    component 4); node coordinates are ``origin + index * h``.
    """

    shape: Tuple[int, ...]
    h: Tuple[float, ...]
    origin: Tuple[float, ...] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.origin is None:
            object.__setattr__(self, "origin", (0.0,) * len(self.shape))
        if not (len(self.shape) == len(self.h) == len(self.origin)):
            raise ValueError("GridSpec shape/h/origin rank mismatch")

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def lengths(self) -> Tuple[float, ...]:
        return tuple((n - 1) * h for n, h in zip(self.shape, self.h))

    def coords(self) -> List[np.ndarray]:
        """Per-axis 1D node coordinate arrays."""
        return [
            self.origin[a] + self.h[a] * np.arange(self.shape[a], dtype=np.float64)
            for a in range(self.dim)
        ]

    def meshgrid(self) -> List[np.ndarray]:
        return list(np.meshgrid(*self.coords(), indexing="ij"))

    def index_of(self, point: Sequence[float]) -> Tuple[int, ...]:
        """Nearest node index of a physical point (for detectors/sources)."""
        idx = []
        for a in range(self.dim):
            i = int(round((point[a] - self.origin[a]) / self.h[a]))
            idx.append(min(max(i, 0), self.shape[a] - 1))
        return tuple(idx)


# ---------------------------------------------------------------- areas

class Area:
    """A spatial region; rasterizes to a node mask on a structured grid
    (``mask``) or on an arbitrary point cloud (``contains`` — used for
    simplex-mesh node selection, e.g. per-area border conditions).

    Subclasses implement ``contains``; ``mask`` has a generic default
    (rasterize the grid's nodes through ``contains``). Combine areas with
    ``|`` (union), ``&`` (intersection) and ``~`` (complement).
    """

    def mask(self, grid: GridSpec) -> np.ndarray:
        pts = np.stack([g.ravel() for g in grid.meshgrid()], axis=-1)
        return self.contains(pts).reshape(grid.shape)

    def contains(self, points: np.ndarray) -> np.ndarray:
        """Boolean mask over ``points [N, dim]``."""
        raise NotImplementedError

    def __or__(self, other: "Area") -> "Area":
        return AreaUnion((self, other))

    def __and__(self, other: "Area") -> "Area":
        return AreaIntersection((self, other))

    def __invert__(self) -> "Area":
        return AreaNot(self)


@dataclasses.dataclass(frozen=True)
class AreaAll(Area):
    def mask(self, grid: GridSpec) -> np.ndarray:
        return np.ones(grid.shape, dtype=bool)

    def contains(self, points: np.ndarray) -> np.ndarray:
        return np.ones(len(points), dtype=bool)


@dataclasses.dataclass(frozen=True)
class AreaBox(Area):
    lo: Tuple[float, ...]
    hi: Tuple[float, ...]

    def mask(self, grid: GridSpec) -> np.ndarray:
        xs = grid.meshgrid()
        m = np.ones(grid.shape, dtype=bool)
        for a, x in enumerate(xs):
            m &= (x >= self.lo[a]) & (x <= self.hi[a])
        return m

    def contains(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points)
        lo = np.asarray(self.lo)
        hi = np.asarray(self.hi)
        return ((points >= lo) & (points <= hi)).all(axis=1)


@dataclasses.dataclass(frozen=True)
class AreaBall(Area):
    center: Tuple[float, ...]
    radius: float

    def mask(self, grid: GridSpec) -> np.ndarray:
        xs = grid.meshgrid()
        r2 = sum((x - c) ** 2 for x, c in zip(xs, self.center))
        return r2 <= self.radius ** 2

    def contains(self, points: np.ndarray) -> np.ndarray:
        d2 = ((np.asarray(points) - np.asarray(self.center)) ** 2).sum(axis=1)
        return d2 <= self.radius ** 2


@dataclasses.dataclass(frozen=True)
class AreaLayer(Area):
    """Half-open slab ``lo <= x_axis <= hi`` — for layered seismic models."""

    axis: int
    lo: float
    hi: float

    def mask(self, grid: GridSpec) -> np.ndarray:
        x = grid.meshgrid()[self.axis]
        return (x >= self.lo) & (x <= self.hi)

    def contains(self, points: np.ndarray) -> np.ndarray:
        x = np.asarray(points)[:, self.axis]
        return (x >= self.lo) & (x <= self.hi)


@dataclasses.dataclass(frozen=True)
class AreaCylinder(Area):
    """Axis-aligned cylinder: distance to the axis line <= radius, with an
    optional extent [lo, hi] along the axis (reference "Area shapes",
    SURVEY.md §2 component 14)."""

    axis: int
    center: Tuple[float, ...]      # the axis-coordinate entry is ignored
    radius: float
    lo: float = -np.inf
    hi: float = np.inf

    def contains(self, points: np.ndarray) -> np.ndarray:
        pts = np.asarray(points)
        d2 = np.zeros(len(pts))
        for a in range(pts.shape[1]):
            if a != self.axis:
                d2 += (pts[:, a] - self.center[a]) ** 2
        x = pts[:, self.axis]
        return (d2 <= self.radius ** 2) & (x >= self.lo) & (x <= self.hi)


@dataclasses.dataclass(frozen=True)
class AreaHalfSpace(Area):
    """The half-space ``normal . (x - point) <= 0`` (oblique layers,
    dipping interfaces)."""

    point: Tuple[float, ...]
    normal: Tuple[float, ...]

    def contains(self, points: np.ndarray) -> np.ndarray:
        rel = np.asarray(points) - np.asarray(self.point)
        return rel @ np.asarray(self.normal) <= 0.0


@dataclasses.dataclass(frozen=True)
class AreaUnion(Area):
    areas: Tuple[Area, ...]

    def contains(self, points: np.ndarray) -> np.ndarray:
        m = self.areas[0].contains(points)
        for a in self.areas[1:]:
            m = m | a.contains(points)
        return m


@dataclasses.dataclass(frozen=True)
class AreaIntersection(Area):
    areas: Tuple[Area, ...]

    def contains(self, points: np.ndarray) -> np.ndarray:
        m = self.areas[0].contains(points)
        for a in self.areas[1:]:
            m = m & a.contains(points)
        return m


@dataclasses.dataclass(frozen=True)
class AreaNot(Area):
    area: Area

    def contains(self, points: np.ndarray) -> np.ndarray:
        return ~self.area.contains(points)


# ---------------------------------------------------------------- conditions

#: characteristic border-condition kinds (SURVEY.md §0.4)
BORDER_KINDS = ("absorbing", "free", "fixed_force", "fixed_velocity")


@dataclasses.dataclass(frozen=True)
class BorderSpec:
    """Border condition on one face.

    ``value``: for fixed_force/fixed_velocity — either a scalar (applied to
    the normal P pair; S pairs get 0) or a per-spatial-axis vector indexed by
    each pair's ``traction_axis``.
    """

    kind: str = "absorbing"
    value: Union[None, float, Tuple[float, ...]] = None

    def __post_init__(self):
        if self.kind not in BORDER_KINDS:
            raise ValueError(f"unknown border kind {self.kind!r}")

    def pair_value(self, traction_axis: int, normal_axis: int) -> float:
        if self.value is None:
            return 0.0
        if isinstance(self.value, (int, float)):
            return float(self.value) if traction_axis == normal_axis else 0.0
        return float(self.value[traction_axis])


@dataclasses.dataclass(frozen=True)
class MaterialRegion:
    area: Area
    material: AnyMaterial


@dataclasses.dataclass(frozen=True)
class InitialCondition:
    """Set state components inside an area: {component name: value}.

    A value may be a float (constant over the area) or a callable
    ``f(X1, .., Xd) -> array`` of the node coordinate meshgrids (function
    initial conditions: plane waves, Gaussian wave packets, arbitrary
    profiles — reference ICs-by-Area, SURVEY.md §2 component 14).
    """

    area: Area
    values: Dict[str, Union[float, Callable]]


def plane_wave_initial(
    model_name: str,
    material,
    axis: int,
    direction: int,
    profile: Callable,
    wave: str = "p",
    area: Optional[Area] = None,
) -> InitialCondition:
    """A traveling plane-wave initial condition.

    ``profile(x_axis)`` is the stress amplitude along the propagation
    axis; ``direction`` = ±1 is the travel direction; ``wave`` = 'p'
    (compressional: sigma_aa + v_a) or 's' (shear: sigma_ab + v_b with b
    the next transverse axis). Exactly one characteristic invariant is
    loaded, so the pulse travels one way at the wave speed.
    """
    from gcm_tpu.models.spec import get_model

    model = get_model(model_name)
    ax_names = "xyz"[:model.dim]
    a = ax_names[axis]
    if wave == "p":
        z = material.rho * material.cp
        sig = f"s{a}{a}" if model.name.startswith("elastic") else "p"
        vel = f"v{a}" if model.dim > 1 else "v"
    else:
        b = ax_names[(axis + 1) % model.dim]
        z = material.rho * material.cs
        lo, hi = sorted((a, b))
        sig = f"s{lo}{hi}"
        vel = f"v{b}"
    sgn = -float(direction) * model.sign

    def sig_fn(*X):
        return profile(X[axis])

    def vel_fn(*X):
        return sgn * profile(X[axis]) / z

    return InitialCondition(area or AreaAll(),
                            values={sig: sig_fn, vel: vel_fn})


@dataclasses.dataclass(frozen=True)
class WaveletSource:
    """Point source with an arbitrary time function ``fn(t) -> amplitude``
    (vectorized over t). The generic form of RickerSource — any source
    signature the reference's explosion-type loads express."""

    position: Tuple[float, ...]
    components: Tuple[str, ...]
    fn: Callable
    amplitude: float = 1.0

    def wavelet(self, t):
        out = self.amplitude * np.asarray(self.fn(np.asarray(t, np.float64)))
        return float(out) if out.ndim == 0 else out


@dataclasses.dataclass(frozen=True)
class RickerSource:
    """Point source with a Ricker wavelet time function.

    Injected additively into the listed components at the node nearest to
    ``position`` each step: ``amp * ricker(t − t0; f0) * dt``. An isotropic
    moment (explosion, BASELINE.json config 4) targets all normal stresses.
    """

    position: Tuple[float, ...]
    components: Tuple[str, ...]
    f0: float
    t0: float
    amplitude: float = 1.0

    def wavelet(self, t):
        """Ricker amplitude at time(s) ``t`` — scalar in, scalar out;
        array in, array out (engines evaluate all steps in one call)."""
        import numpy as _np

        a = (_np.pi * self.f0 * (_np.asarray(t, _np.float64) - self.t0)) ** 2
        out = self.amplitude * (1.0 - 2.0 * a) * _np.exp(-a)
        return float(out) if out.ndim == 0 else out


def apply_initial(u0: np.ndarray, model, grid: GridSpec,
                  initial) -> np.ndarray:
    """Rasterize InitialConditions into the state array ``u0`` (in place).

    Constant values fill the area; callable values are evaluated on the
    node coordinate meshgrids and masked to the area.
    """
    X = None
    for ic in initial:
        msk = ic.area.mask(grid)
        for name, val in ic.values.items():
            if callable(val):
                if X is None:
                    X = grid.meshgrid()
                field = np.broadcast_to(
                    np.asarray(val(*X), np.float64), grid.shape)
                u0[model.comp(name)][msk] = field[msk]
            else:
                u0[model.comp(name)][msk] = val
    return u0


@dataclasses.dataclass(frozen=True)
class TimeSpec:
    cfl: float = 0.9
    nsteps: Optional[int] = None
    t_end: Optional[float] = None

    def steps_for(self, dt: float) -> int:
        if self.nsteps is not None:
            return self.nsteps
        if self.t_end is not None:
            return int(np.ceil(self.t_end / dt))
        raise ValueError("TimeSpec needs nsteps or t_end")


@dataclasses.dataclass(frozen=True)
class SnapshotSpec:
    every: int = 0                    # 0 = disabled
    directory: str = "snapshots"
    fields: Tuple[str, ...] = ()      # () = all components


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """Receiver points whose state is recorded every step (seismograms)."""

    points: Tuple[Tuple[float, ...], ...]
    components: Tuple[str, ...] = ()  # () = all


# ---------------------------------------------------------------- task

#: accepted ``kernel`` values of Task and SimplexTask
KERNELS = ("auto", "jnp")


def check_kernel(kernel: str) -> str:
    """Validate a ``kernel`` choice; unknown names (including those of
    kernels that no longer exist) raise, listing the accepted values."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; accepted values: "
                         + ", ".join(KERNELS))
    return kernel

@dataclasses.dataclass(frozen=True)
class Task:
    """One body: grid + model + materials + ICs/BCs + time + outputs."""

    name: str
    model: str                         # gcm_tpu.models.get_model key
    grid: GridSpec
    default_material: AnyMaterial
    materials: Tuple[MaterialRegion, ...] = ()
    initial: Tuple[InitialCondition, ...] = ()
    borders: Dict[Face, BorderSpec] = dataclasses.field(default_factory=dict)
    sources: Tuple[RickerSource, ...] = ()
    time: TimeSpec = TimeSpec()
    order: int = 2                     # characteristic interpolation order
    snapshots: SnapshotSpec = SnapshotSpec()
    detectors: Optional[DetectorSpec] = None
    symmetrize_stages: bool = True     # reverse axis order on odd steps
    correctors: Tuple = ()             # ODE correctors (solver.correctors)
    #: compute path: "auto" takes the one-pass Hopper step kernel when
    #: compute lands on a GPU and the task qualifies
    #: (gcm_tpu.ops.hopper_step.eligible), the jnp sweeps otherwise;
    #: "jnp" pins the jnp sweeps (the semantics of record)
    kernel: str = "auto"
    scan_unroll: int = 1               # steps-loop unroll inside the jitted scan
    #: store state in a permuted (canonical) layout whose LAST dimension is
    #: 128-aligned (e.g. 256x256x64 -> stored 256x64x256). Opt-in because
    #: the dimensional-splitting axis order follows storage (an equally
    #: valid symmetrized pair, but numerically a different splitting than
    #: the default x,y,z/z,y,x). Inputs and every output (results,
    #: snapshots, checkpoints, detectors) stay in task layout.
    canonical_layout: bool = False

    def __post_init__(self):
        check_kernel(self.kernel)

    def border(self, axis: int, side: int) -> BorderSpec:
        return self.borders.get((axis, side), BorderSpec("absorbing"))

    @property
    def is_orthotropic(self) -> bool:
        mats = (self.default_material,) + tuple(r.material for r in self.materials)
        return any(isinstance(m, OrthotropicMaterial) for m in mats)

    def material_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rasterize material regions into (rho, lam, mu) node arrays."""
        shape = self.grid.shape
        m0 = self.default_material
        rho = np.full(shape, m0.rho, dtype=np.float32)
        lam = np.full(shape, m0.lam, dtype=np.float32)
        mu = np.full(shape, m0.mu, dtype=np.float32)
        for region in self.materials:
            msk = region.area.mask(self.grid)
            rho[msk] = region.material.rho
            lam[msk] = region.material.lam
            mu[msk] = region.material.mu
        return rho, lam, mu

    def material_fields(self, xp=np, dtype=None):
        """Rasterize regions into per-node derived characteristic fields.

        Returns ``MaterialFields`` when every material is isotropic, else
        ``OrthotropicMaterialFields`` (isotropic regions embed via their
        orthotropic limit) — both expose the ``axis_view``/``max_cp``
        protocol the sweeps consume.
        """
        from gcm_tpu.materials import MaterialFields, OrthotropicMaterialFields

        if not self.is_orthotropic:
            rho, lam, mu = self.material_arrays()
            return MaterialFields.from_arrays(rho, lam, mu, xp=xp, dtype=dtype)

        shape = self.grid.shape

        def as_ortho(m: AnyMaterial) -> OrthotropicMaterial:
            if isinstance(m, OrthotropicMaterial):
                return m
            return OrthotropicMaterial.from_isotropic(m)

        m0 = as_ortho(self.default_material)
        rho = np.full(shape, m0.rho, dtype=np.float64)
        cons = {k: np.full(shape, v, dtype=np.float64)
                for k, v in m0.constants().items()}
        for region in self.materials:
            msk = region.area.mask(self.grid)
            mo = as_ortho(region.material)
            rho[msk] = mo.rho
            for k, v in mo.constants().items():
                cons[k][msk] = v
        return OrthotropicMaterialFields.from_constants(rho, cons, xp=xp,
                                                        dtype=dtype)


# ---------------------------------------------------------------- simplex task

@dataclasses.dataclass(frozen=True)
class SimplexTask:
    """One body on an unstructured simplex mesh — the SAME scenario schema
    as :class:`Task` (materials/ICs/BCs by Area, sources, detectors, time,
    snapshot cadence, ODE correctors) with the implicit cubic grid replaced
    by an explicit :class:`~gcm_tpu.grids.simplex.SimplexGrid`.

    The reference's Task describes a whole scenario on ANY grid type
    (SURVEY.md §1 Config row, §2 component 14); this closes the round-2 gap
    where simplex scenarios had to be hand-wired with a single constant
    material. Areas rasterize through ``Area.contains`` on the node cloud
    (materials, ICs) and on hull nodes (per-area border conditions).
    """

    name: str
    model: str                          # gcm_tpu.models.get_model key
    grid: "object"                      # SimplexGrid (kept untyped: no import cycle)
    default_material: AnyMaterial
    materials: Tuple[MaterialRegion, ...] = ()
    initial: Tuple[InitialCondition, ...] = ()
    border_default: BorderSpec = dataclasses.field(
        default_factory=lambda: BorderSpec("absorbing"))
    borders: Tuple[Tuple[Area, BorderSpec], ...] = ()
    sources: Tuple = ()
    time: TimeSpec = TimeSpec()
    snapshots: SnapshotSpec = SnapshotSpec()
    detectors: Optional[DetectorSpec] = None
    correctors: Tuple = ()              # ODE correctors (solver.correctors)
    #: characteristic interpolation order: 1 = barycentric over the
    #: containing cell, 2 = least-squares quadratic reconstruction tables
    order: int = 1
    #: compute path: "auto" or "jnp" — both run the jnp roll/gather sweeps
    kernel: str = "auto"

    def __post_init__(self):
        check_kernel(self.kernel)

    @property
    def is_orthotropic(self) -> bool:
        mats = (self.default_material,) + tuple(
            r.material for r in self.materials)
        return any(isinstance(m, OrthotropicMaterial) for m in mats)

    def material_fields(self, xp=np, dtype=None):
        """Rasterize regions into per-node fields over the mesh nodes.

        The solver side is fully per-node-capable (foot tables take
        per-node speeds, grids/simplex.py); this supplies the
        heterogeneous-media plumbing (VERDICT r2 missing #1)."""
        from gcm_tpu.materials import MaterialFields, OrthotropicMaterialFields

        pts = np.asarray(self.grid.points)
        n = len(pts)
        if not self.is_orthotropic:
            m0 = self.default_material
            rho = np.full(n, m0.rho, dtype=np.float64)
            lam = np.full(n, m0.lam, dtype=np.float64)
            mu = np.full(n, m0.mu, dtype=np.float64)
            for region in self.materials:
                msk = region.area.contains(pts)
                rho[msk] = region.material.rho
                lam[msk] = region.material.lam
                mu[msk] = region.material.mu
            return MaterialFields.from_arrays(rho, lam, mu, xp=xp, dtype=dtype)

        def as_ortho(m: AnyMaterial) -> OrthotropicMaterial:
            if isinstance(m, OrthotropicMaterial):
                return m
            return OrthotropicMaterial.from_isotropic(m)

        m0 = as_ortho(self.default_material)
        rho = np.full(n, m0.rho, dtype=np.float64)
        cons = {k: np.full(n, v, dtype=np.float64)
                for k, v in m0.constants().items()}
        for region in self.materials:
            msk = region.area.contains(pts)
            mo = as_ortho(region.material)
            rho[msk] = mo.rho
            for k, v in mo.constants().items():
                cons[k][msk] = v
        return OrthotropicMaterialFields.from_constants(rho, cons, xp=xp,
                                                        dtype=dtype)

    def initial_state(self, model) -> np.ndarray:
        """Rasterize InitialConditions into a fresh ``u0 [ncomp, N]``.

        Callable values receive the per-node coordinate arrays
        ``(X_1, .., X_d)`` — the same signature as on structured grids,
        where they receive the coordinate meshgrids."""
        pts = np.asarray(self.grid.points)
        u0 = np.zeros((model.ncomp, len(pts)), dtype=np.float64)
        cols = tuple(pts[:, a] for a in range(pts.shape[1]))
        for ic in self.initial:
            msk = ic.area.contains(pts)
            for name, val in ic.values.items():
                if callable(val):
                    field = np.broadcast_to(
                        np.asarray(val(*cols), np.float64), (len(pts),))
                    u0[model.comp(name)][msk] = field[msk]
                else:
                    u0[model.comp(name)][msk] = val
        return u0
