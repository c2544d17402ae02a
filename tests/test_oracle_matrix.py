"""The jnp step against the per-node NumPy oracle over the configuration grid.

dimension {2, 3} x order {1..4} x border kind on every face x splitting
axis order (forward, reversed) x medium (isotropic, orthotropic), one full
step on tiny heterogeneous grids. The jnp step is the semantics of record
every compute path is checked against, so this grid is what anchors them.

The orthotropic medium is the isotropic limit of the orthotropic stiffness
tensor, node by node: the closed-form orthotropic pairs
(OrthotropicMaterialFields.axis_view) must then reproduce the isotropic
oracle, border corrections included (gcm_tpu.oracle.oracle_ortho has no
borders; tests/test_oracle_ortho.py covers true anisotropy in the
interior).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gcm_tpu.materials import MaterialFields, OrthotropicMaterialFields
from gcm_tpu.models.spec import get_model
from gcm_tpu.oracle.oracle import oracle_step
from gcm_tpu.solver.gcm import step
from gcm_tpu.task import BorderSpec

GRIDS = {2: ("elastic2d", (9, 8), (1.0, 1.3)),
         3: ("elastic3d", (7, 6, 8), (1.0, 1.1, 0.9))}
KINDS = ("absorbing", "free", "fixed_force", "fixed_velocity")
VALUES = (0.4, -0.3, 0.2)


def _state(ncomp, shape, rng):
    u = rng.standard_normal((ncomp,) + shape)
    for a in range(1, u.ndim):           # band-limit for the high orders
        u = 0.25 * np.roll(u, 1, a) + 0.5 * u + 0.25 * np.roll(u, -1, a)
    return u


def _fields(medium, rho, lam, mu):
    if medium == "iso":
        return MaterialFields.from_arrays(rho, lam, mu, xp=jnp,
                                          dtype=jnp.float64)
    d, o = lam + 2.0 * mu, lam
    c = {"c11": d, "c22": d, "c33": d, "c12": o, "c13": o, "c23": o,
         "c44": mu, "c55": mu, "c66": mu}
    return OrthotropicMaterialFields.from_constants(rho, c, xp=jnp,
                                                    dtype=jnp.float64)


@pytest.mark.parametrize("medium", ["iso", "ortho"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_jnp_step_matches_oracle(dim, order, kind, reverse, medium, rng):
    name, shape, h = GRIDS[dim]
    model = get_model(name)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = _state(model.ncomp, shape, rng)
    dt = 0.6 * min(h) / np.sqrt((lam + 2 * mu) / rho).max()
    value = VALUES[:dim] if kind.startswith("fixed") else None
    borders = {(a, s): BorderSpec(kind, value)
               for a in range(dim) for s in (0, 1)}
    axes = tuple(range(dim))[::-1] if reverse else tuple(range(dim))

    got = step(model, jnp.asarray(u0), _fields(medium, rho, lam, mu), dt, h,
               order, borders, axes)
    want = oracle_step(model, u0, rho, lam, mu, dt, h, order, borders, axes)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9, atol=1e-9)
