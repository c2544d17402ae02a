"""Simplex sweeps: the compressed-stencil (roll) form, the gather form and
the structured oracle.

Both forms of the semi-Lagrangian interpolation stay on every platform
(the engine picks the roll form when every foot table compresses). On an
unjittered 2D lattice an order-1 sweep's feet lie on axis-aligned edges, so
away from the hull both forms must reproduce the structured NumPy oracle
(gcm_tpu.oracle) node for node.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gcm_tpu.grids.simplex import (
    SimplexGrid, build_foot_tables, compress_foot_tables,
)
from gcm_tpu.materials import IsotropicMaterial, MaterialFields
from gcm_tpu.models.spec import get_model
from gcm_tpu.oracle.oracle import oracle_step
from gcm_tpu.solver.simplex_gcm import simplex_step


def _setup(name, dim, n, jitter, rng):
    L = float(n - 1)
    grid = SimplexGrid.box((0.0,) * dim, (L,) * dim, (n,) * dim,
                           jitter=jitter)
    acoustic = name.startswith("acoustic")
    mat = IsotropicMaterial.from_speeds(2500.0, 4000.0,
                                        0.0 if acoustic else 2300.0)
    npts = grid.npoints
    mf = MaterialFields.from_arrays(
        np.full(npts, mat.rho), np.full(npts, mat.lam),
        np.full(npts, mat.mu), xp=jnp, dtype=jnp.float64)
    dt = 0.7 / mat.cp
    waves = {"p": np.full(npts, mat.cp)}
    if not acoustic:
        waves["s"] = np.full(npts, mat.cs)
    gather = build_foot_tables(grid, waves, dt, order=1, waves=tuple(waves))
    roll = compress_foot_tables(
        {k: dataclasses.replace(t) for k, t in gather.items()})
    assert all(t.stencil is not None for t in roll.values())
    assert all(t.stencil is None for t in gather.values())
    model = get_model(name)
    u0 = rng.standard_normal((model.ncomp, npts))
    return model, mat, mf, dt, gather, roll, u0


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("name", ["acoustic2d", "elastic2d"])
def test_roll_gather_oracle_2d(name, reverse, rng):
    n = 9
    model, mat, mf, dt, gather, roll, u0 = _setup(name, 2, n, 0.0, rng)
    axes = (1, 0) if reverse else (0, 1)
    got_g = np.asarray(simplex_step(model, jnp.asarray(u0), mf, gather,
                                    "absorbing", axes))
    got_r = np.asarray(simplex_step(model, jnp.asarray(u0), mf, roll,
                                    "absorbing", axes))
    shape = (n, n)
    want = oracle_step(model, u0.reshape((model.ncomp,) + shape),
                       np.full(shape, mat.rho), np.full(shape, mat.lam),
                       np.full(shape, mat.mu), dt, (1.0, 1.0), 1, None,
                       axes)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got_r, got_g, rtol=1e-12, atol=1e-12 * scale)
    inner = (slice(None), slice(2, -2), slice(2, -2))
    np.testing.assert_allclose(got_g.reshape(want.shape)[inner],
                               want[inner], rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("border", ["absorbing", "free"])
@pytest.mark.parametrize("jitter", [0.0, 0.15])
def test_roll_equals_gather_3d(jitter, border, rng):
    model, _, mf, _, gather, roll, u0 = _setup("elastic3d", 3, 7, jitter,
                                               rng)
    got, want = jnp.asarray(u0), jnp.asarray(u0)
    for axes in ((0, 1, 2), (2, 1, 0)):
        got = simplex_step(model, got, mf, roll, border, axes)
        want = simplex_step(model, want, mf, gather, border, axes)
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
