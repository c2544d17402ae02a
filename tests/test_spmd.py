"""Explicit shard_map + halo-exchange path vs the global program.

Validates gcm_tpu.parallel.halo: ppermute halo exchange and border fixup
gating by axis_index — the engines' mesh path (SURVEY.md §5.8) — on 8
virtual CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gcm_tpu.materials import MaterialFields
from gcm_tpu.models.spec import get_model
from gcm_tpu.parallel.halo import make_spmd_step
from gcm_tpu.parallel.sharding import domain_mesh, shard_state
from gcm_tpu.solver.boundary import apply_borders_post
from gcm_tpu.solver.gcm import stage, step
from gcm_tpu.task import BorderSpec

BORDERS = {
    (0, 0): BorderSpec("free"), (0, 1): BorderSpec("absorbing"),
    (1, 0): BorderSpec("absorbing"), (1, 1): BorderSpec("fixed_force", 2e5),
    (2, 0): BorderSpec("fixed_velocity", (0.1, 0.2, -0.3)),
    (2, 1): BorderSpec("free"),
}


def _problem(rng, shape):
    model = get_model("elastic3d")
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = rng.standard_normal((model.ncomp,) + shape)
    u0[3:] *= 1e6
    mat = MaterialFields.from_arrays(rho, lam, mu, xp=jnp, dtype=jnp.float64)
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    return model, jnp.asarray(u0), mat, dt


def test_border_post_fixup_equivalent(rng):
    """raw sweep + apply_borders_post == sweep with in-stage borders."""
    shape = (12, 10, 8)
    model, u, mat, dt = _problem(rng, shape)
    h = (1.0, 1.1, 0.9)
    for axis in range(3):
        want = stage(model, u, mat, dt, h, axis, 2, BORDERS)
        raw = stage(model, u, mat, dt, h, axis, 2, None)
        got = apply_borders_post(model, u, raw, mat, axis, BORDERS)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_spmd_step_matches_global(order, rng):
    shape = (32, 16, 8)
    model, u, mat, dt = _problem(rng, shape)
    h = (1.0, 1.0, 1.0)
    mesh = domain_mesh(3)

    spmd_step = make_spmd_step(model, mesh, dt, h, order, BORDERS)
    u_s, mat_s = shard_state(u, mat, mesh)
    got = u_s
    want = u
    for n in range(3):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        got = spmd_step(got, mat_s, axes)
        want = step(model, want, mat, dt, h, order, BORDERS, axes)
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).reshape(model.ncomp, -1).max(1) + 1e-30
    err = np.abs(got - want).reshape(model.ncomp, -1).max(1) / scale
    assert err.max() < 1e-12, f"normalized err {err}"


MESHES = [(8, 1), (4, 2), (2, 4)]


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_spmd_step_mesh_shapes(mesh_shape, order, rng):
    """Halo step over every 8-device mesh layout and order: shards as thin
    as one stencil (8 planes along x on (8, 1), 4 along y on (2, 4))."""
    shape = (32, 16, 6)
    model, u, mat, dt = _problem(rng, shape)
    h = (1.0, 1.2, 0.9)
    mesh = domain_mesh(3, devices=jax.devices("cpu")[:8], shape=mesh_shape)
    spmd_step = make_spmd_step(model, mesh, dt, h, order, BORDERS)
    u_s, mat_s = shard_state(u, mat, mesh)
    got, want = u_s, u
    for axes in ((0, 1, 2), (2, 1, 0)):
        got = spmd_step(got, mat_s, axes)
        want = step(model, want, mat, dt, h, order, BORDERS, axes)
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).reshape(model.ncomp, -1).max(1) + 1e-30
    err = np.abs(got - want).reshape(model.ncomp, -1).max(1) / scale
    assert err.max() < 1e-12, f"normalized err {err}"


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_engine_mesh_matches_unsharded(mesh_shape):
    """Engine(mesh=...) on the main-path scenario (source, detectors, free
    top) == the unsharded engine."""
    import dataclasses

    from gcm_tpu.engine import Engine
    from gcm_tpu.scenarios import get_scenario

    task = dataclasses.replace(
        get_scenario("elastic3d_layered", n=16, nsteps=6), kernel="jnp")
    mesh = domain_mesh(3, devices=jax.devices("cpu")[:8], shape=mesh_shape)
    sharded = Engine(task, mesh=mesh, dtype=jnp.float64).run()
    one = Engine(task, dtype=jnp.float64).run()
    scale = np.abs(one.u).max()
    assert np.abs(sharded.u - one.u).max() <= 1e-12 * scale
    np.testing.assert_allclose(sharded.traces, one.traces, rtol=1e-10,
                               atol=1e-12 * np.abs(one.traces).max())
