"""Cross-engine consistency: correctors, odd step counts, pairing.

VERDICT r2 item 3: ODE correctors must apply on every engine (a
viscoelastic/damage multi-body run must not silently compute pure
elasticity), and all engines must execute exactly the requested number of
steps — a 41-step request runs 41 steps with the same tail convention
(forward axes) everywhere.
"""

import numpy as np
import pytest

from gcm_tpu.materials import IsotropicMaterial
from gcm_tpu.task import (
    AreaBox, BorderSpec, GridSpec, InitialCondition, Task, TimeSpec,
)

MAT = IsotropicMaterial.from_speeds(rho=1000.0, cp=2000.0, cs=1100.0)


def _pulse_task(nsteps, correctors=(), name="one"):
    return Task(
        name=name, model="elastic2d",
        grid=GridSpec((24, 20), (1.0, 1.0)),
        default_material=MAT,
        initial=(InitialCondition(AreaBox((8.0, 6.0), (14.0, 12.0)),
                                  {"sxx": 0.4, "syy": 0.4}),),
        borders={(a, s): BorderSpec("absorbing")
                 for a in range(2) for s in (0, 1)},
        time=TimeSpec(cfl=0.8, nsteps=nsteps),
        correctors=correctors,
    )


@pytest.mark.parametrize("nsteps", [4, 5])
def test_multibody_matches_engine_any_parity(nsteps):
    """One body, no contacts: MultiBodyEngine must equal Engine for even
    AND odd step counts (r2 weak #3: it used to round odd counts down)."""
    from gcm_tpu.engine import Engine
    from gcm_tpu.engine_multi import MultiBodyEngine

    ref = Engine(_pulse_task(nsteps)).run()
    multi = MultiBodyEngine({"one": _pulse_task(nsteps)}, contacts=())
    res = multi.run()
    assert res.nsteps == nsteps
    np.testing.assert_allclose(res.bodies["one"], ref.u,
                               rtol=1e-6, atol=1e-7)


def test_multibody_damage_corrector_applies_and_resumes(tmp_path):
    """Mirror of tests/test_io.py::test_engine_resume_equals_uninterrupted
    for the multi-body engine: damage must actually evolve (not silently
    dropped) and survive a checkpoint/resume cycle."""
    from gcm_tpu.engine import Engine
    from gcm_tpu.engine_multi import MultiBodyEngine
    from gcm_tpu.solver.correctors import DamageCorrector
    from gcm_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    nsteps = 12
    corr = (DamageCorrector(threshold=0.05, rate=5e4),)

    ref = Engine(_pulse_task(nsteps, corr))
    rres = ref.run()
    assert float(np.asarray(ref.aux["damage"]).max()) > 0.01

    full = MultiBodyEngine({"one": _pulse_task(nsteps, corr)}, contacts=())
    fres = full.run()
    np.testing.assert_allclose(fres.bodies["one"], rres.u,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(full.auxs["one"]["damage"]),
                               np.asarray(ref.aux["damage"]),
                               rtol=1e-6, atol=1e-7)

    part = MultiBodyEngine({"one": _pulse_task(nsteps, corr)}, contacts=())
    part.nsteps = 6
    part.run()
    save_checkpoint(str(tmp_path / "ck"), 6, part.state_dict())

    resumed = MultiBodyEngine({"one": _pulse_task(nsteps, corr)}, contacts=())
    resumed.load_state(
        restore_checkpoint(str(tmp_path / "ck"), resumed.state_dict()))
    res = resumed.run()
    np.testing.assert_allclose(res.bodies["one"], fres.bodies["one"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(resumed.auxs["one"]["damage"]),
                               np.asarray(full.auxs["one"]["damage"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("nsteps", [3, 4])
def test_simplex_multi_odd_tail_matches_single(nsteps):
    """SimplexMultiEngine with one body and no contacts must equal
    SimplexEngine for odd and even step counts (advisor r2: run(3) used to
    execute 2 steps)."""
    from gcm_tpu.engine_simplex import (
        SimplexBody, SimplexEngine, SimplexMultiEngine,
    )
    from gcm_tpu.grids.simplex import SimplexGrid

    grid = SimplexGrid.box((0, 0), (8.0, 8.0), (9, 9))
    rng = np.random.default_rng(3)
    u0 = rng.standard_normal((5, grid.npoints))

    single = SimplexEngine(grid, "elastic2d", MAT, u0=u0.copy())
    sres = single.run(nsteps)
    multi = SimplexMultiEngine(
        {"one": SimplexBody(grid, MAT, u0=u0.copy())}, contacts=())
    mres = multi.run(nsteps)
    np.testing.assert_allclose(mres.bodies["one"], sres.u,
                               rtol=1e-6, atol=1e-7)


def test_friction_requires_normal_pair():
    """Coulomb friction needs the normal solve's sigma_c; a stage without a
    pair on the contact axis must raise the physics error, not a TypeError
    deep inside tracing (advisor r2)."""
    from gcm_tpu.models.spec import PairSpec
    from gcm_tpu.solver.contact import ContactSpec, _require_normal_pair

    spec = ContactSpec("a", "b", axis=0, kind="friction", friction_mu=0.4)
    tangential_only = [PairSpec(0, 1, "s", 1)]
    with pytest.raises(ValueError, match="normal"):
        _require_normal_pair(spec, tangential_only, 0)
    # a normal pair present, or a non-friction kind, passes
    _require_normal_pair(spec, [PairSpec(0, 1, "p", 0)], 0)
    bonded = ContactSpec("a", "b", axis=0, kind="bonded")
    _require_normal_pair(bonded, tangential_only, 0)


def test_pair_contact_nodes_mutual_no_duplicates():
    """A 2:1-refined interface with a loose tolerance: one-directional
    matching would pair two fine-side nodes to the same coarse node;
    mutual-nearest matching must return a bijection of the truly
    collocated nodes only (advisor r2)."""
    from gcm_tpu.grids.simplex import SimplexGrid
    from gcm_tpu.solver.simplex_contact import pair_contact_nodes

    # body a: fine (h=0.5) left box; body b: coarse (h=1) right box
    g_a = SimplexGrid.box((0, 0), (4.0, 8.0), (9, 17))
    g_b = SimplexGrid.box((4.0, 0), (8.0, 8.0), (5, 9))
    ia, ib = pair_contact_nodes(g_a, g_b, tol=0.6)
    assert np.unique(ib).size == len(ib)
    assert np.unique(ia).size == len(ia)
    # every kept pair is truly collocated (on the shared x=4 plane)
    np.testing.assert_allclose(g_a.points[ia], g_b.points[ib], atol=1e-9)
    assert len(ia) == 9  # the coarse interface nodes


def test_kernel_auto_resolution(monkeypatch):
    """kernel='auto' resolves to the one-pass Hopper step kernel when
    compute lands on a GPU and the task qualifies, and to jnp elsewhere;
    kernel='jnp' pins the jnp path everywhere."""
    import dataclasses
    from types import SimpleNamespace

    import jax.numpy as jnp

    import gcm_tpu.engine as eng_mod
    from gcm_tpu.engine import select_kernel
    from gcm_tpu.models.spec import get_model
    from gcm_tpu.scenarios import get_scenario

    task = get_scenario("elastic3d_layered", n=16, nsteps=2)
    model = get_model(task.model)
    mat = task.material_fields(xp=jnp, dtype=jnp.float32)
    # this suite runs on CPU -> auto is the semantics-of-record path
    assert select_kernel(task, model, mat, jnp.float32) == "jnp"
    monkeypatch.setattr(eng_mod, "compute_device",
                        lambda mesh=None: SimpleNamespace(
                            platform="gpu", compute_capability="9.0"))
    assert select_kernel(task, model, mat, jnp.float32) == "hopper"
    pinned = dataclasses.replace(task, kernel="jnp")
    assert select_kernel(pinned, model, mat, jnp.float32) == "jnp"
    # out of the kernel's scope: order, dtype, mesh, model
    assert select_kernel(dataclasses.replace(task, order=3), model, mat,
                         jnp.float32) == "jnp"
    assert select_kernel(task, model, mat, jnp.float64) == "jnp"
    assert select_kernel(task, model, mat, jnp.float32,
                         mesh=object()) == "jnp"
    t2 = get_scenario("elastic2d_ps", n=16, nsteps=2)
    assert select_kernel(t2, get_model(t2.model),
                         t2.material_fields(xp=jnp, dtype=jnp.float32),
                         jnp.float32) == "jnp"


def test_viscoelastic_scenario_attenuates():
    """The registered Maxwell scenario: S pulse arrives attenuated at the
    receiver relative to the pure-elastic run (SURVEY.md §0.5)."""
    import dataclasses

    import numpy as np

    from gcm_tpu.engine import Engine
    from gcm_tpu.scenarios import get_scenario

    t_v = get_scenario("elastic2d_viscoelastic", n=64, nsteps=120, tau=0.01)
    t_e = dataclasses.replace(t_v, correctors=())
    a_v = np.abs(Engine(t_v).run().traces).max()
    a_e = np.abs(Engine(t_e).run().traces).max()
    assert a_v < 0.7 * a_e, (a_v, a_e)


def test_multibody_cadenced_snapshots_match_uninterrupted():
    """MultiBodyEngine.run with a snapshot callback chunks the scan without
    changing the physics: final state equals the no-callback run, and the
    callback sees the correct step numbers."""
    import numpy as np

    from gcm_tpu.engine_multi import MultiBodyEngine
    from gcm_tpu.scenarios import elastic3d_contact

    bodies, contacts = elastic3d_contact(n=12, nsteps=9)
    ref = MultiBodyEngine(bodies, contacts).run()

    seen = []
    eng = MultiBodyEngine(bodies, contacts)
    res = eng.run(snapshot_cb=lambda step, us: seen.append(step),
                  snapshot_every=4)
    assert seen == [4, 8]          # period-aligned cadence inside nfull
    for k in ref.bodies:
        np.testing.assert_allclose(res.bodies[k], ref.bodies[k],
                                   rtol=1e-6, atol=1e-8)
    assert res.nsteps == 9         # odd tail still runs
