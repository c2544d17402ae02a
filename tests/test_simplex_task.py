"""Task-driven simplex scenarios: heterogeneous media, ICs-by-area,
snapshot cadence, checkpoint/resume (VERDICT r2 item 1).

The headline check: a layered medium on a lattice simplex mesh must match
the structured engine on the same nodes — the solver paths are different
code (gather tables vs stencils) but the physics and the lattice geometry
are identical, so the fields must agree to rounding.
"""

import numpy as np
import pytest

from gcm_tpu.materials import IsotropicMaterial
from gcm_tpu.task import (
    AreaBall, AreaBox, AreaLayer, BorderSpec, DetectorSpec, GridSpec,
    InitialCondition, MaterialRegion, RickerSource, SimplexTask,
    SnapshotSpec, Task, TimeSpec,
)

SOFT = IsotropicMaterial.from_speeds(rho=1900.0, cp=2100.0, cs=900.0)
HARD = IsotropicMaterial.from_speeds(rho=2700.0, cp=5200.0, cs=3000.0)


def _lattice_grid(n, L):
    from gcm_tpu.grids.simplex import SimplexGrid

    return SimplexGrid.box((0.0, 0.0), (L, L), (n, n))


def _layered_simplex_task(n=25, L=24.0, nsteps=10, correctors=(),
                          sources=(), snapshots=SnapshotSpec()):
    return SimplexTask(
        name="layered_lattice",
        model="elastic2d",
        grid=_lattice_grid(n, L),
        default_material=HARD,
        materials=(MaterialRegion(
            AreaLayer(axis=1, lo=L / 2, hi=L + 1.0), SOFT),),
        initial=(InitialCondition(
            AreaBall(center=(L / 2, L / 2), radius=L / 5),
            values={"sxx": 1.0e6, "syy": 1.0e6}),),
        border_default=BorderSpec("absorbing"),
        sources=sources,
        time=TimeSpec(cfl=0.5, nsteps=nsteps),
        snapshots=snapshots,
        detectors=DetectorSpec(points=((L / 4, L / 2), (3 * L / 4, L / 2))),
        correctors=correctors,
    )


def test_materials_by_area_rasterization():
    task = _layered_simplex_task()
    mat = task.material_fields()
    pts = np.asarray(task.grid.points)
    top = pts[:, 1] >= 12.0
    np.testing.assert_allclose(np.asarray(mat.cp)[top], SOFT.cp)
    np.testing.assert_allclose(np.asarray(mat.cp)[~top], HARD.cp)
    np.testing.assert_allclose(np.asarray(mat.rho)[top], SOFT.rho)
    np.testing.assert_allclose(np.asarray(mat.rho)[~top], HARD.rho)


def test_initial_state_by_area_matches_structured():
    """ICs rasterized on simplex nodes must equal the structured
    rasterization on the coincident lattice nodes — including callable
    (function) initial conditions."""
    from gcm_tpu.models.spec import get_model
    from gcm_tpu.task import apply_initial

    n, L = 13, 12.0
    model = get_model("elastic2d")
    ic = (InitialCondition(AreaBall(center=(L / 2, L / 2), radius=L / 3),
                           values={"sxx": lambda X, Y: np.sin(X) * Y,
                                   "vy": 2.5}),)
    stask = SimplexTask(name="ics", model="elastic2d",
                        grid=_lattice_grid(n, L), default_material=HARD,
                        initial=ic)
    u_s = stask.initial_state(model)
    grid_c = GridSpec((n, n), (L / (n - 1),) * 2)
    u_c = np.zeros((model.ncomp, n, n))
    apply_initial(u_c, model, grid_c, ic)
    np.testing.assert_allclose(u_s.reshape(model.ncomp, n, n), u_c)


def test_layered_lattice_matches_structured_engine():
    """VERDICT r2 item 1 done-criterion: a layered medium on a lattice
    simplex mesh matches the structured engine (order 1, same nodes,
    same dt) to ~1e-6 — here to f64 rounding."""
    import jax.numpy as jnp

    from gcm_tpu.engine import Engine
    from gcm_tpu.engine_simplex import SimplexEngine

    n, L, nsteps = 25, 24.0, 10
    stask = _layered_simplex_task(n, L, nsteps)
    ctask = Task(
        name="layered_struct",
        model="elastic2d",
        grid=GridSpec((n, n), (L / (n - 1),) * 2),
        default_material=HARD,
        materials=stask.materials,
        initial=stask.initial,
        borders={(a, s): BorderSpec("absorbing")
                 for a in (0, 1) for s in (0, 1)},
        time=stask.time,
        order=1,
        detectors=DetectorSpec(points=stask.detectors.points),
    )
    se = SimplexEngine.from_task(stask, dtype=jnp.float64)
    ce = Engine(ctask, dtype=jnp.float64)
    assert se.dt == pytest.approx(ce.dt, rel=1e-12)
    rs = se.run()
    rc = ce.run()
    # per-component scaling (stresses ~1e6, velocities ~1e-1); the two
    # paths differ only in rounding order (3-weight barycentric sum vs
    # 2-point stencil), accumulating to ~1e-8 relative over 10 steps
    for c in range(rc.u.shape[0]):
        np.testing.assert_allclose(
            rs.u.reshape(rc.u.shape)[c], rc.u[c],
            atol=1e-7 * max(np.abs(rc.u[c]).max(), 1e-30))
    np.testing.assert_allclose(rs.traces, rc.traces,
                               atol=1e-7 * np.abs(rc.traces).max())


@pytest.mark.parametrize("cut", [6, 7])  # period-aligned and mid-period
def test_simplex_resume_equals_uninterrupted(tmp_path, cut):
    """Kill-and-resume on the Task-driven simplex engine, including the
    irreversible damage aux and a mid-period cut (parity alignment)."""
    from gcm_tpu.engine_simplex import SimplexEngine
    from gcm_tpu.solver.correctors import DamageCorrector
    from gcm_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    nsteps = 12
    corr = (DamageCorrector(threshold=0.05, rate=5e4),)
    src = (RickerSource((12.0, 12.0), ("sxx", "syy"),
                        f0=400.0, t0=0.002, amplitude=50.0),)

    def build():
        return SimplexEngine.from_task(
            _layered_simplex_task(nsteps=nsteps, correctors=corr,
                                  sources=src))

    full = build()
    fres = full.run()
    assert float(np.asarray(full.aux["damage"]).max()) > 0.01, \
        "test must exercise nontrivial damage"

    part = build()
    part.run(nsteps=cut)
    save_checkpoint(str(tmp_path / "ck"), cut, part.state_dict())

    resumed = build()
    resumed.load_state(
        restore_checkpoint(str(tmp_path / "ck"), resumed.state_dict()))
    assert resumed.start_step == cut
    res = resumed.run()
    assert resumed._done_step == nsteps
    np.testing.assert_allclose(res.u, fres.u, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(resumed.aux["damage"]),
                               np.asarray(full.aux["damage"]),
                               rtol=1e-6, atol=1e-7)
    # the resumed run's seismogram covers the FULL record — the
    # checkpointed pre-resume chunks are prepended (code-review r5:
    # previously only the post-resume tail came back and overwrote the
    # output files)
    assert res.traces.shape[0] == nsteps
    np.testing.assert_allclose(res.traces, fres.traces,
                               rtol=1e-6, atol=1e-7)


def test_simplex_outputs_cadence(tmp_path):
    """run_with_outputs writes cadenced .vtu snapshots + seismograms."""
    from gcm_tpu.engine_simplex import SimplexEngine

    task = _layered_simplex_task(
        n=13, L=12.0, nsteps=8,
        snapshots=SnapshotSpec(every=4, directory="snaps"))
    eng = SimplexEngine.from_task(task)
    res = eng.run_with_outputs(str(tmp_path))
    assert (tmp_path / "snaps" / "layered_lattice_000004.vtu").exists()
    assert (tmp_path / "snaps" / "layered_lattice_000008.vtu").exists()
    assert (tmp_path / "layered_lattice.npz").exists()
    assert res.traces is not None and res.traces.shape[0] == 8


def test_canyon_scenario_cli(tmp_path):
    """The registered layered-canyon scenario runs end-to-end through the
    CLI (the reference launcher flow on an unstructured body)."""
    from gcm_tpu.cli import main

    out = str(tmp_path / "out")
    rc = main(["run", "simplex2d_canyon_layered", "--cpu",
               "--n", "17", "--nsteps", "6", "--outdir", out,
               "--snapshot-every", "2"])
    assert rc == 0
    import glob

    assert len(glob.glob(out + "/snapshots/*.vtu")) == 3
    assert len(glob.glob(out + "/simplex2d_canyon_layered.npz")) == 1


def test_simplex3d_layered_scenario_builds():
    """The 3D layered SimplexTask builds per-node heterogeneous fields and
    runs a couple of steps with finite output."""
    from gcm_tpu.engine_simplex import SimplexEngine
    from gcm_tpu.scenarios import simplex3d_layered

    task = simplex3d_layered(n=7, nsteps=2)
    eng = SimplexEngine.from_task(task)
    assert len(np.unique(np.asarray(eng.mat.cp))) >= 3  # three layers
    res = eng.run()
    assert np.isfinite(res.u).all()
    assert res.nsteps == 2


def test_simplex_multi_sources_detectors_match_single():
    """SimplexMultiEngine with one body must reproduce SimplexEngine's
    traces: sources, detectors and correctors now run on the multi-body
    path too (VERDICT r2 missing #5)."""
    import jax.numpy as jnp

    from gcm_tpu.engine_simplex import (
        SimplexBody, SimplexEngine, SimplexMultiEngine,
    )
    from gcm_tpu.solver.correctors import MaxwellCorrector

    grid = _lattice_grid(13, 12.0)
    src = (RickerSource((6.0, 6.0), ("sxx", "syy"),
                        f0=600.0, t0=0.0015, amplitude=1e3),)
    det = ((3.0, 6.0), (9.0, 6.0))
    corr = (MaxwellCorrector(tau=0.01),)

    single = SimplexEngine(grid, "elastic2d", HARD, u0=None,
                           sources=src, detector_points=det,
                           correctors=corr, dtype=jnp.float64)
    sres = single.run(9)
    multi = SimplexMultiEngine(
        {"one": SimplexBody(grid, HARD, sources=src, detector_points=det,
                            correctors=corr)},
        contacts=(), dtype=jnp.float64)
    mres = multi.run(9)
    np.testing.assert_allclose(mres.bodies["one"], sres.u,
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(mres.traces["one"], sres.traces,
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("cut", [6, 7])  # pair-aligned and odd checkpoint
def test_simplex_multi_resume_preserves_fracture(tmp_path, cut):
    """Resume on the simplex multi-body engine restores fields, bond masks
    and step counter (resume == uninterrupted) — including odd-step
    checkpoints, which realign with a single forward step like every
    other engine (VERDICT r3 weak #6)."""
    from gcm_tpu.engine_simplex import SimplexBody, SimplexMultiEngine
    from gcm_tpu.grids.simplex import SimplexGrid
    from gcm_tpu.solver.simplex_contact import SimplexContactSpec
    from gcm_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    L, n, k = 16.0, 17, 8
    xk = k * L / (n - 1)
    ga = SimplexGrid.box((0, 0), (xk, L), (k + 1, n))
    gb = SimplexGrid.box((xk, 0), (L, L), (n - k, n))
    rng = np.random.default_rng(7)

    def build():
        u0a = np.zeros((5, ga.npoints))
        # tensile pulse headed for the interface
        u0a[2] = 0.3 * np.exp(-((ga.points[:, 0] - 4.0) ** 2))
        return SimplexMultiEngine(
            {"a": SimplexBody(ga, HARD, u0=u0a),
             "b": SimplexBody(gb, HARD)},
            contacts=(SimplexContactSpec("a", "b", axis=0, kind="bonded",
                                         tensile_strength=0.05),))

    full = build()
    fres = full.run(12)

    part = build()
    part.run(cut)
    save_checkpoint(str(tmp_path / "ck"), cut, part.state_dict())
    resumed = build()
    resumed.load_state(
        restore_checkpoint(str(tmp_path / "ck"), resumed.state_dict()))
    assert resumed.start_step == cut
    rres = resumed.run(12)
    for name in ("a", "b"):
        np.testing.assert_allclose(rres.bodies[name], fres.bodies[name],
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rres.bonded[0], fres.bonded[0])


def test_simplex_multi_cadenced_snapshots_match_uninterrupted():
    """SimplexMultiEngine.run with a snapshot callback chunks the scan
    without changing physics."""
    import numpy as np

    from gcm_tpu.engine_simplex import SimplexBody, SimplexMultiEngine
    from gcm_tpu.grids.simplex import SimplexGrid
    from gcm_tpu.materials import IsotropicMaterial
    from gcm_tpu.solver.simplex_contact import SimplexContactSpec

    rock = IsotropicMaterial.from_speeds(rho=1000.0, cp=2000.0, cs=1100.0)
    g_a = SimplexGrid.box((0, 0), (8.0, 16.0), (9, 17))
    g_b = SimplexGrid.box((8.0, 0), (16.0, 16.0), (9, 17))
    rng = np.random.default_rng(0)

    def build():
        u0a = rng.standard_normal((5, g_a.npoints)) * 0 + 1e3
        bodies = {"a": SimplexBody(g_a, rock, u0=u0a),
                  "b": SimplexBody(g_b, rock)}
        return SimplexMultiEngine(
            bodies, [SimplexContactSpec("a", "b", axis=0)],
            model_name="elastic2d", cfl=0.6, dtype=np.float64)

    ref = build().run(9)
    seen = []
    res = build().run(9, snapshot_cb=lambda s, us: seen.append(s),
                      snapshot_every=4)
    assert seen == [4, 8]
    for k in ref.bodies:
        np.testing.assert_allclose(res.bodies[k], ref.bodies[k],
                                   rtol=1e-12, atol=1e-12)


def test_checkpoint_node_numbering_fingerprint(tmp_path):
    """A per-node checkpoint resumed onto a grid with a DIFFERENT node
    numbering must fail loudly (from_cells' default locality reorder
    renumbers imported meshes — code-review r5), while a matching grid
    and pre-fingerprint checkpoints keep loading."""
    import jax.numpy as jnp

    from gcm_tpu.engine_simplex import SimplexEngine
    from gcm_tpu.grids.simplex import SimplexGrid
    from gcm_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    rock = IsotropicMaterial.from_speeds(2500.0, 4000.0, 2300.0)
    n = 7
    base = SimplexGrid.box((0, 0, 0), (1.0, 1.0, 1.0), (n, n, n),
                           jitter=0.1)
    rng = np.random.default_rng(5)
    shuf = rng.permutation(base.npoints)
    inv = np.empty(base.npoints, np.int64)
    inv[shuf] = np.arange(base.npoints)

    g_old = SimplexGrid.from_cells(base.points, base.cells, reorder=None)
    # same mesh, genuinely different node numbering (reorder=None keeps
    # the shuffled input order; the default lattice-snap reorder would
    # reproduce g_old's numbering exactly — fingerprints then match,
    # which is correct and is what the shuffled-box physics test covers)
    g_new = SimplexGrid.from_cells(base.points[shuf], inv[base.cells],
                                   reorder=None)
    u0 = 0.01 * rng.standard_normal((9, base.npoints))

    eng = SimplexEngine(g_old, "elastic3d", rock, u0=u0, dtype=jnp.float64)
    eng.run(2)
    state = eng.state_dict()
    assert state["points_md5"] is not None
    save_checkpoint(str(tmp_path / "ck"), 2, state)

    # same numbering: round-trips (including through a checkpoint)
    eng_same = SimplexEngine(g_old, "elastic3d", rock, dtype=jnp.float64)
    eng_same.load_state(
        restore_checkpoint(str(tmp_path / "ck"), eng_same.state_dict()))
    assert eng_same.start_step == 2

    # renumbered grid: loud failure instead of silently-wrong fields
    eng_re = SimplexEngine(g_new, "elastic3d", rock, dtype=jnp.float64)
    with pytest.raises(ValueError, match="node numbering"):
        eng_re.load_state(
            restore_checkpoint(str(tmp_path / "ck"), eng_re.state_dict()))

    # pre-fingerprint checkpoint (no points_md5): still restorable
    legacy = {k: v for k, v in state.items() if k != "points_md5"}
    save_checkpoint(str(tmp_path / "ck_legacy"), 2, legacy)
    eng_legacy = SimplexEngine(g_old, "elastic3d", rock, dtype=jnp.float64)
    eng_legacy.load_state(restore_checkpoint(str(tmp_path / "ck_legacy"),
                                             eng_legacy.state_dict()))
    assert eng_legacy.start_step == 2
