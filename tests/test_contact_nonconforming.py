"""Non-conforming contact: mismatched-spacing bodies couple correctly.

Round-2 verdict item 5 / missing #4. The reference pairs arbitrary border
nodes of independently meshed bodies (SURVEY.md §2 component 11); here the
coupling runs through static interface-interpolation maps
(solver.contact_nc). Anchors:

- maps built for *conforming* faces degenerate to the identity, and the
  mapped solve reproduces the collocated solve exactly;
- an h vs 2h interface transmits a smooth P wave with near-unit amplitude
  and only a small reflected remnant (same material: the monolithic answer
  has zero reflection);
- the MultiBodyEngine auto-detects mismatched faces, runs both the
  in-stage and the (mesh) post-fixup composition, and fracture/friction
  logic works per side.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gcm_tpu.materials import IsotropicMaterial, MaterialFields
from gcm_tpu.models.spec import get_model
from gcm_tpu.solver.contact import ContactSpec
from gcm_tpu.solver.contact_nc import (
    build_interface_maps, faces_conform, init_bonded_nc, interp_face,
)
from gcm_tpu.solver.multi import step_multi
from gcm_tpu.task import (
    AreaAll, BorderSpec, GridSpec, InitialCondition, Task, TimeSpec,
)

MAT = IsotropicMaterial.from_speeds(rho=1000.0, cp=2000.0, cs=1100.0)


def _mat(shape):
    return MaterialFields.uniform(MAT, shape, xp=jnp, dtype=jnp.float64)


def test_interp_face_exact_on_linear():
    """The per-axis tables are exact for affine functions (weights are
    convex barycentric pairs)."""
    ga = GridSpec((5, 9), (2.0, 1.0), (0.0, 0.0))
    gb = GridSpec((9, 17), (1.0, 0.5), (8.0, 0.0))
    maps = build_interface_maps(ga, gb, axis=0)
    yb = gb.coords()[1]
    vals = jnp.asarray(3.0 + 2.0 * yb)
    got = interp_face(vals, maps.a.from_other)
    ya = ga.coords()[1][maps.a.lo[0]:maps.a.lo[0] + maps.a.span[0]]
    np.testing.assert_allclose(np.asarray(got), 3.0 + 2.0 * ya, atol=1e-12)


def test_conforming_maps_degenerate_to_collocated_solve(rng):
    """On conforming faces the mapped per-side solve equals the collocated
    shared solve bit-for-bit (identity tables, same algebra)."""
    model = get_model("elastic2d")
    nx, ny, k = 12, 10, 6
    h = (1.0, 1.0)
    dt = 0.4 / MAT.cp
    ga = GridSpec((k + 1, ny), h, (0.0, 0.0))
    gb = GridSpec((nx - k, ny), h, (float(k), 0.0))
    assert faces_conform(ga, gb, 0)
    maps = build_interface_maps(ga, gb, 0)
    # identity tables: every target hits a source node with weight 1
    w = maps.a.from_other[0].w
    assert np.allclose(w.max(1), 1.0)

    u0 = rng.standard_normal((model.ncomp, nx, ny))
    us = {"a": jnp.asarray(u0[:, :k + 1]), "b": jnp.asarray(u0[:, k:])}
    mats = {"a": _mat((k + 1, ny)), "b": _mat((nx - k, ny))}
    hs = {"a": h, "b": h}
    borders = {
        name: {(a, s): BorderSpec("absorbing") for a in range(2)
               for s in (0, 1)} for name in us}
    contact = ContactSpec("a", "b", axis=0, kind="bonded")

    ref = dict(us)
    got = dict(us)
    for _ in range(3):
        ref, _ = step_multi(model, ref, mats, dt, hs, 1, borders,
                            [contact], {})
        got, _ = step_multi(model, got, mats, dt, hs, 1, borders,
                            [contact], {}, ncmaps={0: maps})
    for name in us:
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(ref[name]),
                                   rtol=1e-12, atol=1e-12)


def _mesh(path):
    """None for the in-stage path; a 1-device ('sx',) mesh puts the engine
    on its shard_map raw-sweep + post-fixup composition."""
    if path == "jnp":
        return None
    from gcm_tpu.parallel.sharding import domain_mesh

    return domain_mesh(2, devices=jax.devices()[:1])


def _two_body_engine(path="jnp", h_b=1.0, tensile=None, nsteps=140,
                     cfl=0.9, sigma=24.0):
    """Coarse body (h=2) -> fine body (h=h_b), same material, y-uniform P
    packet traveling +x toward the interface at x=120."""
    from gcm_tpu.engine_multi import MultiBodyEngine

    model = get_model("elastic2d")
    # wide in y: absorbing side walls perturb a grazing plane wave (their
    # known weakness), and the wall influence cone grows at cp — the mid-y
    # strip stays clean for the whole run only if Ly/2 > cp * t_end
    Ly = 256.0
    ga = GridSpec((61, 129), (2.0, 2.0), (0.0, 0.0))         # x in [0,120]
    nb = int(round(120.0 / h_b)) + 1
    gb = GridSpec((nb, int(round(Ly / h_b)) + 1), (h_b, h_b),
                  (120.0, 0.0))                              # x in [120,240]
    z = MAT.rho * MAT.cp
    sgn = -1.0 * model.sign      # +x-traveling wave loads one invariant

    def packet(X, Y):
        return np.exp(-((X - 60.0) / sigma) ** 2) + 0.0 * Y

    # a CLEAN traveling P wave also carries the slaved transverse stress
    # syy = kappa*sxx — otherwise the zero-speed invariant is loaded and a
    # static stress wake stays behind forever, polluting any reflection
    # measurement
    kappa = MAT.lam / (MAT.lam + 2.0 * MAT.mu)
    ic = InitialCondition(AreaAll(), values={
        "sxx": lambda X, Y: packet(X, Y),
        "syy": lambda X, Y: kappa * packet(X, Y),
        "vx": lambda X, Y: sgn * packet(X, Y) / z,
    })
    borders = {(a, s): BorderSpec("absorbing") for a in range(2)
               for s in (0, 1)}
    mk = lambda grid, ics, c: Task(
        name="nc", model="elastic2d", grid=grid, default_material=MAT,
        initial=tuple(ics), borders=dict(borders),
        time=TimeSpec(cfl=c, nsteps=nsteps), order=2)
    tasks = {"a": mk(ga, [ic], cfl), "b": mk(gb, [], cfl)}
    contact = ContactSpec("a", "b", axis=0, kind="bonded",
                          tensile_strength=tensile)
    return MultiBodyEngine(tasks, [contact], dtype=jnp.float64,
                           mesh=_mesh(path)), packet


@pytest.mark.parametrize("path", ["jnp", "mesh"])
def test_h_vs_2h_transmission(path):
    """A P packet crosses a 2h->h interface in one material. The monolithic
    answer has zero reflection and the fine half dissipates *less* than a
    coarse grid, so the transmitted peak must lie between the all-coarse
    monolithic control (same dt) and the exact amplitude 1."""
    from gcm_tpu.engine import Engine

    eng, packet = _two_body_engine(path=path)
    assert 0 in eng.ncmaps, "mismatched faces must auto-build maps"
    assert (eng._raw_stage is not None) == (path == "mesh")
    res = eng.run()
    ua, ub = res.bodies["a"], res.bodies["b"]
    assert np.isfinite(ua).all() and np.isfinite(ub).all()
    # measure on the mid-y strip, outside the side walls' influence cone
    mid_a, mid_b = 64, 128
    trans = np.abs(ub[2][:, mid_b]).max()

    # monolithic all-coarse control at the SAME dt (cfl 0.45 on h=2 equals
    # the two-body global dt from cfl 0.9 on h=1)
    model = get_model("elastic2d")
    grid = GridSpec((121, 129), (2.0, 2.0), (0.0, 0.0))
    z = MAT.rho * MAT.cp
    kappa = MAT.lam / (MAT.lam + 2.0 * MAT.mu)
    ic = InitialCondition(AreaAll(), values={
        "sxx": lambda X, Y: packet(X, Y),
        "syy": lambda X, Y: kappa * packet(X, Y),
        "vx": lambda X, Y: -model.sign * packet(X, Y) / z,
    })
    borders = {(a, s): BorderSpec("absorbing") for a in range(2)
               for s in (0, 1)}
    mono = Engine(Task(
        name="mono", model="elastic2d", grid=grid, default_material=MAT,
        initial=(ic,), borders=borders, time=TimeSpec(cfl=0.45, nsteps=140),
        order=2, kernel="jnp"), dtype=jnp.float64)
    assert abs(mono.dt - eng.dt) < 1e-15
    res_m = mono.run()
    mono_peak = np.abs(res_m.u[2][61:, mid_a]).max()

    assert trans >= 0.98 * mono_peak, (trans, mono_peak)
    assert trans <= 1.0 + 1e-3, trans
    # reflected remnant in the coarse body's clean strip is pure interface
    # error (the monolithic wake there is dispersion-level)
    refl = np.abs(ua[2][:, mid_a]).max()
    mono_wake = np.abs(res_m.u[2][:61, mid_a]).max()
    assert refl < mono_wake + 0.02, (refl, mono_wake)


@pytest.mark.parametrize("path", ["jnp", "mesh"])
def test_shear_field_exact_across_nonconforming_interface(path):
    """Analytic anchor on y-VARYING data: vx = alpha*y, sigma = 0 evolves
    exactly as sxy(t) = mu*alpha*t with vx unchanged (uniform simple
    shear). All fields are affine in y, linear interpolation maps are
    exact on affine data, so interface nodes must match the infinite-medium
    solution to roundoff inside the outer borders' domain of dependence."""
    from gcm_tpu.engine_multi import MultiBodyEngine

    model = get_model("elastic2d")
    alpha = 1e-3
    ga = GridSpec((21, 33), (2.0, 2.0), (0.0, 0.0))          # x in [0,40]
    gb = GridSpec((41, 65), (1.0, 1.0), (40.0, 0.0))         # x in [40,80]
    ic = InitialCondition(AreaAll(), values={
        "vx": lambda X, Y: alpha * Y})
    borders = {(a, s): BorderSpec("absorbing") for a in range(2)
               for s in (0, 1)}
    nsteps = 4
    mk = lambda grid: Task(
        name="sh", model="elastic2d", grid=grid, default_material=MAT,
        initial=(ic,), borders=dict(borders),
        time=TimeSpec(cfl=0.8, nsteps=nsteps), order=2)
    eng = MultiBodyEngine(
        {"a": mk(ga), "b": mk(gb)},
        [ContactSpec("a", "b", axis=0, kind="bonded")], dtype=jnp.float64,
        mesh=_mesh(path))
    assert 0 in eng.ncmaps
    res = eng.run()
    t = res.t
    mu = MAT.mu
    for name, grid in (("a", ga), ("b", gb)):
        u = res.bodies[name]
        Y = grid.meshgrid()[1]
        # interior of the OUTER borders' dependence cone (wall corruption
        # travels ~1 cell/sweep and crosses the interface from the coarse
        # body's walls at 2h per cell, hence the wider fine-side margin);
        # the interface itself (a's high x face, b's low x face) stays
        # fully checked
        sl = {"a": (slice(2 * nsteps, None),
                    slice(2 * nsteps, -2 * nsteps)),
              "b": (slice(None, -2 * nsteps),
                    slice(3 * nsteps, -3 * nsteps))}[name]
        np.testing.assert_allclose(u[0][sl], alpha * Y[sl],
                                   rtol=0, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(u[3][sl], mu * alpha * t,
                                   rtol=1e-9, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(u[1][sl], 0.0, atol=1e-12)
        np.testing.assert_allclose(u[2][sl], 0.0, atol=1e-9)


def test_nonconforming_fracture_breaks_per_side():
    """A tensile pulse at a 2h->h interface breaks both sides' bond masks;
    broken crack faces are traction-free, so transmission collapses."""
    eng, _ = _two_body_engine(tensile=1e-3, nsteps=140,
                              sigma=12.0)
    res = eng.run()
    m_a = res.bonded[0]["a"]
    m_b = res.bonded[0]["b"]
    assert m_a.max() == 0.0 and m_b.max() == 0.0  # tension breaks all rows
    assert np.isfinite(res.bodies["a"]).all()
    eng2, _ = _two_body_engine(tensile=None, nsteps=140,
                               sigma=12.0)
    res2 = eng2.run()
    assert np.abs(res.bodies["b"][2]).max() < \
        0.2 * np.abs(res2.bodies["b"][2]).max()


def test_nonconforming_resume_roundtrip():
    """state_dict/load_state round-trips per-side bond masks."""
    eng, _ = _two_body_engine(tensile=1e-3, nsteps=40)
    eng.run()
    state = eng.state_dict()
    eng2, _ = _two_body_engine(tensile=1e-3, nsteps=40)
    eng2.load_state(jax.tree.map(np.asarray, state))
    for side in ("a", "b"):
        np.testing.assert_array_equal(
            np.asarray(eng2.bonded[0][side]), np.asarray(eng.bonded[0][side]))


def test_basin_refined_scenario_builds_and_runs():
    """The registered non-conforming demo scenario: auto-detected maps,
    finite fields, receiver traces recorded on the fine body."""
    from gcm_tpu.engine_multi import MultiBodyEngine
    from gcm_tpu.scenarios import elastic2d_basin_refined

    bodies, contacts = elastic2d_basin_refined(n=17, nsteps=20)
    eng = MultiBodyEngine(bodies, contacts)
    assert 0 in eng.ncmaps
    res = eng.run()
    for v in res.bodies.values():
        assert np.isfinite(v).all()
    assert res.traces is not None and "basin" in res.traces
    assert res.traces["basin"].shape[0] == 20


def test_shear_field_exact_across_nonconforming_interface_3d():
    """3D version: vx = a*y + b*z, sigma = 0 evolves as sxy = mu*a*t,
    sxz = mu*b*t with vx unchanged. Exercises the separable tensor-product
    interpolation over BOTH transverse axes of a 3D h-vs-2h interface;
    affine data makes it exact inside the outer borders' dependence cone."""
    from gcm_tpu.engine_multi import MultiBodyEngine

    model = get_model("elastic3d")
    a_c, b_c = 1e-3, -2e-3
    ga = GridSpec((9, 17, 17), (2.0, 2.0, 2.0), (0.0, 0.0, 0.0))
    gb = GridSpec((17, 33, 33), (1.0, 1.0, 1.0), (16.0, 0.0, 0.0))
    ic = InitialCondition(AreaAll(), values={
        "vx": lambda X, Y, Z: a_c * Y + b_c * Z})
    borders = {(ax, s): BorderSpec("absorbing") for ax in range(3)
               for s in (0, 1)}
    nsteps = 2
    mk = lambda grid: Task(
        name="sh3", model="elastic3d", grid=grid, default_material=MAT,
        initial=(ic,), borders=dict(borders),
        time=TimeSpec(cfl=0.8, nsteps=nsteps), order=2, kernel="jnp")
    eng = MultiBodyEngine(
        {"a": mk(ga), "b": mk(gb)},
        [ContactSpec("a", "b", axis=0, kind="bonded")], dtype=jnp.float64)
    assert 0 in eng.ncmaps
    res = eng.run()
    t = res.t
    mu = MAT.mu
    comp = {n: get_model("elastic3d").comp(n)
            for n in ("vx", "vy", "vz", "sxy", "sxz", "syz")}
    for name, grid in (("a", ga), ("b", gb)):
        u = res.bodies[name]
        Y = grid.meshgrid()[1]
        Z = grid.meshgrid()[2]
        m = 2 * nsteps if name == "a" else 3 * nsteps
        sl = {"a": (slice(m, None), slice(m, -m), slice(m, -m)),
              "b": (slice(None, -m), slice(m, -m), slice(m, -m))}[name]
        np.testing.assert_allclose(u[comp["vx"]][sl],
                                   a_c * Y[sl] + b_c * Z[sl],
                                   rtol=0, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(u[comp["sxy"]][sl], mu * a_c * t,
                                   rtol=1e-9, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(u[comp["sxz"]][sl], mu * b_c * t,
                                   rtol=1e-9, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(u[comp["vy"]][sl], 0.0, atol=1e-12)
        np.testing.assert_allclose(u[comp["syz"]][sl], 0.0, atol=1e-9)
