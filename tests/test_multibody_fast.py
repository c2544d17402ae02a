"""Multi-body compositions: raw sweeps + post-fixup borders/contacts.

On a device mesh the multi-body engine runs each body's sweep through the
shard_map halo stage and applies borders/contacts as exact post-sweep slab
fixups; the opt-in canonical layout runs each body's whole step and fixes
the contact face rows afterwards. These tests pin both against the
in-stage solve.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gcm_tpu.engine_multi import MultiBodyEngine
from gcm_tpu.materials import IsotropicMaterial, MaterialFields
from gcm_tpu.models.spec import get_model
from gcm_tpu.scenarios import elastic3d_contact
from gcm_tpu.solver.contact import ContactSpec
from gcm_tpu.solver.gcm import stage as jnp_stage
from gcm_tpu.solver.multi import step_multi, step_multi_fast
from gcm_tpu.task import BorderSpec

MAT = IsotropicMaterial.from_speeds(rho=1000.0, cp=2000.0, cs=1100.0)


def _mat(shape):
    return MaterialFields.uniform(MAT, shape, xp=jnp, dtype=jnp.float64)


@pytest.mark.parametrize("kind,mu", [("bonded", 0.0), ("slip", 0.0),
                                     ("friction", 0.3)])
def test_post_fixup_equals_in_stage_contact(kind, mu, rng):
    """raw sweep + border/contact post-fixups == in-stage solve, for every
    contact kind, including fracture masks."""
    model = get_model("elastic2d")
    na, nb, ny = 12, 10, 8
    h = (1.0, 1.0)
    dt = 0.6 / MAT.cp
    us = {
        "a": jnp.asarray(rng.standard_normal((5, na, ny)) * 1e5),
        "b": jnp.asarray(rng.standard_normal((5, nb, ny)) * 1e5),
    }
    mats = {"a": _mat((na, ny)), "b": _mat((nb, ny))}
    hs = {"a": h, "b": h}
    borders = {(a, s): BorderSpec("absorbing") for a in range(2)
               for s in (0, 1)}
    bb = {"a": {f: b for f, b in borders.items() if f != (0, 1)},
          "b": {f: b for f, b in borders.items() if f != (0, 0)}}
    contact = ContactSpec("a", "b", 0, kind=kind, friction_mu=mu,
                          tensile_strength=5e4)
    bonded = {0: jnp.ones((ny,), jnp.float64)}

    def raw(name, u, axis):
        return jnp_stage(model, u, mats[name], dt, hs[name], axis, 1, None)

    got, gb = dict(us), dict(bonded)
    want, wb = dict(us), dict(bonded)
    for n in range(4):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        got, gb = step_multi_fast(model, got, mats, bb, (contact,), gb,
                                  raw, axes)
        want, wb = step_multi(model, want, mats, dt, hs, 1, bb, (contact,),
                              wb, axes)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-7)
    np.testing.assert_allclose(np.asarray(gb[0]), np.asarray(wb[0]))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_multibody_engine_sharded_matches_unsharded(shape):
    """Sharded multi-body contact (shard_map raw sweeps + GSPMD slab
    fixups) == unsharded in-stage engine, on the fracture scenario."""
    from gcm_tpu.parallel.sharding import domain_mesh

    bodies, contacts = elastic3d_contact(n=16, nsteps=6)
    res_ref = MultiBodyEngine(bodies, contacts).run()
    mesh = domain_mesh(3, devices=jax.devices("cpu")[:8], shape=shape)
    eng = MultiBodyEngine(bodies, contacts, mesh=mesh)
    assert eng._raw_stage is not None
    res = eng.run()
    for k in res.bodies:
        scale = np.abs(res_ref.bodies[k]).max() + 1e-30
        assert np.abs(res.bodies[k] - res_ref.bodies[k]).max() / scale < 2e-5
    for ci in res.bonded:
        np.testing.assert_array_equal(res.bonded[ci], res_ref.bonded[ci])


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_multibody_engine_sharded_orders(shape, order):
    """The sharded multi-body path at the other stencil orders (halo depth
    1 and 2), against the unsharded in-stage engine."""
    from gcm_tpu.parallel.sharding import domain_mesh

    bodies, contacts = elastic3d_contact(n=16, nsteps=4)
    bodies = {k: dataclasses.replace(t, order=order)
              for k, t in bodies.items()}
    res_ref = MultiBodyEngine(bodies, contacts).run()
    mesh = domain_mesh(3, devices=jax.devices("cpu")[:8], shape=shape)
    eng = MultiBodyEngine(bodies, contacts, mesh=mesh)
    assert eng._raw_stage is not None
    res = eng.run()
    for k in res.bodies:
        scale = np.abs(res_ref.bodies[k]).max() + 1e-30
        assert np.abs(res.bodies[k] - res_ref.bodies[k]).max() / scale < 2e-5
    for ci in res.bonded:
        np.testing.assert_array_equal(res.bonded[ci], res_ref.bonded[ci])


# ------------------------------------------- fused full-step composition (r3)

def _full_faces(contacts):
    faces = set()
    for c in contacts:
        if c.span is None:
            faces.add((c.body_a, c.axis, 1))
            faces.add((c.body_b, c.axis, 0))
    return faces


def _jnp_fused_body(model, mats, dt, hs, borders, contacts):
    """A 'fused body step' stand-in built from the jnp semantics of record:
    one full step per body, non-contact borders in place, raw clamp at
    full-contact faces — exactly what the engine's full-step body computes."""
    from gcm_tpu.solver.gcm import step as jnp_step

    faces = _full_faces(contacts)

    def body(name, u, axes):
        bcs = {f: b for f, b in borders.get(name, {}).items()
               if (name,) + f not in faces}
        return jnp_step(model, u, mats[name], dt, hs[name], 2, bcs, axes)

    return body


@pytest.mark.parametrize("kind,mu", [("bonded", 0.0), ("slip", 0.0),
                                     ("friction", 0.3)])
def test_step_multi_fused_equals_step_multi(kind, mu, rng):
    """Full-step fixup composition (VERDICT r3 item 2) == per-sweep
    in-stage solve, all contact kinds + fracture, order 2, both axes
    orders, 2D."""
    from gcm_tpu.solver.multi import fused_contacts_ok, step_multi_fused

    model = get_model("elastic2d")
    na, nb, ny = 12, 10, 8
    h = (1.0, 1.0)
    dt = 0.6 / MAT.cp
    us = {
        "a": jnp.asarray(rng.standard_normal((5, na, ny)) * 1e5),
        "b": jnp.asarray(rng.standard_normal((5, nb, ny)) * 1e5),
    }
    mats = {"a": _mat((na, ny)), "b": _mat((nb, ny))}
    hs = {"a": h, "b": h}
    borders = {(a, s): BorderSpec("absorbing") for a in range(2)
               for s in (0, 1)}
    bb = {"a": dict(borders), "b": dict(borders)}
    contact = ContactSpec("a", "b", 0, kind=kind, friction_mu=mu,
                          tensile_strength=5e4)
    bonded = {0: jnp.ones((ny,), jnp.float64)}
    assert fused_contacts_ok(model, {"a": (na, ny), "b": (nb, ny)},
                             (contact,), 2)
    fused_body = _jnp_fused_body(model, mats, dt, hs, bb, (contact,))

    got, gb = dict(us), dict(bonded)
    want, wb = dict(us), dict(bonded)
    for n in range(4):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        got, gb = step_multi_fused(model, got, mats, dt, hs, 2, bb,
                                   (contact,), gb, fused_body, axes)
        want, wb = step_multi(model, want, mats, dt, hs, 2, bb, (contact,),
                              wb, axes)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-7)
    np.testing.assert_allclose(np.asarray(gb[0]), np.asarray(wb[0]))


def test_step_multi_fused_3d_partial_overlap(rng):
    """3D, offset partial-overlap contact + free-surface BCs: the fixup
    must apply the body's own face BC outside the overlap and solve the
    contact inside it, then re-run the transverse sweeps on the face row."""
    from gcm_tpu.solver.multi import fused_contacts_ok, step_multi_fused

    model = get_model("elastic3d")
    sa, sb = (8, 10, 6), (8, 8, 6)
    h = (1.0, 1.0, 1.0)
    dt = 0.5 / MAT.cp
    us = {"a": jnp.asarray(rng.standard_normal((9,) + sa) * 1e5),
          "b": jnp.asarray(rng.standard_normal((9,) + sb) * 1e5)}
    mats = {"a": _mat(sa), "b": _mat(sb)}
    hs = {"a": h, "b": h}
    bcs = {(a, s): BorderSpec("free") for a in range(3) for s in (0, 1)}
    bb = {"a": dict(bcs), "b": dict(bcs)}
    contact = ContactSpec("a", "b", 1, kind="bonded",
                          lo_a=(1, 0), lo_b=(0, 0), span=(6, 6))
    bonded = {}
    assert fused_contacts_ok(model, {"a": sa, "b": sb}, (contact,), 2)
    fused_body = _jnp_fused_body(model, mats, dt, hs, bb, (contact,))

    got, want = dict(us), dict(us)
    for n in range(2):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        got, _ = step_multi_fused(model, got, mats, dt, hs, 2, bb,
                                  (contact,), {}, fused_body, axes)
        want, _ = step_multi(model, want, mats, dt, hs, 2, bb, (contact,),
                             {}, axes)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-7)


def test_step_multi_fused_three_body_chain(rng):
    """A 3-body chain along x: the middle body has contacts at BOTH faces
    of the same axis (allowed — disjoint face rows, independent fixups)."""
    from gcm_tpu.solver.multi import fused_contacts_ok, step_multi_fused

    model = get_model("elastic2d")
    ny = 6
    shapes = {"a": (8, ny), "b": (7, ny), "c": (9, ny)}
    h = (1.0, 1.0)
    dt = 0.5 / MAT.cp
    us = {k: jnp.asarray(rng.standard_normal((5,) + s) * 1e5)
          for k, s in shapes.items()}
    mats = {k: _mat(s) for k, s in shapes.items()}
    hs = {k: h for k in shapes}
    bcs = {(a, s): BorderSpec("absorbing") for a in range(2) for s in (0, 1)}
    bb = {k: dict(bcs) for k in shapes}
    contacts = (ContactSpec("a", "b", 0, kind="bonded"),
                ContactSpec("b", "c", 0, kind="bonded",
                            tensile_strength=4e4))
    bonded = {1: jnp.ones((ny,), jnp.float64)}
    assert fused_contacts_ok(model, shapes, contacts, 2)
    fused_body = _jnp_fused_body(model, mats, dt, hs, bb, contacts)

    got, gb = dict(us), dict(bonded)
    want, wb = dict(us), dict(bonded)
    for n in range(4):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        got, gb = step_multi_fused(model, got, mats, dt, hs, 2, bb,
                                   contacts, gb, fused_body, axes)
        want, wb = step_multi(model, want, mats, dt, hs, 2, bb, contacts,
                              wb, axes)
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-12, atol=1e-7)
    np.testing.assert_allclose(np.asarray(gb[1]), np.asarray(wb[1]))


def test_fused_contacts_eligibility():
    from gcm_tpu.solver.multi import fused_contacts_ok

    model = get_model("elastic3d")
    shapes = {"a": (8, 8, 8), "b": (8, 8, 8)}
    ok = (ContactSpec("a", "b", 0),)
    assert fused_contacts_ok(model, shapes, ok, 2)
    # two contact axes on one body couple at the face-edge line
    two_axes = (ContactSpec("a", "b", 0), ContactSpec("b", "a", 1))
    assert not fused_contacts_ok(model, shapes, two_axes, 2)
    # two contacts on the same face
    dup = (ContactSpec("a", "b", 0,
                       lo_a=(0, 0), lo_b=(0, 0), span=(2, 2)),
           ContactSpec("a", "b", 0,
                       lo_a=(4, 4), lo_b=(4, 4), span=(2, 2)))
    assert not fused_contacts_ok(model, shapes, dup, 2)
    # body shallower than the fixup slab
    assert not fused_contacts_ok(model, {"a": (2, 8, 8), "b": (8, 8, 8)},
                                 ok, 2)
    # non-conforming maps present
    assert not fused_contacts_ok(model, shapes, ok, 2, ncmaps={0: object()})


def test_canonical_layout_matches_matched_order_reference():
    """MultiBodyEngine(canonical_layout=True) stores state with the
    contact axis FIRST (the z-interface otherwise pays full-field lane
    traffic in every fixup) and steps with the permuted model; it must be
    exact against the jnp step_multi run with the matching physical axis
    order (z,x,y)/(y,x,z)."""
    from gcm_tpu.solver.multi import step_multi as sm


    bodies, contacts = elastic3d_contact(n=12, nsteps=4)
    bodies_f = dict(bodies)
    eng = MultiBodyEngine(bodies_f, contacts, canonical_layout=True)
    assert eng._perm == (2, 0, 1)
    res = eng.run()

    ref = MultiBodyEngine(bodies, contacts)      # jnp engine for setup
    us, bonded = dict(ref.us), dict(ref.bonded)
    for n in range(ref.nsteps):
        axes = (2, 0, 1) if n % 2 == 0 else (1, 0, 2)
        us, bonded = sm(ref.model, us, ref.mats, ref.dt, ref.hs, ref.order,
                        ref.borders, ref.contacts, bonded, axes, ref.ncmaps)
        for name, node, comp, amps in ref._srcs:
            us = dict(us)
            us[name] = us[name].at[(comp,) + node].add(amps[n])
    for k in res.bodies:
        w = np.asarray(us[k])
        scale = np.abs(w).max() + 1e-30
        assert np.abs(res.bodies[k] - w).max() / scale < 2e-5
    for ci in res.bonded:
        np.testing.assert_array_equal(res.bonded[ci],
                                      np.asarray(bonded[ci]))


def test_canonical_layout_resume_and_outputs(tmp_path):
    """Checkpoints and run outputs of a canonical-layout run stay in the
    TASK layout: resume into a non-canonical engine reproduces physics of
    the same splitting order; state_dict round-trips through the boundary
    unpermutation."""
    from gcm_tpu.utils.checkpoint import restore_checkpoint, save_checkpoint

    bodies, contacts = elastic3d_contact(n=12, nsteps=6)
    bodies_f = dict(bodies)

    full = MultiBodyEngine(bodies_f, contacts, canonical_layout=True)
    rfull = full.run()

    part = MultiBodyEngine(bodies_f, contacts, canonical_layout=True)
    part.nsteps = 4
    part.run()
    save_checkpoint(str(tmp_path / "ck"), 4, part.state_dict())
    resumed = MultiBodyEngine(bodies_f, contacts, canonical_layout=True)
    resumed.load_state(
        restore_checkpoint(str(tmp_path / "ck"), resumed.state_dict()))
    rres = resumed.run()
    for k in rfull.bodies:
        scale = np.abs(rfull.bodies[k]).max() + 1e-30
        assert np.abs(rres.bodies[k] - rfull.bodies[k]).max() / scale < 1e-5


def test_canonical_layout_under_device_mesh():
    """Canonical + SHARDED (VERDICT r4 weak #2): the contact axis leads
    (whole on every shard), the 1-axis mesh shards the middle axis (the
    engine rebuilds it as a ('sy',)-mesh), lane stays unsharded — and the
    composition is exact against the matched-order jnp reference."""
    import jax
    from jax.sharding import Mesh

    from gcm_tpu.solver.multi import step_multi as sm


    bodies, contacts = elastic3d_contact(n=12, nsteps=4)
    bodies_f = dict(bodies)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:4]), ("sx",))
    eng = MultiBodyEngine(bodies_f, contacts, mesh=mesh,
                          canonical_layout=True)
    assert eng._perm == (2, 0, 1)
    assert eng.mesh.axis_names == ("sy",), eng.mesh
    assert eng._full_step is not None
    res = eng.run()

    ref = MultiBodyEngine(bodies, contacts)      # jnp engine for setup
    us, bonded = dict(ref.us), dict(ref.bonded)
    for n in range(ref.nsteps):
        axes = (2, 0, 1) if n % 2 == 0 else (1, 0, 2)
        us, bonded = sm(ref.model, us, ref.mats, ref.dt, ref.hs, ref.order,
                        ref.borders, ref.contacts, bonded, axes, ref.ncmaps)
        for name, node, comp, amps in ref._srcs:
            us = dict(us)
            us[name] = us[name].at[(comp,) + node].add(amps[n])
    for k in res.bodies:
        w = np.asarray(us[k])
        scale = np.abs(w).max() + 1e-30
        assert np.abs(res.bodies[k] - w).max() / scale < 2e-5
    for ci in res.bonded:
        np.testing.assert_array_equal(res.bonded[ci],
                                      np.asarray(bonded[ci]))


def test_canonical_under_mesh_span_contact():
    """A PARTIAL-OVERLAP (lo/span) contact under canonical + mesh: the
    permuted transverse storage order must stay task-ascending — an
    inverted order would apply lo/span to the wrong transverse axes
    (contact.face_sub_index assigns entries in ascending storage-dim
    order) and transpose checkpointed bond masks (code-review r5)."""
    import jax
    from jax.sharding import Mesh

    from gcm_tpu.solver.multi import step_multi as sm


    bodies, _ = elastic3d_contact(n=12, nsteps=4)
    # asymmetric per-transverse-axis lo/span so a transposed mapping
    # cannot silently agree with the reference
    contacts = (ContactSpec("upper", "lower", axis=2, kind="bonded",
                            tensile_strength=1.0e5, broken_kind="free",
                            lo_a=(2, 1), lo_b=(1, 0), span=(8, 9)),)
    bodies_f = dict(bodies)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:4]), ("sx",))
    eng = MultiBodyEngine(bodies_f, contacts, mesh=mesh,
                          canonical_layout=True)
    assert eng._perm is not None
    # the invariant under test: transverse part of the perm is ascending
    assert list(eng._perm[1:]) == sorted(eng._perm[1:])
    assert eng._full_step is not None
    res = eng.run()

    ref = MultiBodyEngine(bodies, contacts)      # jnp engine for setup
    us, bonded = dict(ref.us), dict(ref.bonded)
    for n in range(ref.nsteps):
        axes = (2, 0, 1) if n % 2 == 0 else (1, 0, 2)
        us, bonded = sm(ref.model, us, ref.mats, ref.dt, ref.hs, ref.order,
                        ref.borders, ref.contacts, bonded, axes, ref.ncmaps)
        for name, node, comp, amps in ref._srcs:
            us = dict(us)
            us[name] = us[name].at[(comp,) + node].add(amps[n])
    for k in res.bodies:
        w = np.asarray(us[k])
        scale = np.abs(w).max() + 1e-30
        assert np.abs(res.bodies[k] - w).max() / scale < 2e-5
    for ci in res.bonded:
        np.testing.assert_array_equal(res.bonded[ci],
                                      np.asarray(bonded[ci]))


def test_canonical_layout_is_opt_in():
    """The canonical layout engages only when requested: a default engine
    keeps task layout and the in-stage solve on an eligible setup."""
    bodies, contacts = elastic3d_contact(n=12, nsteps=2)
    eng = MultiBodyEngine(bodies, contacts)
    assert eng._perm is None and eng._full_step is None
    eng2 = MultiBodyEngine(bodies, contacts, canonical_layout=True)
    assert eng2._perm == (2, 0, 1) and eng2._full_step is not None


def test_canonical_conformity_uses_original_axes():
    """code-review r5: conformity/interface-map construction must use the
    ORIGINAL (task-layout) contact axes, not the permuted ones.

    Case A — bodies differing only along the contact NORMAL (truly
    conforming z-interface): canonical must engage with NO interface
    maps (pre-fix, faces_conform(·, permuted axis 0) compared the wrong
    extents and built garbage maps).  Case B — genuinely non-conforming
    transverse spacing: canonical must refuse and the maps must be built
    about the TRUE axis."""
    from gcm_tpu.materials import IsotropicMaterial
    from gcm_tpu.solver.contact import ContactSpec
    from gcm_tpu.task import BorderSpec, GridSpec, Task, TimeSpec


    rock = IsotropicMaterial.from_speeds(rho=2500.0, cp=4000.0, cs=2300.0)

    def body(nz, h=10.0, hxy=10.0, n=12):
        return Task(
            name=f"b{nz}", model="elastic3d",
            grid=GridSpec((n, n, nz), (hxy, hxy, h)),
            default_material=rock,
            borders={(a, s): BorderSpec("absorbing")
                     for a in range(3) for s in (0, 1)},
            time=TimeSpec(cfl=0.8, nsteps=2), order=2)

    # Case A: nz_a != nz_b, transversally identical -> conforming
    bodies = {"up": body(8), "lo": body(6)}
    contacts = (ContactSpec("up", "lo", axis=2, kind="bonded"),)
    eng = MultiBodyEngine(bodies, contacts, canonical_layout=True)
    assert eng._perm is not None, "truly conforming: canonical engages"
    assert not eng.ncmaps, "no interface maps for a conforming interface"
    res = eng.run()
    for v in res.bodies.values():
        assert np.isfinite(v).all()

    # Case B: transverse spacing differs -> non-conforming; canonical
    # refuses, and the maps exist for the TRUE axis
    bodies_nc = {"up": body(8, hxy=10.0), "lo": body(8, hxy=5.0, n=23)}
    contacts_nc = (ContactSpec("up", "lo", axis=2, kind="bonded"),)
    eng_nc = MultiBodyEngine(bodies_nc, contacts_nc, canonical_layout=True)
    assert eng_nc._perm is None, "non-conforming must refuse canonical"
    assert 0 in eng_nc.ncmaps


@pytest.mark.parametrize("kind,mu", [("slip", 0.0), ("friction", 0.4)])
def test_canonical_layout_slip_friction_contact(kind, mu):
    """Slip/friction contacts under the canonical permuted layout: the
    interface normal must be identified by the PHYSICAL stage axis, not
    the permuted array axis — the array-axis comparison flagged a shear
    pair as the normal (transmitting shear, freeing the normal pair;
    feeding the Coulomb cap a shear traction) while all-pair-symmetric
    bonded contacts hid it (code-review r5)."""
    import jax

    from gcm_tpu.solver.multi import step_multi as sm


    # enough steps for the explosion to actually cross the interface —
    # at 4 steps the transmitted field is ~0 and any normal/shear mixup
    # trivially "agrees" (mutation-checked at 10)
    bodies, base_contacts = elastic3d_contact(n=12, nsteps=10)
    contacts = tuple(
        dataclasses.replace(c, kind=kind, friction_mu=mu,
                            tensile_strength=None, broken_kind="free")
        for c in base_contacts)
    bodies_f = dict(bodies)
    eng = MultiBodyEngine(bodies_f, contacts, canonical_layout=True)
    assert eng._perm == (2, 0, 1)
    assert eng._full_step is not None
    res = eng.run()

    ref = MultiBodyEngine(bodies, contacts)      # jnp engine for setup
    us, bonded = dict(ref.us), dict(ref.bonded)
    for n in range(ref.nsteps):
        axes = (2, 0, 1) if n % 2 == 0 else (1, 0, 2)
        us, bonded = sm(ref.model, us, ref.mats, ref.dt, ref.hs, ref.order,
                        ref.borders, ref.contacts, bonded, axes, ref.ncmaps)
        for name, node, comp, amps in ref._srcs:
            us = dict(us)
            us[name] = us[name].at[(comp,) + node].add(amps[n])
    for k in res.bodies:
        w = np.asarray(us[k])
        scale = np.abs(w).max() + 1e-30
        assert np.abs(res.bodies[k] - w).max() / scale < 2e-5
