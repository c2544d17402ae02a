"""Smoke test of gcm_tpu on one NVIDIA GPU: main path, parity, entry points.

Runs, in this one process and through the entry points a user calls:

1. device: every JAX device is a GPU; prints ``nvidia-smi``'s name and
   power limit. Without a GPU it exits non-zero and prints no result.
2. main path: ``python -m gcm_tpu run elastic3d_layered --n 512 --nsteps
   40`` (in-process, ``gcm_tpu.cli.main``) and ``Engine(...).run()`` on the
   same scenario: finite fields, non-zero detector trace, compile seconds
   and steady points/s.
3. parity with the plain reference (the jnp path is the semantics of
   record): the jnp path on the GPU against the same path on the CPU at
   n=64 over 20 steps; the one-pass Hopper step kernel against the jnp
   path on the GPU, one step of each axis order on random fields and 20
   engine steps at n=512. Tolerance max|d| <= 1e-5 * max|u| (float32; the
   step has no matrix products, so only FMA contraction and summation
   order differ).
4. the tests marked ``gpu`` (the kernel against the jnp step on the card,
   every border kind), run by pytest inside this process;
5. other entry points, a few steps each: elastic3d_explosion, elastic2d_ps,
   the 2-body elastic3d_contact with fracture (MultiBodyEngine),
   simplex3d_layered (SimplexEngine) and a SimplexMultiEngine contact run.

With ``--four-cards`` it runs only the four-card phase instead:
``Engine(task, mesh=domain_mesh(3, jax.devices()[:4]))`` on
elastic3d_layered at n=512 and the sharded 2-body contact, each against
the same run on one card (max|d| <= 1e-6 * max|u|).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Any failed phase raises, so the script exits non-zero without it.

Usage: python chip_smoke.py [--four-cards] [--n 512]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

TOL_REF = 1e-5       # kernel / device vs the jnp reference, f32
TOL_SHARD = 1e-6     # sharded vs one card, same jnp program


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    log(f"parity {name}: max|d|/max|u| = {err:.3e} (tolerance {tol:.0e}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.0e}")


def finite(name: str, *arrays) -> None:
    for a in arrays:
        if not np.isfinite(np.asarray(a)).all():
            raise AssertionError(f"{name}: non-finite values")


def phase_device():
    import jax

    devs = jax.devices()
    if not devs or any(d.platform != "gpu" for d in devs):
        raise SystemExit(f"no GPU: JAX devices are {devs}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"devices: {len(devs)} x {devs[0].device_kind}")
    log(smi[0])                       # name, power limit
    return devs


def expect_kernel(name: str, chosen: str, devs) -> None:
    """On a card the kernel library is built for (every device sm_90) the
    engine must take the Hopper kernel; elsewhere the jnp path."""
    from gcm_tpu.ops.hopper_step import is_hopper

    want = "hopper" if all(is_hopper(d) for d in devs) else "jnp"
    if chosen != want:
        raise AssertionError(f"{name}: engine chose {chosen}, expected {want}")


def phase_main_path(n: int, devs):
    from gcm_tpu import cli
    from gcm_tpu.engine import Engine
    from gcm_tpu.scenarios import get_scenario

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = cli.main(["run", "elastic3d_layered", "--n", str(n),
                       "--nsteps", "40", "--outdir", out])
        if rc != 0:
            raise AssertionError(f"CLI run exited {rc}")
        log(f"cli run elastic3d_layered n={n}: "
            f"{time.perf_counter() - t0:.1f} s end to end")

    t0 = time.perf_counter()
    eng = Engine(get_scenario("elastic3d_layered", n=n, nsteps=40))
    setup = time.perf_counter() - t0
    first = eng.run()                 # compile + 40 steps
    res = eng.run()                   # 40 more steps, compiled
    finite("main path", res.u)
    tr = np.abs(first.traces).max()
    if not tr > 0:
        raise AssertionError("detector trace is zero")
    expect_kernel("main path", res.kernel, devs)
    log(f"main path elastic3d_layered n={n} shape {eng.task.grid.shape}: "
        f"kernel={res.kernel} setup {setup:.1f} s, compile "
        f"{first.wall_seconds - res.wall_seconds:.1f} s, steady "
        f"{res.points_per_second:.4e} points/s "
        f"({res.wall_seconds:.3f} s / 40 steps), max|trace| {tr:.3e}")
    return res.kernel


def phase_parity(n: int, devs):
    import jax
    import jax.numpy as jnp

    from gcm_tpu.engine import Engine
    from gcm_tpu.scenarios import get_scenario

    # jnp on the GPU vs jnp on the CPU
    task = dataclasses.replace(
        get_scenario("elastic3d_layered", n=64, nsteps=20), kernel="jnp")
    gpu = Engine(task).run()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = Engine(task).run()
    check("jnp gpu vs cpu n=64 20 steps", rel_err(gpu.u, cpu.u), TOL_REF)

    from gcm_tpu.models.spec import get_model
    from gcm_tpu.ops.hopper_step import hopper_step
    from gcm_tpu.solver.gcm import step

    big = get_scenario("elastic3d_layered", n=n, nsteps=20)
    eng_h = Engine(big)
    expect_kernel("parity", eng_h.kernel, devs)
    if eng_h.kernel != "hopper":
        log(f"{devs[0].device_kind} is no Hopper GPU: no kernel parity")
        return
    # one step of each axis order on random fields, free + absorbing faces
    model = get_model("elastic3d")
    borders = dict(big.borders)
    borders[(2, 0)] = dataclasses.replace(borders[(2, 0)], kind="free")
    key = jax.random.PRNGKey(0)
    u = jax.random.normal(key, (9,) + big.grid.shape, jnp.float32)
    u = u.at[3:].multiply(1e6)
    for axes in ((0, 1, 2), (2, 1, 0)):
        got = np.asarray(hopper_step(u, eng_h.mat, eng_h.dt, big.grid.h,
                                     borders, axes))
        want = np.asarray(step(model, u, eng_h.mat, eng_h.dt, big.grid.h, 2,
                               borders, axes))
        check(f"hopper vs jnp one step axes {axes} n={n}",
              rel_err(got, want), TOL_REF)
    del u, got, want
    # 20 engine steps (both orders alternate), kernel vs jnp on the card
    res_h = eng_h.run()
    del eng_h
    res_j = Engine(dataclasses.replace(big, kernel="jnp")).run()
    check(f"hopper vs jnp Engine.run n={n} 20 steps",
          rel_err(res_h.u, res_j.u), TOL_REF)


class _Tally:
    """pytest plugin: counts passed and failed tests."""

    def __init__(self):
        self.passed = self.failed = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.passed and report.when == "call":
            self.passed += 1


def phase_gpu_tests():
    import os

    import pytest

    os.environ["GCM_TEST_GPU"] = "1"      # tests/conftest.py: stay on GPU
    root = os.path.dirname(os.path.abspath(__file__))
    tally = _Tally()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", root, os.path.join(root, "tests")],
                     plugins=[tally])
    log(f"tests marked gpu: {tally.passed} passed, {tally.failed} failed "
        f"(pytest exit {rc})")
    if rc != 0 or tally.failed or not tally.passed:
        raise AssertionError("tests marked gpu did not all pass")


def phase_entry_points():
    from gcm_tpu.engine import Engine
    from gcm_tpu.engine_multi import MultiBodyEngine
    from gcm_tpu.engine_simplex import (
        SimplexBody, SimplexEngine, SimplexMultiEngine)
    from gcm_tpu.grids.simplex import SimplexGrid
    from gcm_tpu.materials import IsotropicMaterial
    from gcm_tpu.scenarios import elastic3d_contact, get_scenario
    from gcm_tpu.solver.simplex_contact import SimplexContactSpec

    for name in ("elastic3d_explosion", "elastic2d_ps"):
        res = Engine(get_scenario(name, nsteps=10)).run()
        finite(name, res.u, res.traces)
        log(f"{name}: {res.u.shape[1:]} kernel={res.kernel} "
            f"{res.points_per_second:.3e} points/s (incl. compile)")

    eng = MultiBodyEngine(*elastic3d_contact(nsteps=10))
    res = eng.run()
    finite("elastic3d_contact", *res.bodies.values())
    path = ("full-step composition" if eng._full_step is not None else
            "sharded post-fixup" if eng._raw_stage is not None
            else "in-stage jnp")
    log(f"elastic3d_contact: MultiBodyEngine path={path}, broken fraction "
        f"{1.0 - float(np.mean(res.bonded[0])):.4f}")

    res = SimplexEngine.from_task(
        get_scenario("simplex3d_layered", nsteps=10)).run()
    finite("simplex3d_layered", res.u)
    log(f"simplex3d_layered: {res.u.shape[1]} nodes, jnp sweeps "
        f"(stencil_compressed={res.stencil_compressed})")

    rock = IsotropicMaterial.from_speeds(rho=2500.0, cp=4000.0, cs=2300.0)
    n, half = 17, 9
    g_a = SimplexGrid.box((0, 0, 0), (0.5, 1, 1), (half, n, n), jitter=0.1)
    g_b = SimplexGrid.box((0.5, 0, 0), (1.0, 1, 1), (n - half + 1, n, n),
                          jitter=0.1)
    rng = np.random.default_rng(0)
    u0 = np.zeros((9, g_a.npoints))
    u0[3:] = 1e5 * rng.standard_normal((6, g_a.npoints))
    multi = SimplexMultiEngine(
        {"a": SimplexBody(g_a, rock, u0=u0), "b": SimplexBody(g_b, rock)},
        [SimplexContactSpec("a", "b", axis=0, kind="bonded",
                            tensile_strength=5e5)],
        model_name="elastic3d", cfl=0.8)
    res = multi.run(10)
    finite("SimplexMultiEngine", *res.bodies.values())
    log(f"SimplexMultiEngine contact: {g_a.npoints + g_b.npoints} nodes, "
        f"jnp sweeps, broken fraction "
        f"{1.0 - float(np.mean(res.bonded[0])):.4f}")


def phase_four_cards(n: int):
    import jax

    from gcm_tpu.engine import Engine
    from gcm_tpu.engine_multi import MultiBodyEngine
    from gcm_tpu.parallel.sharding import domain_mesh
    from gcm_tpu.scenarios import elastic3d_contact, get_scenario

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    mesh = domain_mesh(3, devices=devs[:4])
    log(f"mesh {dict(mesh.shape)} over {[d.id for d in devs[:4]]}")

    task = dataclasses.replace(
        get_scenario("elastic3d_layered", n=n, nsteps=20), kernel="jnp")
    # each run() continues from the state the last one left: both engines
    # run twice (compile, then timed), 40 steps in all
    eng = Engine(task, mesh=mesh)
    eng.run()
    t0 = time.perf_counter()
    sh = eng.run()
    log(f"4-card Engine elastic3d_layered n={n}: "
        f"{sh.points_per_second:.4e} points/s steady "
        f"({time.perf_counter() - t0:.2f} s incl. fetch)")
    del eng
    eng = Engine(task)
    eng.run()
    one = eng.run()
    log(f"1-card Engine elastic3d_layered n={n}: "
        f"{one.points_per_second:.4e} points/s steady")
    del eng
    check(f"4-card vs 1-card Engine n={n} 40 steps",
          rel_err(sh.u, one.u), TOL_SHARD)
    del sh, one

    bodies, contacts = elastic3d_contact(n=n, nsteps=10)
    eng = MultiBodyEngine(bodies, contacts, mesh=mesh)
    if eng._raw_stage is None:
        raise AssertionError("sharded multi-body path not selected")
    sh = eng.run()
    del eng
    one = MultiBodyEngine(bodies, contacts).run()
    for k in sh.bodies:
        check(f"4-card vs 1-card MultiBodyEngine body {k} n={n}",
              rel_err(sh.bodies[k], one.bodies[k]), TOL_SHARD)
    for ci in sh.bonded:
        if not np.array_equal(sh.bonded[ci], one.bonded[ci]):
            raise AssertionError(f"bond mask {ci} differs")
    log("4-card MultiBodyEngine bond masks identical")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--n", type=int, default=512,
                    help="elastic3d_layered resolution of the large runs")
    args = ap.parse_args()

    import gcm_tpu  # noqa: F401  (fails outside a checkout of the repo)
    from gcm_tpu.utils.backend import setup_compile_cache

    log(f"compile cache: {setup_compile_cache()}")
    devs = phase_device()
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(args.n)
    else:
        kernel = phase_main_path(args.n, devs)
        log(f"main path compute path: {kernel}")
        phase_parity(args.n, devs)
        phase_gpu_tests()
        phase_entry_points()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
