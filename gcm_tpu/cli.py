"""Command-line launcher: ``python -m gcm_tpu <command> ...``.

Counterpart of the reference's launcher ``main`` (SURVEY.md §2
component 16): pick a predefined scenario by name, build the engine, run,
write artifacts.

Commands:
  run <scenario> [--n N] [--nsteps K] [--outdir DIR] [--snapshot-every S]
                 [--cpu] [--checkpoint-every C] [--resume]
  list
  bench [--n N] [--nsteps K]
"""

from __future__ import annotations

import argparse
import json
import sys


from gcm_tpu.task import KERNELS


def _build_parser():
    p = argparse.ArgumentParser(prog="gcm_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a named scenario")
    r.add_argument("scenario")
    r.add_argument("--n", type=int, default=None, help="grid resolution")
    r.add_argument("--nsteps", type=int, default=None)
    r.add_argument("--outdir", default="out")
    r.add_argument("--snapshot-every", type=int, default=None)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in outdir")
    r.add_argument("--cpu", action="store_true", help="force the CPU backend")
    r.add_argument("--profile", action="store_true",
                   help="capture a jax.profiler trace into <outdir>/trace")
    r.add_argument("--kernel", default=None, choices=list(KERNELS),
                   help="compute path (default: the task's, 'auto' = the "
                        "one-pass Hopper step kernel on a GPU when the "
                        "task qualifies, jnp otherwise)")
    r.add_argument("--mesh", default=None, metavar="NX[,NY]",
                   help="distribute over a device mesh of this shape "
                        "(shard_map halo exchange)")
    r.add_argument("--canonical-layout", action="store_true",
                   help="store state in a permuted layout (changes the "
                        "splitting axis order; see Task.canonical_layout)")

    sub.add_parser("list", help="list available scenarios")

    b = sub.add_parser("bench", help="engine throughput per path (bench.py)")
    b.add_argument("--n", type=int, default=256)
    b.add_argument("--nsteps", type=int, default=20)
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    if args.cmd == "list":
        from gcm_tpu.scenarios import list_scenarios

        for name in list_scenarios():
            print(name)
        for name in sorted(_MULTI_SCENARIOS):
            print(f"{name}  (multi-body; via gcm_tpu.engine_multi)")
        return 0

    if args.cmd == "bench":
        import os
        import sys

        # bench.py lives at the repo root, next to the package dir
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        if root not in sys.path:
            sys.path.insert(0, root)
        import bench

        return bench.main(n=args.n, nsteps=args.nsteps)

    # run
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from gcm_tpu.utils.backend import setup_compile_cache

    setup_compile_cache()

    import dataclasses

    from gcm_tpu.engine import Engine
    from gcm_tpu.scenarios import get_scenario
    from gcm_tpu.task import SnapshotSpec

    kw = {}
    if args.n is not None:
        kw["n"] = args.n
    if args.nsteps is not None:
        kw["nsteps"] = args.nsteps

    if args.scenario in _MULTI_SCENARIOS:
        return _run_contact(args, kw)
    if args.scenario.startswith("simplex"):
        return _run_simplex(args, kw)

    task = get_scenario(args.scenario, **kw)
    if args.snapshot_every is not None:
        task = dataclasses.replace(
            task, snapshots=SnapshotSpec(every=args.snapshot_every)
        )
    if args.kernel is not None:
        task = dataclasses.replace(task, kernel=args.kernel)
    if args.canonical_layout:
        task = dataclasses.replace(task, canonical_layout=True)

    import os

    mesh = None
    if args.mesh is not None:
        from gcm_tpu.parallel.sharding import domain_mesh

        shape = tuple(int(x) for x in args.mesh.split(","))
        import jax as _jax

        ndev = int(1 if not shape else __import__("numpy").prod(shape))
        mesh = domain_mesh(task.grid.dim, devices=_jax.devices()[:ndev],
                           shape=shape if len(shape) > 1 else None)
    eng = Engine(task, mesh=mesh)
    if args.resume:
        from gcm_tpu.utils.checkpoint import latest_step, restore_checkpoint

        ckdir = os.path.join(args.outdir, "checkpoints")
        step = latest_step(ckdir)
        if step is not None:
            # restore the FULL state (fields + corrector aux + step counter);
            # run() then executes only the remaining nsteps - step steps
            eng.load_state(restore_checkpoint(ckdir, eng.state_dict()))
            print(f"resumed from step {eng.start_step}", file=sys.stderr)

    from gcm_tpu.utils.profiling import trace

    with trace(os.path.join(args.outdir, "trace") if args.profile else None):
        res = eng.run_with_outputs(args.outdir,
                                   checkpoint_every=args.checkpoint_every)
    print(json.dumps({
        "scenario": task.name,
        "nsteps": res.nsteps,
        "dt": res.dt,
        "t_end": res.t,
        "kernel": res.kernel,
        "wall_seconds": round(res.wall_seconds, 3),
        "points_per_second": round(res.points_per_second, 1),
        "outdir": args.outdir,
    }))
    return 0


def _multi_scenarios():
    from gcm_tpu.scenarios import elastic2d_basin_refined, elastic3d_contact

    return {"elastic3d_contact": elastic3d_contact,
            "elastic2d_basin_refined": elastic2d_basin_refined}


class _LazyMulti:
    """Name membership without importing scenarios at module import."""

    def __contains__(self, name):
        return name in _multi_scenarios()

    def __iter__(self):
        return iter(_multi_scenarios())


_MULTI_SCENARIOS = _LazyMulti()


def _run_contact(args, kw) -> int:
    import numpy as np

    from gcm_tpu.engine_multi import MultiBodyEngine

    bodies, contacts = _multi_scenarios()[args.scenario](**kw)
    if args.kernel is not None:
        import dataclasses as _dc

        bodies = {k: _dc.replace(t, kernel=args.kernel)
                  for k, t in bodies.items()}
    mesh = None
    if args.mesh:
        # --mesh used to be silently ignored for contact scenarios
        # (code-review r5); MultiBodyEngine supports mesh= directly
        import jax as _jax

        from gcm_tpu.parallel.sharding import domain_mesh

        mshape = tuple(int(x) for x in args.mesh.split(","))
        ndev = int(np.prod(mshape))
        mesh = domain_mesh(3, devices=_jax.devices()[:ndev],
                           shape=mshape if len(mshape) > 1 else None)
    eng = MultiBodyEngine(bodies, contacts,
                          canonical_layout=args.canonical_layout, mesh=mesh)
    import os

    ckdir = os.path.join(args.outdir, "checkpoints")
    if args.resume:
        from gcm_tpu.utils.checkpoint import latest_step, restore_checkpoint

        if latest_step(ckdir) is not None:
            eng.load_state(restore_checkpoint(ckdir, eng.state_dict()))
            import sys as _sys

            print(f"resumed from step {eng.start_step}", file=_sys.stderr)

    # snapshot and checkpoint cadences are independent (code-review r5:
    # --checkpoint-every used to be silently ignored here); the engine
    # callback fires at their gcd, each artifact keeps its own check
    import math

    period = 2 if eng.symmetrize else 1
    rnd = lambda c: -(-c // period) * period if c else 0
    snap_every = rnd(args.snapshot_every or 0)
    ck_every = rnd(args.checkpoint_every or 0)
    cadences = [c for c in (snap_every, ck_every) if c]
    cb = None
    series = {}
    if cadences:
        from gcm_tpu.snapshot.vtk import (
            snapshot_fields, write_pvd, write_vti)

        snapdir = os.path.join(args.outdir, "snapshots")
        if snap_every:
            os.makedirs(snapdir, exist_ok=True)
        series = {name: [] for name in bodies}

        def cb(step, us):
            if snap_every and step % snap_every == 0:
                for name, u in us.items():
                    task = bodies[name]
                    fname = f"{name}_{step:06d}.vti"
                    write_vti(os.path.join(snapdir, fname),
                              task.grid.shape,
                              task.grid.h, task.grid.origin,
                              snapshot_fields(eng.model, u))
                    series[name].append((step * eng.dt, fname))
            if ck_every and step % ck_every == 0:
                from gcm_tpu.utils.checkpoint import save_checkpoint

                save_checkpoint(ckdir, step, eng.state_dict())

    res = eng.run(snapshot_cb=cb,
                  snapshot_every=math.gcd(*cadences) if cadences else 0)
    if any(series.values()):
        for name, entries in series.items():
            write_pvd(os.path.join(snapdir, f"{name}.pvd"), entries)
    eng.write_snapshots(args.outdir)
    if res.traces:
        from gcm_tpu.snapshot.seismo import save_seismograms

        for name, tr in res.traces.items():
            task = bodies[name]
            save_seismograms(args.outdir, task.name, tr, res.dt,
                             task.detectors.points, eng.model.comp_names)

    def broken(mask):
        # non-conforming contacts carry per-side mask dicts
        if isinstance(mask, dict):
            return float(np.mean([1.0 - np.asarray(m).mean()
                                  for m in mask.values()]))
        return float(1.0 - np.asarray(mask).mean())

    print(json.dumps({
        "scenario": args.scenario,
        "nsteps": res.nsteps,
        "dt": res.dt,
        "broken_fraction": round(broken(res.bonded[0]), 4)
        if res.bonded else None,
        "nonconforming_contacts": sorted(eng.ncmaps),
        "wall_seconds": round(res.wall_seconds, 3),
        "points_per_second": round(res.points_per_second, 1),
        "outdir": args.outdir,
    }))
    return 0


def _run_simplex(args, kw) -> int:
    import dataclasses
    import inspect
    import os

    from gcm_tpu import scenarios
    from gcm_tpu.task import SimplexTask, SnapshotSpec

    factory = getattr(scenarios, args.scenario, None)
    if factory is None:
        raise SystemExit(f"unknown simplex scenario {args.scenario!r}")
    nsteps = kw.pop("nsteps", None)
    if nsteps is not None and \
            "nsteps" in inspect.signature(factory).parameters:
        kw["nsteps"] = nsteps
        nsteps = None
    obj = factory(**kw)

    if isinstance(obj, SimplexTask):
        # full Task-driven path: cadenced snapshots, seismograms,
        # checkpoint/resume — parity with the structured run path
        from gcm_tpu.engine_simplex import SimplexEngine

        if args.snapshot_every is not None:
            obj = dataclasses.replace(
                obj, snapshots=SnapshotSpec(every=args.snapshot_every))
        if args.kernel is not None:
            obj = dataclasses.replace(obj, kernel=args.kernel)
        if args.mesh:
            import sys as _sys

            print("note: --mesh is not supported on simplex scenarios "
                  "(single-device unstructured sweeps); ignoring",
                  file=_sys.stderr)
        eng = SimplexEngine.from_task(obj)
        if args.resume:
            from gcm_tpu.utils.checkpoint import (
                latest_step, restore_checkpoint)

            ckdir = os.path.join(args.outdir, "checkpoints")
            step = latest_step(ckdir)
            if step is not None:
                eng.load_state(restore_checkpoint(ckdir, eng.state_dict()))
                print(f"resumed from step {eng.start_step}", file=sys.stderr)
        res = eng.run_with_outputs(args.outdir,
                                   checkpoint_every=args.checkpoint_every)
        eng.write_snapshot(
            os.path.join(args.outdir, f"{args.scenario}_final.vtu"))
    else:
        # legacy factories return a ready engine; nsteps via run()
        eng = obj
        res = eng.run(nsteps if nsteps is not None else 200)
        os.makedirs(args.outdir, exist_ok=True)
        eng.write_snapshot(os.path.join(args.outdir, f"{args.scenario}.vtu"))
    print(json.dumps({
        "scenario": args.scenario,
        "nsteps": res.nsteps,
        "dt": res.dt,
        "npoints": eng.grid.npoints,
        "wall_seconds": round(res.wall_seconds, 3),
        "points_per_second": round(res.points_per_second, 1),
        "outdir": args.outdir,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
