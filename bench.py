"""Throughput of the engines' main paths, through the normal entry points.

Each path runs in its own subprocess, one after another, so that only one
process holds the device at a time; this parent never imports jax. A
worker builds its engine, runs it once to compile and warm up, then times
a second ``run()`` (which ends in ``block_until_ready``).

Paths:
  ab       Engine on elastic3d_layered twice in one process, Task.kernel
           "auto" (the one-pass Hopper step kernel on a Hopper GPU when the
           task qualifies) and "jnp" (XLA sweeps): after both have
           compiled, ``--rounds`` rounds of one timed ``run()`` each, in
           alternating order (auto, jnp, jnp, auto, ...); medians
  contact  MultiBodyEngine on the 2-body elastic3d_contact scenario
  simplex  SimplexEngine on simplex3d_layered, ``--simplex-n`` nodes a side
  2d       Engine on elastic2d_ps, ``--n2d`` nodes a side

Prints the device name and power limit, one JSON line per path, then one
summary JSON line. Exits non-zero when any path fails, and a worker
fails when JAX finds no GPU.

Usage: python bench.py [--n 256] [--nsteps 20] [--simplex-n 33] [--n2d 4096]
                       [--rounds 10] [--paths ab,contact,...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PATHS = ("ab", "contact", "simplex", "2d")
PATH_TIMEOUT_S = 1200


def _engine(path: str, n: int, nsteps: int):
    """The engine of ``path`` at ``n`` nodes a side."""
    import dataclasses

    from gcm_tpu.engine import Engine
    from gcm_tpu.engine_multi import MultiBodyEngine
    from gcm_tpu.engine_simplex import SimplexEngine
    from gcm_tpu.scenarios import elastic3d_contact, get_scenario

    if path in ("auto", "jnp"):          # the two sides of "ab"
        task = get_scenario("elastic3d_layered", n=n, nsteps=nsteps)
        return Engine(dataclasses.replace(task, kernel=path))
    if path == "contact":
        return MultiBodyEngine(*elastic3d_contact(n=n, nsteps=nsteps))
    if path == "simplex":
        return SimplexEngine.from_task(
            get_scenario("simplex3d_layered", n=n, nsteps=nsteps))
    if path == "2d":
        return Engine(get_scenario("elastic2d_ps", n=n, nsteps=nsteps))
    raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")


def run_ab(n: int, nsteps: int, rounds: int, dev) -> dict:
    """The "ab" path: kernel "auto" against "jnp", alternating in one
    process after both have compiled."""
    import time

    import numpy as np

    t0 = time.perf_counter()
    engines = {k: _engine(k, n, nsteps) for k in ("auto", "jnp")}
    setup_s = time.perf_counter() - t0
    first = {k: e.run().wall_seconds for k, e in engines.items()}
    order = []
    for r in range(rounds):
        order += ["auto", "jnp"] if r % 2 == 0 else ["jnp", "auto"]
    walls = {k: [] for k in engines}
    for k in order:
        walls[k].append(engines[k].run().wall_seconds)
    npts = int(np.prod(engines["auto"].task.grid.shape)) * nsteps
    pps = {k: npts / float(np.median(w)) for k, w in walls.items()}
    return {
        "path": "ab", "kernel": engines["auto"].kernel,
        "platform": dev.platform, "device_kind": dev.device_kind,
        "compute_capability": getattr(dev, "compute_capability", None),
        "n": n, "nsteps": nsteps, "rounds": rounds,
        "setup_seconds": setup_s, "first_run_seconds": first,
        "order": order, "wall_seconds": walls,
        "points_per_second": pps,
        "auto_over_jnp": pps["auto"] / pps["jnp"],
    }


def run_worker(path: str, n: int, nsteps: int, rounds: int) -> None:
    import time

    import jax

    from gcm_tpu.utils.backend import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev}")
    if path == "ab":
        print(json.dumps(run_ab(n, nsteps, rounds, dev)), flush=True)
        return
    t0 = time.perf_counter()
    eng = _engine(path, n, nsteps)
    setup_s = time.perf_counter() - t0
    first = eng.run()           # compile + warm
    res = eng.run()             # steady state
    print(json.dumps({
        "path": path,
        "kernel": getattr(res, "kernel", "jnp"),
        "platform": dev.platform, "device_kind": dev.device_kind,
        "n": n, "nsteps": res.nsteps,
        "setup_seconds": setup_s,
        "first_run_seconds": first.wall_seconds,
        "wall_seconds": res.wall_seconds,
        "points_per_second": res.points_per_second,
    }), flush=True)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or a note
    that there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]


def _run_path(path: str, n: int, nsteps: int, rounds: int):
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", path,
           "--n", str(n), "--nsteps", str(nsteps), "--rounds", str(rounds)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=PATH_TIMEOUT_S, cwd=here)
    except subprocess.TimeoutExpired:
        return None, f"timeout after {PATH_TIMEOUT_S}s"
    for line in out.stdout.splitlines():
        if line.strip().startswith("{"):
            if out.returncode == 0:
                return json.loads(line), None
    return None, (f"rc={out.returncode}: "
                  f"{out.stderr.strip()[-600:]}")


def main(n: int = 256, nsteps: int = 20, paths=PATHS, simplex_n: int = 33,
         n2d: int = 4096, rounds: int = 10) -> int:
    print(f"gpu: {gpu_name_and_power_limit()}", flush=True)
    sizes = {"simplex": simplex_n, "2d": n2d}
    records, errors = {}, {}
    for path in paths:
        rec, err = _run_path(path, sizes.get(path, n), nsteps, rounds)
        if rec is None:
            errors[path] = err
            print(json.dumps({"path": path, "error": err}), flush=True)
        else:
            records[path] = rec
            print(json.dumps(rec), flush=True)
    summary = {"metric": "grid-points/s (Engine.run, steady state)",
               "n": {p: sizes.get(p, n) for p in paths}, "nsteps": nsteps,
               "points_per_second": {}}
    for p, r in records.items():
        pps = r["points_per_second"]
        if isinstance(pps, dict):          # "ab": one rate per side
            summary["points_per_second"].update(pps)
        else:
            summary["points_per_second"][p] = pps
    if errors:
        summary["errors"] = errors
    print(json.dumps(summary))
    return 1 if errors else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", default=None)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--nsteps", type=int, default=20)
    ap.add_argument("--simplex-n", type=int, default=33)
    ap.add_argument("--n2d", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=10,
                    help="alternating timed rounds of the ab path")
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    if args.worker:
        run_worker(args.worker, args.n, args.nsteps, args.rounds)
    else:
        raise SystemExit(main(args.n, args.nsteps,
                              tuple(args.paths.split(",")), args.simplex_n,
                              args.n2d, args.rounds))
