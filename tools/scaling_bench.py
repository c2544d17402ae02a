"""Weak-scaling measurement harness.

Fix the per-device subdomain, grow the global domain with the device count,
measure points/s; efficiency(N) = pps(N) / (N * pps(1)). On real devices
each size runs the engines' mesh path (the shard_map halo step); with
virtual CPU devices (pass --virtual N) it is only *validated mechanically*:
the numbers mean nothing but the harness, meshes, and collectives are
real.

Usage:
  python tools/scaling_bench.py --virtual 8         # CPU mechanics check
  python tools/scaling_bench.py                     # real devices
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="use N virtual CPU devices (mechanics validation)")
    ap.add_argument("--per-device", default="128,128,128",
                    help="per-device subdomain shape")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--json-out", default=None,
                    help="append result records to this file")
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import jax.numpy as jnp

    from gcm_tpu.utils.backend import setup_compile_cache

    setup_compile_cache()
    from gcm_tpu.materials import IsotropicMaterial, MaterialFields
    from gcm_tpu.models.spec import get_model
    from gcm_tpu.parallel.halo import extend_mats_once, make_spmd_step
    from gcm_tpu.parallel.sharding import domain_mesh, shard_state
    from gcm_tpu.task import BorderSpec

    per_dev = tuple(int(x) for x in args.per_device.split(","))
    model = get_model("elastic3d")
    MAT = IsotropicMaterial.from_speeds(2500.0, 4000.0, 2300.0)
    borders = {(a, s): BorderSpec("absorbing") for a in range(3) for s in (0, 1)}
    h = (10.0, 10.0, 10.0)
    dt = 0.8 * min(h) / MAT.cp

    results = []
    ndev_all = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= ndev_all]
    for n in sizes:
        mesh = domain_mesh(3, devices=jax.devices()[:n])
        mx, my = mesh.devices.shape
        shape = (per_dev[0] * mx, per_dev[1] * my, per_dev[2])
        rng = np.random.default_rng(0)
        u0 = jnp.asarray(
            0.01 * rng.standard_normal((model.ncomp,) + shape),
            dtype=jnp.float32)
        mat = MaterialFields.uniform(MAT, shape, xp=jnp, dtype=jnp.float32)
        u, mat_s = shard_state(u0, mat, mesh)
        mext = extend_mats_once(mat_s, mesh, 3, 2)
        sstep = make_spmd_step(model, mesh, dt, h, 2, borders)
        step = lambda uu, axes: sstep(uu, mext, axes)  # noqa: E731
        # scan-timed with the engine's pattern: symmetrized (alternating)
        # axes orders
        import jax as _jax

        def scan_steps(uu):
            def body(a, _):
                a = step(a, (0, 1, 2))
                a = step(a, (2, 1, 0))
                return a, None

            return _jax.lax.scan(body, uu, None,
                                 length=args.steps // 2)[0]

        scan_steps = _jax.jit(scan_steps)
        u = scan_steps(u)                     # compile + warm
        u.block_until_ready()
        t0 = time.perf_counter()
        u = scan_steps(u)
        u.block_until_ready()
        dtw = (time.perf_counter() - t0) / (2 * (args.steps // 2))
        pps = int(np.prod(shape)) / dtw
        results.append({"devices": n, "mesh": list(mesh.devices.shape),
                        "global_shape": list(shape),
                        "platform": jax.devices()[0].platform,
                        "device_kind": jax.devices()[0].device_kind,
                        "virtual": bool(args.virtual),
                        "points_per_s": round(pps, 1)})
        print(json.dumps(results[-1]), flush=True)

    if len(results) > 1 and not args.virtual:
        base = results[0]["points_per_s"]
        for r in results[1:]:
            eff = r["points_per_s"] / (r["devices"] * base)
            results.append({"devices": r["devices"],
                            "weak_scaling_efficiency": round(eff, 3),
                            "virtual": False})
            print(json.dumps(results[-1]))
    elif args.virtual:
        # NO efficiency rows on virtual meshes: CPU timings of virtual
        # devices measure nothing and would read as a scaling result.
        # Virtual rows validate harness/mesh/collective mechanics only.
        print(json.dumps({"note": "virtual rows are mechanics-only; "
                          "efficiency requires real devices",
                          "virtual": True}))
    if args.json_out:
        with open(args.json_out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
