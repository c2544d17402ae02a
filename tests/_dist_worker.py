"""Worker for the real 2-process ``jax.distributed`` test (VERDICT r3 #4).

Each process owns 2 virtual CPU devices; the coordinator glues them into a
4-device ('sx',) mesh. The worker builds the globally-sharded state from
process-local shards, runs N sharded jnp GCM steps (XLA inserts the
cross-process halo collectives), allgathers, and process 0 writes the
result. The parent pytest process compares against its single-process run.

The ``halo`` mode runs the engines' mesh path — the jnp sweep under
shard_map with explicit ``ppermute`` halo exchange (parallel.halo) —
across a REAL process boundary, not just inside one process's virtual
mesh.  The jnp mode keeps covering the GSPMD global program.

Usage: python _dist_worker.py <coordinator> <nproc> <pid> <outfile> [mode]
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run_halo(nproc, pid, outfile):
    """Step the shard_map halo step across the 2-process ('sx','sy') mesh
    — cross-process ppermute halo exchange included."""
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gcm_tpu.materials import MaterialFields
    from gcm_tpu.models.spec import get_model
    from gcm_tpu.parallel.halo import extend_mats_once, make_spmd_step
    from gcm_tpu.parallel.sharding import domain_mesh
    from gcm_tpu.task import BorderSpec

    model = get_model("elastic3d")
    shape = (48, 64, 8)
    rng = np.random.default_rng(0)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = rng.standard_normal((model.ncomp,) + shape).astype(np.float32)
    u0[3:] *= 1e6
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    h = (1.0, 1.0, 1.0)
    borders = {(0, 0): BorderSpec("free"), (0, 1): BorderSpec("absorbing"),
               (1, 0): BorderSpec("absorbing"), (1, 1): BorderSpec("free"),
               (2, 0): BorderSpec("absorbing"),
               (2, 1): BorderSpec("absorbing")}

    # ('sx','sy') (2,2) over all 4 global devices: the 'sx' ppermutes
    # cross the process boundary (each process owns one mesh row)
    mesh = domain_mesh(3)
    su = NamedSharding(mesh, P(None, "sx", "sy", None))
    sm = NamedSharding(mesh, P("sx", "sy", None))

    def put(global_np, sharding):
        arr = jnp.asarray(global_np)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    u = put(u0, su)
    mat_np = MaterialFields.from_arrays(rho, lam, mu, xp=np,
                                        dtype=np.float32)
    mat = jax.tree.map(lambda a: put(a, sm), mat_np)
    mext = extend_mats_once(mat, mesh, 3, 2)
    step_fn = make_spmd_step(model, mesh, dt, h, 2, borders)
    for n in range(4):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        u = step_fn(u, mext, axes)
    result = multihost_utils.process_allgather(u, tiled=True)
    if pid == 0:
        np.save(outfile, np.asarray(result))
    multihost_utils.sync_global_devices("done")
    print(f"worker {pid} OK (halo)", flush=True)


def main():
    coordinator, nproc, pid, outfile = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "jnp"

    from gcm_tpu.parallel import multihost

    entered = multihost.initialize(coordinator=coordinator,
                                   num_processes=nproc, process_id=pid)
    assert entered, "explicit coordinator must enter distributed mode"
    info = multihost.process_info()
    assert info["process_count"] == nproc, info
    assert info["global_devices"] == 2 * nproc, info

    if mode == "halo":
        return _run_halo(nproc, pid, outfile)

    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gcm_tpu.materials import MaterialFields
    from gcm_tpu.models.spec import get_model
    from gcm_tpu.parallel.sharding import domain_mesh
    from gcm_tpu.solver.gcm import step
    from gcm_tpu.task import BorderSpec

    model = get_model("elastic2d")
    shape = (32, 16)
    rng = np.random.default_rng(0)
    rho = 1000.0 * (1.0 + 0.5 * rng.random(shape))
    mu = 1e9 * (0.5 + rng.random(shape))
    lam = 1e9 * (1.0 + rng.random(shape))
    u0 = rng.standard_normal((model.ncomp,) + shape)
    dt = 0.6 / float(np.sqrt((lam + 2 * mu) / rho).max())
    h = (1.0, 1.0)
    borders = {(a, s): BorderSpec("absorbing")
               for a in range(2) for s in (0, 1)}

    mesh = domain_mesh(2)          # ('sx',) over all 4 global devices
    su = NamedSharding(mesh, P(None, "sx", None))
    sm = NamedSharding(mesh, P("sx", None))

    def put(global_np, sharding):
        arr = jnp.asarray(global_np)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    u = put(u0, su)
    mat_np = MaterialFields.from_arrays(rho, lam, mu, xp=np,
                                        dtype=np.float64)
    mat = jax.tree.map(lambda a: put(a, sm), mat_np)

    @jax.jit
    def steps(u, mat):
        for n in range(4):
            axes = (0, 1) if n % 2 == 0 else (1, 0)
            u = step(model, u, mat, dt, h, 2, borders, axes)
        return u

    out = steps(u, mat)
    result = multihost_utils.process_allgather(out, tiled=True)
    if pid == 0:
        np.save(outfile, np.asarray(result))
    multihost_utils.sync_global_devices("done")
    print(f"worker {pid} OK: {info}", flush=True)


if __name__ == "__main__":
    main()
