"""Multi-process attach (SURVEY.md §5.8 aux subsystem A8).

What is testable on one host: without a coordinator ``initialize()`` must
be a strict no-op (never hijack a single-process run into a hung
coordinator wait), ``COORDINATOR_ADDRESS`` alone must enter distributed
mode, the process info must describe this process, and two real local
processes must step a mesh that spans them.
"""

from gcm_tpu.parallel import multihost


def test_initialize_is_noop_on_single_host(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert multihost.initialize() is False


def test_coordinator_address_triggers(monkeypatch):
    """``COORDINATOR_ADDRESS`` in the environment is a trigger on its own,
    and is passed to jax.distributed as the coordinator; explicit
    arguments ride along."""
    import jax

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:12345")
    assert multihost.initialize(num_processes=2, process_id=1) is True
    assert calls == [{"coordinator_address": "localhost:12345",
                      "num_processes": 2, "process_id": 1}]


def test_process_info_single_process():
    info = multihost.process_info()
    assert info["process_index"] == 0
    assert info["process_count"] == 1
    assert info["local_devices"] >= 1
    assert info["global_devices"] == info["local_devices"]


def test_two_process_distributed_step(tmp_path):
    """REAL multi-process execution (VERDICT r3 missing #4): two local
    processes attach via jax.distributed (explicit coordinator), build a
    4-device ('sx',) mesh spanning both, run sharded GCM steps (XLA inserts
    cross-process halo collectives), and the gathered result must match
    this process's single-process run."""
    import socket
    import subprocess
    import sys

    import numpy as np

    # free port for the coordinator
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    out = str(tmp_path / "dist_result.npy")
    worker = str(__file__).replace("test_multihost.py", "_dist_worker.py")

    env = dict(**__import__("os").environ)
    env.pop("XLA_FLAGS", None)         # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout = "TIMEOUT"
        logs.append(stdout)
    assert all(p.returncode == 0 for p in procs), \
        f"worker failures:\n{logs[0][-2000:]}\n---\n{logs[1][-2000:]}"

    # single-process reference (this pytest process, 8 virtual devices but
    # the program below is unsharded)
    import jax.numpy as jnp

    from gcm_tpu.materials import MaterialFields
    from gcm_tpu.models.spec import get_model
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
    mat = MaterialFields.from_arrays(rho, lam, mu, xp=jnp, dtype=jnp.float64)
    borders = {(a, s): BorderSpec("absorbing")
               for a in range(2) for s in (0, 1)}
    want = jnp.asarray(u0)
    for n in range(4):
        axes = (0, 1) if n % 2 == 0 else (1, 0)
        want = step(model, want, mat, dt, (1.0, 1.0), 2, borders, axes)

    got = np.load(out)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=1e-9)


def test_two_process_halo_step(tmp_path):
    """The engines' mesh path across a real process boundary: two
    jax.distributed processes build the ('sx','sy') mesh and step the
    shard_map halo step with cross-process ppermute exchange; the gathered
    result must match this process's unsharded jnp step."""
    import socket
    import subprocess
    import sys

    import numpy as np

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    out = str(tmp_path / "dist_halo.npy")
    worker = str(__file__).replace("test_multihost.py", "_dist_worker.py")

    env = dict(**__import__("os").environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid), out, "halo"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout = "TIMEOUT"
        logs.append(stdout)
    assert all(p.returncode == 0 for p in procs), \
        f"worker failures:\n{logs[0][-2000:]}\n---\n{logs[1][-2000:]}"

    import jax.numpy as jnp

    from gcm_tpu.materials import MaterialFields
    from gcm_tpu.models.spec import get_model
    from gcm_tpu.solver.gcm import step
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
    mat = MaterialFields.from_arrays(rho, lam, mu, xp=jnp,
                                     dtype=jnp.float32)
    borders = {(0, 0): BorderSpec("free"), (0, 1): BorderSpec("absorbing"),
               (1, 0): BorderSpec("absorbing"), (1, 1): BorderSpec("free"),
               (2, 0): BorderSpec("absorbing"),
               (2, 1): BorderSpec("absorbing")}
    want = jnp.asarray(u0)
    for n in range(4):
        axes = (0, 1, 2) if n % 2 == 0 else (2, 1, 0)
        want = step(model, want, mat, dt, (1.0, 1.0, 1.0), 2, borders, axes)
    want = np.asarray(want)
    got = np.load(out)
    scale = np.abs(want).reshape(9, -1).max(1) + 1e-30
    err = np.abs(got - want).reshape(9, -1).max(1) / scale
    assert err.max() < 1e-5, err
