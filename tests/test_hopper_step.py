"""The one-pass Hopper step kernel (gcm_tpu.ops.hopper_step).

The CUDA kernel has no interpret mode. On the CPU its source is compiled
with g++ against ``tests/cuda_emulate.h`` (CUDA threads as std::threads,
blocks in sequence) and compared with the jnp step, the semantics of
record. What surrounds the kernel is Python and is tested directly: the
engine's choice of path, the FFI attributes, the build command and the
error off the card. Tests marked ``gpu`` run the compiled kernel on the
card (see conftest.py).
"""

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gcm_tpu.engine as eng_mod
from gcm_tpu.engine import Engine
from gcm_tpu.materials import (
    IsotropicMaterial, MaterialFields, OrthotropicMaterial,
    OrthotropicMaterialFields,
)
from gcm_tpu.models.spec import get_model
from gcm_tpu.ops import hopper_step as hs
from gcm_tpu.scenarios import get_scenario
from gcm_tpu.solver.gcm import step
from gcm_tpu.task import BorderSpec

HERE = os.path.dirname(os.path.abspath(__file__))
EMU_HEADER = os.path.join(HERE, "cuda_emulate.h")
KINDS = ("absorbing", "free", "fixed_force", "fixed_velocity")
AXES = ((0, 1, 2), (2, 1, 0))
TOL = 1e-5          # max|d| / max|u|, float32
H100_SMS = 132      # multiprocessors of an H100 SXM


def _gpu(kind, cc):
    """A stand-in for a CUDA ``jax.Device``."""
    return SimpleNamespace(platform="gpu", device_kind=kind,
                           compute_capability=cc)


H100 = _gpu("NVIDIA H100 80GB HBM3", "9.0")
OTHER_GPUS = [_gpu("NVIDIA A100-SXM4-80GB", "8.0"),
              _gpu("NVIDIA L40S", "8.9"),
              _gpu("NVIDIA B200", "10.0")]


# ------------------------------------------------------------ fixtures

def _materials(shape, rng, fluid_patch=True):
    rho = rng.uniform(1500.0, 2500.0, shape)
    cp = rng.uniform(2000.0, 4000.0, shape)
    cs = cp * rng.uniform(0.3, 0.6, shape)
    if fluid_patch:
        cs[0, :3, :5] = 0.0          # zero S impedance: velocity kept
    mu = rho * cs**2
    lam = rho * cp**2 - 2 * mu
    return MaterialFields.from_arrays(rho, lam, mu, xp=jnp, dtype=jnp.float32)


def _borders(kind):
    value = (0.3, -0.2, 0.5) if kind.startswith("fixed") else None
    b = {(a, s): BorderSpec(kind, value) for a in range(3) for s in (0, 1)}
    b.pop((1, 0))                     # one face without a condition
    return b


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def emulated():
    """The kernel source built for the host with g++ (cached by hash)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    digest = hashlib.sha1()
    for path in (hs.SOURCE, EMU_HEADER):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(hs.BUILD_DIR,
                       f"libgcm_step_emu_{digest.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(hs.BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                        "-fPIC", "-DGCM_EMULATE", "-include", EMU_HEADER,
                        "-x", "c++", hs.SOURCE, "-o", tmp], check=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    c_int = ctypes.c_int
    lib.gcm_step_emulated.argtypes = [fp] * 6 + [c_int] * 3 + [fp, ip, fp,
                                                               c_int, c_int]
    lib.gcm_step_emulated.restype = c_int
    lib.gcm_pick_xchunk.argtypes = [c_int] * 4
    lib.gcm_pick_xchunk.restype = c_int
    return lib


def _run_emulated(lib, u, mat, dt, h, borders, axes, xchunk):
    a = hs.step_attrs(dt, h, borders, axes)
    f32 = lambda x: np.ascontiguousarray(np.asarray(x), np.float32)  # noqa
    u = f32(u)
    out = np.zeros_like(u)
    mats = [f32(mat.cp), f32(mat.cs), f32(mat.rho), f32(mat.kappa)]
    kinds = np.ascontiguousarray(a["kinds"], np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.gcm_step_emulated(
        *(x.ctypes.data_as(fp) for x in [u] + mats + [out]), *u.shape[1:],
        a["dtoh"].ctypes.data_as(fp),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        a["vals"].ctypes.data_as(fp), int(a["reverse"]), xchunk)
    assert rc == 0
    return out


# -------------------------------------------- kernel arithmetic (emulated)

@pytest.mark.parametrize("xchunk", [3, 64])
@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_kernel_matches_jnp_step(emulated, kind, axes, xchunk, rng):
    """Odd extents leave partial (y, z) tiles and x chunks; every border
    kind, a face without a condition and a zero-S-impedance patch."""
    shape = (7, 9, 35)
    mat = _materials(shape, rng)
    h = (1.0, 1.2, 0.9)
    dt = 0.8 * min(h) / mat.max_cp()
    u = jnp.asarray(rng.standard_normal((9,) + shape), jnp.float32)
    borders = _borders(kind)
    want = step(get_model("elastic3d"), u, mat, dt, h, 2, borders, axes)
    got = _run_emulated(emulated, u, mat, dt, h, borders, axes, xchunk)
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("axes", AXES)
def test_emulated_kernel_layered_scenario(emulated, axes):
    """The main path's own task (layered medium, free top, absorbing
    sides) at a tiny size, one step of each axis order."""
    task = get_scenario("elastic3d_layered", n=12, nsteps=2)
    e = Engine(dataclasses.replace(task, kernel="jnp"), dtype=jnp.float32)
    u = jax.random.normal(jax.random.PRNGKey(1), e.u.shape, jnp.float32)
    want = step(e.model, u, e.mat, e.dt, task.grid.h, 2, task.borders, axes)
    got = _run_emulated(emulated, u, e.mat, e.dt, task.grid.h, task.borders,
                        axes, emulated.gcm_pick_xchunk(*task.grid.shape,
                                                       H100_SMS))
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("shape,sms,expect", [
    ((512, 512, 256), 132, 64),  # 774 tiles already fill the card
    ((128, 128, 64), 132, 8),    # 66 tiles: short chunks, more blocks
    ((192, 192, 96), 132, 22),   # 128 tiles: 9 chunks of 22 planes
    ((192, 192, 96), 16, 64),    # a small card: the tiles suffice
    ((7, 9, 35), 132, 8),
    ((4096, 6, 30), 132, 8),     # one tile: as many chunks as allowed
    ((4096, 600, 300), 132, 64),
])
def test_pick_xchunk(emulated, shape, sms, expect):
    assert emulated.gcm_pick_xchunk(*shape, sms) == expect


# ------------------------------------------------------- choice of path

def _elastic_args(**over):
    shape = (6, 6, 6)
    kw = dict(model=get_model("elastic3d"),
              mat=MaterialFields.uniform(
                  IsotropicMaterial.from_speeds(2000.0, 3000.0, 1500.0),
                  shape, xp=jnp, dtype=jnp.float32),
              order=2, dtype=jnp.float32,
              borders={(2, 0): BorderSpec("free"),
                       (0, 1): BorderSpec("absorbing")},
              device=H100, mesh=None, perm=None)
    kw.update(over)
    return kw


def _ortho_mat():
    m = OrthotropicMaterial.from_isotropic(
        IsotropicMaterial.from_speeds(2000.0, 3000.0, 1500.0))
    shape = (6, 6, 6)
    return OrthotropicMaterialFields.from_constants(
        np.full(shape, m.rho),
        {k: np.full(shape, v) for k, v in m.constants().items()},
        xp=jnp, dtype=jnp.float32)


@pytest.mark.parametrize("over,expect", [
    ({}, True),
    ({"device": jax.devices("cpu")[0]}, False),
    ({"device": OTHER_GPUS[0]}, False),
    ({"device": OTHER_GPUS[1]}, False),
    ({"device": OTHER_GPUS[2]}, False),
    ({"mesh": object()}, False),
    ({"perm": (1, 0, 2)}, False),
    ({"model": get_model("elastic2d")}, False),
    ({"model": get_model("acoustic3d")}, False),
    ({"order": 1}, False),
    ({"order": 3}, False),
    ({"dtype": jnp.float64}, False),
    ({"borders": {(a, s): BorderSpec(k) for a, s, k in
                  [(0, 0, "fixed_force"), (1, 1, "fixed_velocity")]}}, True),
    ({"borders": {}}, True),
], ids=["base", "cpu", "sm80", "sm89", "sm100", "mesh", "perm", "2d", "acoustic", "order1",
        "order3", "f64", "fixed", "no-borders"])
def test_eligible(over, expect):
    assert hs.eligible(**_elastic_args(**over)) is expect


def test_eligible_rejects_orthotropic():
    assert not hs.eligible(**_elastic_args(mat=_ortho_mat()))


def test_engine_takes_kernel_on_gpu_only(monkeypatch):
    task = get_scenario("elastic3d_layered", n=8, nsteps=2)
    assert Engine(task).kernel == "jnp"                  # CPU here
    monkeypatch.setattr(eng_mod, "compute_device", lambda mesh=None: H100)
    assert Engine(task).kernel == "hopper"
    assert Engine(dataclasses.replace(task, kernel="jnp")).kernel == "jnp"
    assert Engine(task, dtype=jnp.float64).kernel == "jnp"


@pytest.mark.parametrize("device", OTHER_GPUS,
                         ids=[d.compute_capability for d in OTHER_GPUS])
def test_engine_takes_jnp_on_other_gpus(monkeypatch, device):
    """The library holds sm_90a code only: no other GPU can launch it."""
    monkeypatch.setattr(eng_mod, "compute_device", lambda mesh=None: device)
    task = get_scenario("elastic3d_layered", n=8, nsteps=2)
    assert Engine(task).kernel == "jnp"


@pytest.mark.parametrize("chosen,devices,ok", [
    ("hopper", [H100], True),
    ("jnp", [H100], False),              # a regression in the choice
    ("jnp", OTHER_GPUS[:1], True),
    ("hopper", [H100] + OTHER_GPUS[:1], False),
], ids=["hopper-on-h100", "jnp-on-h100", "jnp-on-a100", "hopper-mixed"])
def test_smoke_demands_kernel_on_hopper(chosen, devices, ok):
    """chip_smoke.py fails when the engine's choice does not follow the
    devices, instead of skipping the kernel's parity."""
    import chip_smoke

    if ok:
        chip_smoke.expect_kernel("main path", chosen, devices)
    else:
        with pytest.raises(AssertionError, match="expected"):
            chip_smoke.expect_kernel("main path", chosen, devices)


def test_run_result_reports_path():
    res = Engine(get_scenario("elastic3d_layered", n=8, nsteps=2)).run()
    assert res.kernel == "jnp"


# ---------------------------------------------------- attributes, build

def test_face_tables_follow_pair_value():
    borders = {(0, 1): BorderSpec("fixed_force", (1.0, 2.0, 3.0)),
               (2, 0): BorderSpec("fixed_velocity", 4.0),
               (1, 0): BorderSpec("free")}
    kinds, vals = hs.face_tables(borders)
    assert kinds.tolist() == [0, 3, 2, 0, 4, 0]
    for (axis, side), bc in borders.items():
        for t in range(3):
            assert vals[2 * axis + side, t] == bc.pair_value(t, axis)
    assert not vals[[0, 3, 5]].any()


@pytest.mark.parametrize("axes", [(1, 0, 2), (0, 2, 1), (0, 1)])
def test_step_attrs_rejects_other_axis_orders(axes):
    with pytest.raises(ValueError, match="not in"):
        hs.step_attrs(1.0, (1.0, 1.0, 1.0), {}, axes)


def test_step_attrs_reverse_flag():
    fwd = hs.step_attrs(0.5, (1.0, 2.0, 4.0), {}, (0, 1, 2))
    rev = hs.step_attrs(0.5, (1.0, 2.0, 4.0), {}, (2, 1, 0))
    assert (int(fwd["reverse"]), int(rev["reverse"])) == (0, 1)
    np.testing.assert_allclose(fwd["dtoh"], [0.5, 0.25, 0.125])


def test_build_command_from_repo_files():
    root = os.path.dirname(HERE)
    assert os.path.isfile(hs.SOURCE)
    assert os.path.commonpath([hs.SOURCE, root]) == root
    out = hs.library_path()
    assert os.path.dirname(out) == hs.BUILD_DIR
    cmd = hs.build_command(out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == hs.SOURCE and out in cmd
    assert jax.ffi.include_dir() in cmd
    with open(os.path.join(root, ".gitignore")) as f:
        assert "/build/" in f.read().split()


def test_library_path_tracks_source(tmp_path, monkeypatch):
    src = tmp_path / "gcm_step.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(hs, "SOURCE", str(src))
    first = hs.library_path()
    src.write_text("// b\n")
    assert hs.library_path() != first


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "gcm_step.cu"
    src.write_text("// never compiled\n")
    monkeypatch.setattr(hs, "SOURCE", str(src))
    monkeypatch.setattr(hs, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(hs, "nvcc_path", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="failed"):
        hs.build()
    assert not os.path.exists(hs.library_path())


@pytest.mark.parametrize("nvcc", ["/nonexistent/cuda/bin/nvcc", __file__],
                         ids=["missing", "not-executable"])
def test_build_without_nvcc_names_jnp_path(tmp_path, monkeypatch, nvcc):
    monkeypatch.setattr(hs, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(hs, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="kernel='jnp'"):
        hs.build()
    assert not os.path.exists(hs.BUILD_DIR)


def test_hopper_step_off_gpu_raises():
    shape = (4, 4, 4)
    mat = MaterialFields.uniform(
        IsotropicMaterial.from_speeds(2000.0, 3000.0, 1500.0), shape,
        xp=jnp, dtype=jnp.float32)
    with pytest.raises(RuntimeError, match="only on a CUDA GPU"):
        hs.hopper_step(jnp.zeros((9,) + shape, jnp.float32), mat, 1e-4,
                       (1.0, 1.0, 1.0), {})


# ------------------------------------------------------- on the card

@pytest.fixture
def hopper(gpu):
    """The first JAX device when it is a Hopper GPU; skips otherwise."""
    if not hs.is_hopper(gpu):
        pytest.skip(f"the kernel is built for sm_90; {gpu.device_kind} "
                    f"is compute capability {gpu.compute_capability}")
    return gpu


@pytest.mark.gpu
@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_jnp_on_gpu(hopper, kind, axes):
    rng = np.random.default_rng(0)
    shape = (40, 50, 70)
    mat = _materials(shape, rng)
    h = (1.0, 1.2, 0.9)
    dt = 0.8 * min(h) / mat.max_cp()
    u = jnp.asarray(rng.standard_normal((9,) + shape), jnp.float32)
    borders = _borders(kind)
    want = step(get_model("elastic3d"), u, mat, dt, h, 2, borders, axes)
    got = hs.hopper_step(u, mat, dt, h, borders, axes)
    assert _rel_err(got, want) <= TOL


@pytest.mark.gpu
def test_engine_auto_matches_jnp_on_gpu(hopper):
    """Free surface, source and detectors: 20 steps, both axis orders."""
    task = get_scenario("elastic3d_explosion", n=64, nsteps=20)
    auto = Engine(task)
    assert auto.kernel == "hopper"
    got = auto.run()
    want = Engine(dataclasses.replace(task, kernel="jnp")).run()
    assert got.kernel == "hopper" and want.kernel == "jnp"
    assert _rel_err(got.u, want.u) <= TOL
    assert _rel_err(got.traces, want.traces) <= TOL
