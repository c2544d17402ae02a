"""One-pass 3D step on NVIDIA Hopper: CUDA kernel through ``jax.ffi``.

The plain jnp step (gcm_tpu.solver.gcm.step) runs as three XLA sweeps, and
each sweep reads the previous sweep's output at neighbouring nodes, so XLA
cannot fuse them: every sweep reads and writes the whole state. The kernel
in ``cuda/gcm_step.cu`` does all three sweeps of a step in one pass over
device memory (9 state + 4 material floats in, 9 out per point).

Scope, all of it checked by :func:`eligible`: the 3D isotropic elastic
model, ``MaterialFields``, float32, order 2, axis orders (0,1,2) and
(2,1,0), characteristic borders of every kind, no device mesh, compute on a
Hopper GPU (compute capability 9.0, the one the library is built for).
Sources and correctors stay after the step in jnp, as on the jnp path.

The shared library is built from the committed source into ``build/`` at
the repository root (git-ignored) at first use, or ahead of time with::

    python -m gcm_tpu.ops.hopper_step
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Sequence, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                      "gcm_step.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build")
TARGET = "gcm_step_f32"

#: border kind -> kernel code (gcm_step.cu B_*)
BORDER_CODES = {"absorbing": 1, "free": 2, "fixed_force": 3,
                "fixed_velocity": 4}

_AXES_ORDERS = ((0, 1, 2), (2, 1, 0))


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def library_path() -> str:
    """Build output, keyed by the source's hash so an edited kernel is
    never served stale."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libgcm_step_{digest}.so")


def build_command(out: str) -> List[str]:
    """The nvcc command line that builds the FFI library at ``out``."""
    import jax.ffi

    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", jax.ffi.include_dir(), "-o", out,
            SOURCE]


def build(force: bool = False) -> str:
    """Compile the kernel library if needed; returns its path. A missing
    compiler or a failed build raises."""
    out = library_path()
    if os.path.exists(out) and not force:
        return out
    nvcc = nvcc_path()
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            f"the Hopper step kernel is built with nvcc, which is neither on "
            f"PATH nor at {nvcc}: install the CUDA toolkit, or run with "
            f"Task.kernel='jnp' (CLI: --kernel jnp)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {os.path.basename(SOURCE)} failed "
            f"(rc {proc.returncode}; Task.kernel='jnp' avoids the kernel):"
            f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    return out


_registered = False


def register() -> None:
    """Build (if needed), load and register the FFI target once."""
    global _registered
    if _registered:
        return
    import jax

    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.GcmStep),
                                platform="CUDA")
    _registered = True


def is_hopper(device) -> bool:
    """Whether ``device`` is a GPU the library's sm_90a code runs on
    (compute capability 9.0); any other GPU has no kernel image for it."""
    return (device.platform == "gpu"
            and getattr(device, "compute_capability", None) == "9.0")


def eligible(model, mat, order: int, dtype, borders, device,
             mesh=None, perm=None) -> bool:
    """Whether the kernel serves this step on ``device``: see the module
    docstring."""
    import jax.numpy as jnp

    from gcm_tpu.materials import MaterialFields

    return (is_hopper(device) and mesh is None and perm is None
            and model.name == "elastic3d" and order == 2
            and isinstance(mat, MaterialFields)
            and jnp.dtype(dtype) == jnp.float32
            and all(b.kind in BORDER_CODES for b in (borders or {}).values()))


def face_tables(borders, ndim: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Per-face kernel attributes: kind codes ``[6]`` (face = 2*axis+side,
    0 = no condition) and values ``[6, 3]`` per traction axis, resolved
    exactly as ``BorderSpec.pair_value`` does."""
    kinds = np.zeros(2 * ndim, np.int32)
    vals = np.zeros((2 * ndim, ndim), np.float32)
    for (axis, side), bc in (borders or {}).items():
        f = 2 * axis + side
        kinds[f] = BORDER_CODES[bc.kind]
        for t in range(ndim):
            vals[f, t] = bc.pair_value(t, axis)
    return kinds, vals


def step_attrs(dt: float, h: Sequence[float], borders,
               axes: Sequence[int]) -> Dict:
    """FFI attributes of one step."""
    axes = tuple(axes)
    if axes not in _AXES_ORDERS:
        raise ValueError(f"axes {axes} not in {_AXES_ORDERS}")
    kinds, vals = face_tables(borders)
    return {"dtoh": np.asarray([dt / ha for ha in h], np.float32),
            "kinds": kinds, "vals": vals.reshape(-1),
            "reverse": np.int32(axes == (2, 1, 0))}


def hopper_step(u, mat, dt: float, h: Sequence[float], borders,
                axes: Sequence[int] = (0, 1, 2)):
    """One full step ``u[9, nx, ny, nz] -> u`` through the kernel."""
    import jax

    from gcm_tpu.utils.backend import compute_device

    device = compute_device()
    if not is_hopper(device):
        raise RuntimeError(
            f"the Hopper step kernel runs only on a CUDA GPU of compute "
            f"capability 9.0, not on {device.platform!r} "
            f"({device.device_kind}); use Task.kernel='jnp' (or 'auto', "
            f"which picks the jnp sweeps there)")
    register()
    call = jax.ffi.ffi_call(TARGET, jax.ShapeDtypeStruct(u.shape, u.dtype))
    return call(u, mat.cp, mat.cs, mat.rho, mat.kappa,
                **step_attrs(dt, h, borders, axes))


if __name__ == "__main__":
    path = build(force=True)
    print(path)
    with open(path + ".log") as f:
        print(f.read())
