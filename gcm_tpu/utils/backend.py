"""Where will this computation run, and where does its compile cache live?

``jax.default_backend()`` answers "what is the process default platform",
which is the wrong question when a ``jax.sharding.Mesh`` is built over
devices of another platform, or when ``jax.default_device(...)`` scopes
work to a non-default platform. Kernel eligibility goes through
:func:`compute_device` so the choice tracks the devices the arrays will
really live on.
"""

from __future__ import annotations

import os

import jax

#: compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: one fixed path inside the checkout (git-ignored), so every process of
#: every run finds what an earlier one compiled
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compute_device(mesh=None):
    """The (first) device compute will execute on.

    With ``mesh`` given, that is a device of the mesh (authoritative:
    ``shard_map``/GSPMD place the computation there no matter what the
    process default is). Otherwise the active ``jax.default_device``
    override wins (a device, or a platform name), then the process default
    backend.
    """
    if mesh is not None:
        try:
            return next(iter(mesh.devices.flat))
        except (AttributeError, StopIteration, TypeError):
            pass
    dd = getattr(jax.config, "jax_default_device", None)
    if isinstance(dd, str):
        return jax.devices(dd)[0]
    if dd is not None:
        return dd
    return jax.devices()[0]


def compile_cache_dir() -> str:
    """The persistent compile-cache directory: ``JAX_COMPILATION_CACHE_DIR``
    when set, else :data:`CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def setup_compile_cache() -> str:
    """Enable JAX's persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and no
    other directory is configured here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
