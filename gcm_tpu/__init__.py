"""gcm_tpu — a JAX grid-characteristic method (GCM) framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++ framework ``AlexanderKazakov/gcm`` (see SURVEY.md; the reference mount was
empty this round, so the contract is SURVEY.md §0 + BASELINE.json configs,
anchored by the NumPy oracle in ``gcm_tpu.oracle``).

Layers (bottom → top), mirroring SURVEY.md §1:

- ``ops``       : interpolation stencils and the fused per-axis stage ops
                  (jnp reference path + the one-pass CUDA step kernel).
- ``models``    : rheology models (acoustic, elastic) — closed-form
                  characteristic decompositions as declarative specs.
- ``materials`` : isotropic/orthotropic material parameters, per-node fields.
- ``grids``     : structured (cubic) grid metadata and simplex (tri/tet)
                  grids with precomputed gather tables.
- ``solver``    : the grid-characteristic step (dimensional splitting),
                  boundary conditions, contact/fracture.
- ``parallel``  : device-mesh sharding, halo exchange, distributed step.
- ``engine``    : time loop, snapshots, detectors, checkpointing.
- ``task``      : typed scenario configuration (the reference's ``Task``).
- ``scenarios`` : the five BASELINE.json configs as named, runnable tasks.
"""

__version__ = "0.1.0"

from gcm_tpu.materials import IsotropicMaterial, OrthotropicMaterial  # noqa: F401
from gcm_tpu.task import (  # noqa: F401
    Task, GridSpec, BorderSpec, AreaBox, AreaBall, AreaLayer, TimeSpec,
)
