"""Rheology models: declarative closed-form characteristic decompositions.

Counterpart of the reference's ``ElasticModel`` / ``AcousticModel``
+ ``GcmMatrices`` (SURVEY.md §2 component 3). Where the reference builds
per-node (R, R^-1, Lambda) matrices and does small matvecs in the hot loop
(SURVEY.md §3.2), here the decomposition for isotropic media is expressed in
closed form as *pairs* of coupled (stress-like, velocity) components plus
*zero-speed invariants*, so the stage is pure elementwise VPU math + static
stencil shifts — no per-node matrices anywhere (SURVEY.md §7).
"""

from gcm_tpu.models.spec import (  # noqa: F401
    Model, PairSpec, StageSpec, ZeroSpec,
    acoustic_model, elastic_model, get_model,
    ACOUSTIC_1D, ACOUSTIC_2D, ACOUSTIC_3D, ELASTIC_1D, ELASTIC_2D, ELASTIC_3D,
)
