"""Per-node ODE correctors applied after the hyperbolic sweeps.

Counterpart of the reference's ODE correctors (SURVEY.md §2
component 12; §0.5): viscoelastic Maxwell relaxation and continual damage.
Each corrector is a pure elementwise update ``(u, aux, dt) -> (u, aux)``
carried inside the jitted scan — split-step (Godunov) coupling with the
hyperbolic part, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax.numpy as jnp

from gcm_tpu.models.spec import Model


def _diag_stress_indices(model: Model):
    names = model.comp_names
    return [i for i, n in enumerate(names)
            if n.startswith("s") and len(set(n[1:])) == 1]


def _shear_stress_indices(model: Model):
    names = model.comp_names
    return [i for i, n in enumerate(names)
            if n.startswith("s") and len(set(n[1:])) == 2]


@dataclasses.dataclass(frozen=True)
class MaxwellCorrector:
    """Maxwell viscoelasticity: deviatoric stress relaxes with time tau.

    d sigma_dev / dt = -sigma_dev / tau  (exact exponential integrator:
    sigma_dev *= exp(-dt/tau)); the isotropic (pressure) part is elastic.
    ``tau`` may be a scalar or a per-node array.
    """

    tau: Any
    name: str = "maxwell"

    def init_aux(self, model: Model, shape) -> Dict[str, jnp.ndarray]:
        return {}

    def __call__(self, model: Model, u: jnp.ndarray, aux: Dict, dt: float
                 ) -> Tuple[jnp.ndarray, Dict]:
        decay = jnp.exp(-dt / jnp.asarray(self.tau, dtype=u.dtype))
        diag = _diag_stress_indices(model)
        shear = _shear_stress_indices(model)
        if not diag:
            return u, aux
        mean = sum(u[i] for i in diag) / len(diag)
        for i in diag:
            u = u.at[i].set(mean + (u[i] - mean) * decay)
        for i in shear:
            u = u.at[i].set(u[i] * decay)
        return u, aux


@dataclasses.dataclass(frozen=True)
class DamageCorrector:
    """Continual damage: a per-node scalar d in [0, 1] grows where the
    maximum tensile normal stress exceeds a threshold, and degrades the
    stress the node can carry: the carried stress tracks ``(1 - d)``
    times the undamaged evolution, applied INCREMENTALLY per step
    (sigma *= (1-d_new)/(1-d_old)). Irreversible.

    The incremental form matters: multiplying the evolving stress by the
    full ``(1-d)`` every step would compound — a node frozen at d=0.5
    would lose half its stress per STEP, a dt-dependent decay that does
    not converge under time refinement (code-review r5).

    d_t = rate * max(0, max_diag_stress - threshold) / threshold
    """

    threshold: float
    rate: float
    name: str = "damage"

    def init_aux(self, model: Model, shape) -> Dict[str, jnp.ndarray]:
        return {"damage": jnp.zeros(shape, dtype=jnp.float32)}

    def __call__(self, model: Model, u: jnp.ndarray, aux: Dict, dt: float
                 ) -> Tuple[jnp.ndarray, Dict]:
        diag = _diag_stress_indices(model)
        shear = _shear_stress_indices(model)
        d = aux["damage"]
        smax = jnp.stack([u[i] for i in diag]).max(axis=0)
        over = jnp.maximum(smax - self.threshold, 0.0) / self.threshold
        d_new = jnp.clip(d + self.rate * over * dt, 0.0, 1.0)
        # incremental: cumulative scaling is (1 - d) vs the undamaged
        # stress; fully-damaged nodes (d==1) stay at zero stress
        factor = jnp.minimum(
            (1.0 - d_new) / jnp.maximum(1.0 - d, 1e-12), 1.0
        ).astype(u.dtype)
        for i in diag + shear:
            u = u.at[i].set(u[i] * factor)
        aux = dict(aux)
        aux["damage"] = d_new
        return u, aux
