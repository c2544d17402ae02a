"""Small dense linear-algebra helpers: the PDE Jacobians A_a per model.

Counterpart of the reference's ``linal`` + ``GcmMatrices``
(SURVEY.md §2 components 1 and 3) — but here the full matrices exist ONLY
for verification and tooling: the solver uses the closed-form pair/zero
decomposition (gcm_tpu.models.spec), and these builders let tests check
that the closed form exactly diagonalizes the true Jacobians
(R^{-1} A R = Lambda), which is the reference's eigendecomposition parity.

Conventions as in models.spec: u_t + A_a u_a = 0, elastic tension-positive.
"""

from __future__ import annotations

import numpy as np

from gcm_tpu.materials import IsotropicMaterial
from gcm_tpu.models.spec import Model


def jacobian(model: Model, mat: IsotropicMaterial, axis: int) -> np.ndarray:
    """Dense A_axis for the isotropic model at one material point."""
    n = model.ncomp
    A = np.zeros((n, n))
    rho, lam, mu = mat.rho, mat.lam, mat.mu
    m2 = lam + 2.0 * mu
    c = model.comp
    dim = model.dim
    ax = "xyz"[axis]

    if model.sign > 0:  # elastic: rho v_t = div sigma; sigma_t = C : grad v
        vels = [f"v{a}" for a in "xyz"[:dim]] if dim > 1 else ["v"]
        # velocity rows: v_i_t = (1/rho) d sigma_{i,axis} / d axis
        for i, vn in enumerate(vels):
            a1, a2 = sorted((i, axis))
            sname = f"s{'xyz'[a1]}{'xyz'[a2]}" if dim > 1 else "sxx"
            A[c(vn), c(sname)] = -1.0 / rho
        # stress rows
        for i in range(dim):
            for j in range(i, dim):
                sname = f"s{'xyz'[i]}{'xyz'[j]}" if dim > 1 else "sxx"
                row = c(sname)
                # sigma_ij_t = lam delta_ij dv_k/dx_k|k=axis + mu(dv_i/dx_j + dv_j/dx_i)
                if i == j:
                    coeff = m2 if i == axis else lam
                    A[row, c(vels[axis])] = -coeff
                else:
                    if i == axis:
                        A[row, c(vels[j])] = -mu
                    elif j == axis:
                        A[row, c(vels[i])] = -mu
    else:  # acoustic: v_t = -(1/rho) grad p ; p_t = -rho c^2 div v
        vels = [f"v{a}" for a in "xyz"[:dim]] if dim > 1 else ["v"]
        A[c(vels[axis]), c("p")] = 1.0 / rho
        A[c("p"), c(vels[axis])] = rho * (m2 / rho)  # rho c^2 = lam (mu=0)
    return A


def invariant_matrix(model: Model, mat: IsotropicMaterial, axis: int):
    """Rows of R^{-1} (left eigenvectors) and eigenvalues, in closed form
    from the pair/zero spec — the object the reference calls GcmMatrices."""
    n = model.ncomp
    rows, lams = [], []
    st = model.stage(axis)
    s = model.sign
    zs = {"p": mat.rho * mat.cp, "s": mat.rho * mat.cs}
    cs = {"p": mat.cp, "s": mat.cs}
    kap = mat.lam / (mat.lam + 2 * mat.mu)
    for p in st.pairs:
        if cs[p.wave] == 0:
            continue
        # w_L = A + s z B  (lambda = -c);  w_R = A - s z B  (lambda = +c)
        for pm, lamv in ((+1, -cs[p.wave]), (-1, +cs[p.wave])):
            r = np.zeros(n)
            r[p.sigma] = 1.0
            r[p.vel] = pm * s * zs[p.wave]
            rows.append(r)
            lams.append(lamv)
    for zc in st.zeros:
        r = np.zeros(n)
        r[zc.comp] = 1.0
        r[zc.src] = -kap
        rows.append(r)
        lams.append(0.0)
    # untouched components are trivial zero-eigenvalue invariants
    touched = {p.sigma for p in st.pairs} | {p.vel for p in st.pairs} | \
              {zc.comp for zc in st.zeros}
    for i in range(n):
        if i not in touched:
            r = np.zeros(n)
            r[i] = 1.0
            rows.append(r)
            lams.append(0.0)
    return np.asarray(rows), np.asarray(lams)
