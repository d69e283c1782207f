"""Host-side spatial-orbital transformations (no pyscf required).

Counterpart of ``pynqs_tpu/utils/orbitals.py``: ``freeze_core`` (numpy,
a copy) folds doubly occupied orbitals into the core, and
``localize_er`` maximizes the Edmiston-Ruedenberg functional over
orthogonal U = expm(A - A^T) by gradient ascent with backtracking, its
gradient through ``torch.linalg.matrix_exp`` under autograd in f64 (the
JAX function differentiates ``jax.scipy.linalg.expm``), from the same
numpy start draw.  Both work on integrals from any source.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["freeze_core", "localize_er"]


def freeze_core(
    h1: np.ndarray, eri: np.ndarray, ecore: float, n_frozen: int
) -> tuple[np.ndarray, np.ndarray, float]:
    """Fold the ``n_frozen`` lowest spatial orbitals, doubly occupied,
    into the core.  h1 [n, n] spatial one-electron MO integrals; eri [n,
    n, n, n] chemist-notation (pq|rs).  Returns (h1_act, eri_act,
    ecore_act) over the other n - n_frozen orbitals:

        E_core = ecore + 2 Σ_i h_ii + Σ_ij [2 (ii|jj) − (ij|ji)]
        h'_pq  = h_pq + Σ_i [2 (pq|ii) − (pi|iq)]
    """
    nf = n_frozen
    if nf == 0:
        return h1, eri, ecore
    f = slice(0, nf)
    a = slice(nf, h1.shape[0])
    e = (
        float(ecore)
        + 2.0 * float(np.trace(h1[f, f]))
        + 2.0 * float(np.einsum("iijj->", eri[f, f, f, f]))
        - float(np.einsum("ijji->", eri[f, f, f, f]))
    )
    h1_act = (
        h1[a, a]
        + 2.0 * np.einsum("pqii->pq", eri[a, a, f, f])
        - np.einsum("piiq->pq", eri[a, f, f, a])
    )
    return h1_act, eri[a, a, a, a].copy(), e


def _self_repulsion(eri: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    t = torch.einsum("pqrs,si->pqri", eri, u)
    t = torch.einsum("pqri,ri->pqi", t, u)
    t = torch.einsum("pqi,qi->pi", t, u)
    return torch.einsum("pi,pi->i", t, u)


def localize_er(
    hcore: np.ndarray,
    eri: np.ndarray,
    n_iter: int = 400,
    lr: float = 0.1,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edmiston-Ruedenberg localization on spatial integrals: maximize
    L(U) = Σ_i (ii|ii) over orthogonal U = expm(A − Aᵀ) (A strictly lower
    triangular, started at 1e-3 × ``default_rng(seed)`` normals) by plain
    gradient ascent with backtracking (a step that does not improve
    halves the step, one that does grows it by 1.2 up to 1), then
    transform (hcore, eri).  hcore [n, n], eri [n, n, n, n] chemist
    (pq|rs).  Returns (hcore_loc, eri_loc, U), the columns of U the
    localized orbitals; energies from the pair are invariant."""
    n = hcore.shape[0]
    eri_t = torch.as_tensor(np.asarray(eri, np.float64))
    tri = np.tril_indices(n, -1)
    rows, cols = torch.as_tensor(tri[0]), torch.as_tensor(tri[1])

    def unitary(a_vec):
        A = torch.zeros(n, n, dtype=torch.float64).index_put((rows, cols), a_vec)
        return torch.linalg.matrix_exp(A - A.T)

    def loss(a):
        return -_self_repulsion(eri_t, unitary(a)).sum()

    def grad(a):
        a = a.detach().requires_grad_(True)
        return torch.autograd.grad(loss(a), a)[0]

    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal(tri[0].size) * 1e-3)
    step = lr
    with torch.no_grad():
        best = float(loss(a))
    for _ in range(n_iter):
        g = grad(a)
        cand = a - step * g
        with torch.no_grad():
            c = float(loss(cand))
        if c < best:
            a, best = cand, c
            step = min(step * 1.2, 1.0)
        else:
            step *= 0.5
            if step < 1e-8:
                break
    with torch.no_grad():
        U = unitary(a)
        eri_loc = torch.einsum("pqrs,pa,qb,rc,sd->abcd", eri_t, U, U, U, U)
    U = U.numpy()
    h_loc = U.T @ np.asarray(hcore, np.float64) @ U
    return h_loc, eri_loc.numpy(), U
