"""Selected-space CI: space enumeration, the Davidson solver and the
determinant-coefficient file.

Counterpart of ``pynqs_tpu/ci/solve.py``:

  * :func:`cisd_space` — HF and every single and double excitation, in
    the excitation table's row order (the UCISD determinant set);
  * :func:`solve_ci` — the ground state of H on a selected space from
    Slater–Condon blocks on the tables' device: dense ``eigh`` in f64 up
    to 1024 determinants, Davidson on the cached dense H up to
    ``cache_max``, Davidson with the blocks recomputed per matvec above;
  * :func:`davidson` — the numpy host iteration, a copy of the JAX
    package's (the same restart draw), so that the iterates are equal in
    f64; only the matvec runs on the device;
  * :func:`save_ci` / :func:`load_ci` — the ``.npz`` format of the JAX
    package (coeffs f64, bits int8, scalar metadata), read and written
    the same way by both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
from pynqs_tpu_torch.ops import onv
from pynqs_tpu_torch.ops.excitation import excitation_table, make_comb_bits
from pynqs_tpu_torch.ops.hamiltonian import hij_dense, hij_diagonal

__all__ = ["cisd_space", "solve_ci", "davidson", "save_ci", "load_ci", "DENSE_MAX"]

DENSE_MAX = 1024  # up to this many determinants a dense eigh beats Davidson


def cisd_space(sorb: int, noa: int, nob: int) -> np.ndarray:
    """[1 + n_sd, sorb] int8: HF, then every single and double excitation
    of it in the excitation table's order."""
    table = excitation_table(sorb, noa, nob)
    hf = torch.as_tensor(onv.hf_bits(sorb, noa, nob))[None, :]
    merged = onv.merged_orbital_list(hf, noa, nob)
    orbs = merged[:, torch.as_tensor(table.pos.astype(np.int64))]  # [1, n_sd, 4]
    is_double = torch.arange(table.n_sd) >= table.n_singles
    comb = make_comb_bits(hf, orbs, is_double)[0]
    return np.concatenate([hf.numpy().astype(np.int8), comb.numpy().astype(np.int8)], 0)


def davidson(
    matvec,
    diag: np.ndarray,
    dim: int,
    *,
    v0: np.ndarray | None = None,
    tol: float = 1e-9,
    max_iter: int = 200,
    max_subspace: int = 40,
):
    """Lowest eigenpair of a symmetric operator by Davidson iteration
    (diagonal preconditioner, thick restart).  ``matvec`` maps a numpy
    vector [dim] to a numpy vector; the iteration runs in numpy on the
    host."""
    rng = np.random.default_rng(0)
    if v0 is None:
        v0 = np.zeros(dim)
        v0[int(np.argmin(diag))] = 1.0
    V = v0[:, None] / np.linalg.norm(v0)
    AV = matvec(V[:, 0])[:, None]
    theta, y = np.inf, None
    for _ in range(max_iter):
        T = V.T @ AV
        T = 0.5 * (T + T.T)
        evals, evecs = np.linalg.eigh(T)
        theta_new, y = evals[0], evecs[:, 0]
        x = V @ y
        r = AV @ y - theta_new * x
        rnorm = np.linalg.norm(r)
        conv = abs(theta_new - theta) < tol and rnorm < max(tol * 100, 1e-6)
        theta = theta_new
        if conv or V.shape[1] >= dim:  # the whole space: T's eigh is exact
            return theta, x
        # diagonal preconditioner; near-zero denominators guarded
        denom = diag - theta
        denom = np.where(np.abs(denom) < 1e-8, 1e-8, denom)
        t = r / denom
        for _ in range(2):  # orthogonalize against V twice, for stability
            t -= V @ (V.T @ t)
        tn = np.linalg.norm(t)
        if tn < 1e-12:
            t = rng.standard_normal(dim)
            t -= V @ (V.T @ t)
            tn = np.linalg.norm(t)
        t /= tn
        if V.shape[1] >= max_subspace:  # thick restart from the Ritz vector
            V = x[:, None]
            AV = matvec(x)[:, None]
            V /= np.linalg.norm(V[:, 0])
        V = np.concatenate([V, t[:, None]], axis=1)
        AV = np.concatenate([AV, matvec(t)[:, None]], axis=1)
    return theta, V @ y


def _positive(c: np.ndarray) -> np.ndarray:
    """The sign convention: the largest |c| is positive."""
    return -c if c[np.argmax(np.abs(c))] < 0 else c


def solve_ci(
    space_bits: np.ndarray,
    tables,
    *,
    ecore: float = 0.0,
    chunk: int = 1024,
    cache_max: int = 8192,
    tol: float = 1e-9,
    max_iter: int = 200,
) -> tuple[float, CIWavefunction]:
    """Ground state of H restricted to ``space_bits`` [m, sorb].

    ``tables``: a ``DeviceTables`` or the tuple (h1e, h2e, diag1, K, J);
    the Slater–Condon elements are computed in their dtype on their
    device, then taken to f64.  For m <= ``DENSE_MAX`` the dense H goes to
    ``torch.linalg.eigh`` in f64 on the device; for m <= ``cache_max``
    Davidson multiplies the cached dense H on the device; above that
    every matvec recomputes the blocks of ``chunk`` rows (memory
    O(chunk·m)).  Returns (energy + ecore, CIWavefunction)."""
    ops = tables.astuple() if hasattr(tables, "astuple") else tuple(tables)
    K = ops[3]
    dev, f64 = K.device, torch.float64
    m = space_bits.shape[0]
    bits = torch.as_tensor(np.asarray(space_bits), device=dev).to(torch.int8)
    diag = hij_diagonal(bits, ops[2], K).to(f64).cpu().numpy()

    if m <= cache_max:
        H = hij_dense(bits, bits, *ops).to(f64)
        H = 0.5 * (H + H.T)  # symmetrize the Slater–Condon roundoff
        if m <= DENSE_MAX:
            w, v = torch.linalg.eigh(H)
            c = _positive(v[:, 0].cpu().numpy())
            return float(w[0]) + ecore, CIWavefunction(coeffs=c, bits=space_bits)

        def matvec(x):
            return (H @ torch.as_tensor(x, device=dev)).cpu().numpy()

    else:

        def matvec(x):
            xd = torch.as_tensor(x, device=dev)
            return torch.cat([hij_dense(bits[s:s + chunk], bits, *ops).to(f64) @ xd
                              for s in range(0, m, chunk)]).cpu().numpy()

    e, c = davidson(matvec, diag, m, tol=tol, max_iter=max_iter)
    return float(e + ecore), CIWavefunction(coeffs=_positive(c), bits=space_bits)


def save_ci(path: str, ci: CIWavefunction, **meta):
    """The determinant-coefficient ``.npz``: coeffs [m] f64, bits [m, sorb]
    int8, plus scalar metadata (e.g. e_var, eps1)."""
    np.savez_compressed(
        path,
        coeffs=np.asarray(ci.coeffs, np.float64),
        bits=np.asarray(ci.bits, np.int8),
        **meta,
    )


def load_ci(path: str) -> tuple[CIWavefunction, dict]:
    """Read a determinant-coefficient ``.npz`` -> (CIWavefunction, meta)."""
    with np.load(path) as z:
        ci = CIWavefunction(coeffs=z["coeffs"], bits=z["bits"])
        meta = {
            k: z[k][()] if z[k].ndim == 0 else z[k]
            for k in z.files
            if k not in ("coeffs", "bits")
        }
    return ci, meta
