"""Port parity: matrix elements between arbitrary determinants, the CI
wavefunction and fixed-node GFMC, on the JAX package's GFMC test system
(the 4-site Hubbard chain at U = 4, 2α/2β; ``tests/test_gfmc_ci.py``).

``hij_pairs``/``hij_dense`` against the JAX package and the oracle
(1e-12); ``CIWavefunction.energy`` against the dense eigenvalue (1e-10);
the deterministic Green row (``e_loc``, ``b``) against ``GFMC._iteration``
of the JAX package for the same walkers (f64, 1e-10); the branch indices
for the same u0 (equal); the transition's frequencies against g/Σg;
``mixed_energy``, the exact trial, a seeded fixed-node run and the guards
are in ``tests/test_torch_gfmc_run.py``, ``fe2s2_gfmc.main`` in
``tests/test_torch_gfmc_main.py`` (files of at most 5 cases, so that the
parallel test run can balance them)."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import oracle
from pynqs_tpu.ci import CIWavefunction as JCI
from pynqs_tpu.gfmc.walker import GFMC as JGFMC
from pynqs_tpu.gfmc.walker import GFMCConfig as JGFMCConfig
from pynqs_tpu.gfmc.walker import ci_trial_log_psi as jci_trial
from pynqs_tpu.ops.hamiltonian import hij_dense as jhij_dense
from pynqs_tpu.ops.hamiltonian import hij_pairs as jhij_pairs
from pynqs_tpu.ops.integrals import decompress_h2e
from pynqs_tpu.utils import System as JSystem

from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
from pynqs_tpu_torch.gfmc.walker import (GFMC, GFMCConfig, GreenRow, branch_indices, ci_trial_log_psi)
from pynqs_tpu_torch.ops import hamiltonian
from pynqs_tpu_torch.ops.hamiltonian import hij_dense, hij_pairs
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.system import System


def _systems():
    """(port System, JAX System, FCI space, eigenvalues, eigenvectors)."""
    js = JSystem.hubbard_1d(4, 2, 2, u=4.0)
    ts = System.hubbard_1d(4, 2, 2, u=4.0)
    dets = oracle.fci_space(js.sorb, 2, 2)
    H = oracle.dense_h(dets, js.h1e, decompress_h2e(js.h2e, js.sorb))
    w, v = np.linalg.eigh(H)
    return ts, js, fci.fci_bits(ts.sorb, 2, 2), w, v, H


def _trial_coeffs(v):
    c = v[:, 0] + 0.15 * v[:, 1] + 0.1 * v[:, 2]
    return c / np.linalg.norm(c)


def test_hij_pairs_and_dense_equal_jax_and_the_oracle(monkeypatch):
    ts, js, space, _, _, H = _systems()
    monkeypatch.setattr(hamiltonian, "DENSE_PAIRS", 50)  # blocks of one row
    ops = ts.tables("cpu").astuple()
    jops = tuple(jnp.asarray(np.asarray(x)) for x in js.tables.astuple())
    h = hij_dense(torch.as_tensor(space), torch.as_tensor(space), *ops)
    np.testing.assert_allclose(h.numpy(), H, atol=1e-12, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jhij_dense(jnp.asarray(space),
                                                                jnp.asarray(space), *jops)),
                               atol=1e-12, rtol=0)
    # elementwise pairs of random determinants (degrees 0 .. 4) on another system
    rng = np.random.default_rng(0)
    sorb = 12
    h1e = rng.standard_normal((sorb, sorb))
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(sorb)) * 0.3
    t2, j2 = (System.from_integrals(h1e, h2e, sorb, 3, 2),
              JSystem.from_integrals(h1e, h2e, sorb, 3, 2))
    sp = fci.fci_bits(sorb, 3, 2)
    a, b = sp[rng.integers(0, len(sp), 400)], sp[rng.integers(0, len(sp), 400)]
    b[:40] = a[:40]
    hp = hij_pairs(torch.as_tensor(a), torch.as_tensor(b), *t2.tables("cpu").astuple())
    jhp = jhij_pairs(jnp.asarray(a), jnp.asarray(b),
                     *(jnp.asarray(np.asarray(x)) for x in j2.tables.astuple()))
    np.testing.assert_allclose(hp.numpy(), np.asarray(jhp), atol=1e-12, rtol=0)
    h2d = decompress_h2e(h2e, sorb)
    ref = [oracle.apply_h(oracle.bits_to_det(k), h1e, h2d).get(oracle.bits_to_det(n), 0.0)
           for n, k in zip(a[:120], b[:120])]
    np.testing.assert_allclose(hp.numpy()[:120], ref, atol=1e-12, rtol=0)
    assert (hp.numpy()[40:] == 0).any() and (hp.numpy()[40:] != 0).any()


def test_ci_wavefunction_energy_select_and_hf():
    ts, js, space, w, v, _ = _systems()
    ci = CIWavefunction(coeffs=v[:, 0] * 3.0, bits=space)
    assert abs(ci.energy(ts.tables("cpu"), chunk=7) - w[0]) < 1e-10
    assert abs(ci.energy(ts.tables("cpu").astuple(), ecore=0.5) - w[0] - 0.5) < 1e-10
    jci = JCI(coeffs=v[:, 0], bits=space)
    s, js_ = ci.select(0.05), jci.select(0.05)
    np.testing.assert_array_equal(s.bits, js_.bits)
    np.testing.assert_allclose(s.coeffs, js_.coeffs, atol=1e-14, rtol=0)
    hf = CIWavefunction.hf_rooted(ts.sorb, 2, 2)
    np.testing.assert_array_equal(hf.bits, JCI.hf_rooted(ts.sorb, 2, 2).bits)
    assert hf.m == 1


def test_green_row_equals_jax_iteration():
    """e_loc and b of the same walkers (f64, 1e-10), for a trial whose
    signs are violated; with and without the forward dedup."""
    ts, js, space, _, v, _ = _systems()
    c = _trial_coeffs(v)
    rng = np.random.default_rng(1)
    walkers = space[rng.integers(0, len(space), 64)]
    for gamma, tau in ((0.0, None), (0.3, 20.0)):
        jg = JGFMC(jci_trial(JCI(coeffs=c, bits=space)), js,
                   JGFMCConfig(n_walkers=64, gamma=gamma, tau_lambda=tau))
        _, jw, je, jb, _ = jg._iteration(jnp.asarray(walkers), jnp.ones(64),
                                         jax.random.PRNGKey(0))
        g = GFMC(ci_trial_log_psi(CIWavefunction(coeffs=c, bits=space), device="cpu"), ts,
                 GFMCConfig(n_walkers=64, gamma=gamma, tau_lambda=tau), device="cpu")
        row = g.green_row(torch.as_tensor(walkers))
        np.testing.assert_allclose(row.e_loc.numpy(), np.asarray(je), atol=1e-10, rtol=0)
        np.testing.assert_allclose(row.b.numpy(), np.asarray(jb), atol=1e-10, rtol=0)
        assert (row.g_off >= 0).all() and (row.g_diag >= 0).all()
        assert ((row.g_off > 0).sum(-1) > 0).all()
        g.cfg.dedup_unique_max = len(space)
        ded = g.green_row(torch.as_tensor(walkers))
        assert ded.n_unique <= len(space) and row.n_unique is None
        assert torch.equal(ded.e_loc, row.e_loc) and torch.equal(ded.b, row.b)


def test_branch_indices_equal_jax():
    ts, js, space, _, v, _ = _systems()
    jg = JGFMC(jci_trial(JCI(coeffs=v[:, 0], bits=space)), js, JGFMCConfig(n_walkers=500))
    rng = np.random.default_rng(2)
    for seed in range(3):
        wts = rng.random(500) ** 3
        key = jax.random.PRNGKey(seed)
        jidx, jw, _ = jg._branch(jnp.arange(500), jnp.asarray(wts), key)
        u0 = float(jax.random.uniform(jax.random.split(key)[1], ()))
        idx = branch_indices(torch.as_tensor(wts), u0)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(np.asarray(jw), wts.sum() / 500, rtol=1e-14)


def test_transition_frequencies_follow_the_green_row():
    """20,000 draws over 6 moves of one row: every frequency within 5σ of
    g/Σg (σ² = p(1 − p)/n); zero-weight moves never drawn."""
    W, M = 20_000, 6
    g = torch.tensor([0.5, 0.0, 2.0, 0.25, 1.0, 0.0], dtype=torch.float64)
    comb = torch.arange(M, dtype=torch.int8)[None, :, None].expand(W, M, 1)
    row = GreenRow(comb, None, None, g[0].expand(W), g[1:].expand(W, M - 1), None)
    g_sys = GFMC(None, System.hubbard_1d(2, 1, 1), device="cpu")
    picks = g_sys.transition(row, torch.Generator().manual_seed(0))[:, 0].long()
    freq = torch.bincount(picks, minlength=M).double() / W
    p = g / g.sum()
    sigma = torch.sqrt(p * (1 - p) / W)
    assert (freq[p == 0] == 0).all()
    assert ((freq - p).abs() <= 5 * sigma + 1e-12).all(), (freq, p)
