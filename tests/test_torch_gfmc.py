"""Port parity: matrix elements between arbitrary determinants, the CI
wavefunction and fixed-node GFMC, on the JAX package's GFMC test system
(the 4-site Hubbard chain at U = 4, 2α/2β; ``tests/test_gfmc_ci.py``).

``hij_pairs``/``hij_dense`` against the JAX package and the oracle
(1e-12); ``CIWavefunction.energy`` against the dense eigenvalue (1e-10);
the deterministic Green row (``e_loc``, ``b``) against ``GFMC._iteration``
of the JAX package for the same walkers (f64, 1e-10); the branch indices
for the same u0 (equal); the transition's frequencies against g/Σg;
``mixed_energy`` (1e-12); the exact trial (e_gen ≡ E0 to 1e-8); a seeded
fixed-node run against the dense fixed-node oracle; the guards; and
``fe2s2_gfmc.main`` at a tiny size."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from pynqs_tpu.ci import CIWavefunction as JCI
from pynqs_tpu.gfmc.walker import GFMC as JGFMC
from pynqs_tpu.gfmc.walker import GFMCConfig as JGFMCConfig
from pynqs_tpu.gfmc.walker import ci_trial_log_psi as jci_trial
from pynqs_tpu.gfmc.walker import mixed_energy as jmixed_energy
from pynqs_tpu.ops.hamiltonian import hij_dense as jhij_dense
from pynqs_tpu.ops.hamiltonian import hij_pairs as jhij_pairs
from pynqs_tpu.ops.integrals import decompress_h2e
from pynqs_tpu.utils import System as JSystem

from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
from pynqs_tpu_torch.gfmc.walker import (GFMC, GFMCConfig, GreenRow, branch_indices,
                                         ci_trial_log_psi, mixed_energy)
from pynqs_tpu_torch.ops import hamiltonian
from pynqs_tpu_torch.ops.hamiltonian import hij_dense, hij_pairs
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.ops.onv import hf_bits
from pynqs_tpu_torch.scripts import fe2s2_gfmc
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.checkpoint import save_params
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


def test_mixed_energy_equals_jax():
    rng = np.random.default_rng(3)
    out = {"e_gen": -2.0 + 0.01 * rng.standard_normal(120),
           "wbar": 1.0 + 0.05 * rng.standard_normal(120)}
    for p, tail in ((0, None), (3, 50), (10, 200)):
        np.testing.assert_allclose(mixed_energy(out, p, tail=tail),
                                   jmixed_energy(out, p, tail=tail), atol=1e-12, rtol=0)


def test_exact_trial_gives_exact_energy():
    ts, _, space, w, v, _ = _systems()
    trial = ci_trial_log_psi(CIWavefunction(coeffs=v[:, 0], bits=space), device="cpu")
    g = GFMC(trial, ts, GFMCConfig(n_walkers=64, n_iter=10, p_steps=3, sync_interval=4),
             device="cpu")
    walkers = np.broadcast_to(hf_bits(ts.sorb, 2, 2), (64, ts.sorb))
    out = g.run(walkers, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out["e_gen"], w[0], atol=1e-8)
    for p in range(4):
        np.testing.assert_allclose(mixed_energy(out, p)[0], w[0], atol=1e-8)


def _dense_fixed_node(H, c):
    """The exact fixed-node (γ = 0) ground energy of a real trial c."""
    n = len(c)
    Ht = H * np.outer(1.0 / c, c)
    viol = (Ht > 0) & ~np.eye(n, dtype=bool)
    HFN = np.where(viol, 0.0, H)
    np.fill_diagonal(HFN, np.diag(H) + np.where(viol, Ht, 0.0).sum(1))
    return np.linalg.eigvalsh(HFN)[0]


def test_fixed_node_run_agrees_with_the_dense_oracle():
    """1024 walkers, 300 iterations (seeded): E(p = 10) within max(4 se,
    2 mHa) of the exact fixed-node energy, below E_var, above E0 (the
    bound of the JAX package's test)."""
    ts, _, space, w, v, H = _systems()
    c = _trial_coeffs(v)
    ci = CIWavefunction(coeffs=c, bits=space)
    e_var = ci.energy(ts.tables("cpu"))
    e0fn = _dense_fixed_node(H, c)
    assert w[0] - 1e-9 <= e0fn <= e_var + 1e-9 and e_var > w[0] + 1e-4
    g = GFMC(ci_trial_log_psi(ci, device="cpu"), ts,
             GFMCConfig(n_walkers=1024, n_iter=300, p_steps=10, branch_interval=10),
             device="cpu")
    idx = np.random.default_rng(0).choice(len(c), size=1024, p=c**2)
    out = g.run(space[idx], generator=torch.Generator().manual_seed(1))
    e_p, se = mixed_energy(out, 10, tail=200)
    assert abs(e_p - e0fn) < max(4 * se, 2e-3), (e_p, se, e0fn)
    assert e_p < e_var + 2 * se
    assert e_p > w[0] - max(4 * se, 2e-3)


def test_guards_raise_on_nan_and_on_non_positive_b():
    ts, _, space, _, v, _ = _systems()
    trial = ci_trial_log_psi(CIWavefunction(coeffs=_trial_coeffs(v), bits=space), device="cpu")

    def nan_trial(bits):
        lp = trial(bits)
        lp[::7, 0] = torch.nan
        return lp

    walkers = space[:32]
    g = GFMC(nan_trial, ts, GFMCConfig(n_walkers=32, n_iter=5), device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite"):
        g.run(walkers, generator=torch.Generator().manual_seed(0))
    g = GFMC(trial, ts, GFMCConfig(n_walkers=32, n_iter=5, tau_lambda=-50.0), device="cpu")
    with pytest.raises(FloatingPointError, match="min b"):
        g.run(walkers, generator=torch.Generator().manual_seed(0))


def test_gfmc_script_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The script on a 16-orbital stand-in (the DAG with tensor coupling,
    dcut 4): 32 walkers, 12 iterations, the trial and Green rows on the
    CPU, with and without the dedup."""
    rng = np.random.default_rng(5)
    sorb = 16
    h1e = rng.standard_normal((sorb, sorb)) * 0.1
    h1e = (h1e + h1e.T) / 2
    system = System.from_integrals(h1e, rng.standard_normal(triangle_size(sorb)) * 0.02,
                                   sorb, 2, 2, ecore=1.5)
    from pynqs_tpu_torch.utils.flagship import flagship_model

    m = flagship_model(system, 4, use_tensor=True, max_preds=2, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    save_params(str(tmp_path / "s.pkl"), dict(m.named_parameters()))
    argv = [str(tmp_path / "s.pkl"), "--dcut", "4", "--use-tensor", "--max-preds", "2",
            "--n-walkers", "32", "--n-iter", "12", "--p-steps", "2", "--n-sample", "5000",
            "--init-capacity", "64", "--tail", "6"]
    out = fe2s2_gfmc.main(argv, system=system, device="cpu")
    text = capsys.readouterr().out
    assert "ms/iter" in text and "e_gen[0]" in text and " p= 2 " in text
    assert out["e_gen"].shape == (12,) and np.isfinite(out["e_gen"]).all()
    assert len(out["mixed"]) == 3 and all(np.isfinite(e) for _, e, _ in out["mixed"])
    ded = fe2s2_gfmc.main(argv + ["--dedup-max", "100000"], system=system, device="cpu")
    assert ded["n_unique"].shape == (12,) and (ded["n_unique"] < 32 * 1000).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fe2s2_gfmc.main(argv, system=system)
