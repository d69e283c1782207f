"""Port parity, fixed-node GFMC runs (the system and trial of
``tests/test_torch_gfmc.py``): ``mixed_energy`` against the JAX package
(1e-12), the exact trial (e_gen = E0 to 1e-8), a seeded fixed-node run
against the dense fixed-node oracle, and the guards."""

import numpy as np
import pytest
import torch

from pynqs_tpu.gfmc.walker import mixed_energy as jmixed_energy

from pynqs_tpu_torch.ci.wavefunction import CIWavefunction
from pynqs_tpu_torch.gfmc.walker import GFMC, GFMCConfig, ci_trial_log_psi, mixed_energy
from pynqs_tpu_torch.ops.onv import hf_bits

from test_torch_gfmc import _systems, _trial_coeffs


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
